"""Kernel 13: the fixed-point residual norms of early termination, one CUDA
reduction (``csrc/residual.cu``); the port of
``src/repro/kernels/residual.py``:

  * ``residual_norm``  per row of the (m, W) state x and its previous
                       round's snapshot: ||x - x_prev||^2 and ||x||^2, f32

``core.autotune.state_residual`` sums the two over the rows of every 2-D
state buffer; ``EarlyExit`` stops a run once sqrt(dx2 / x2) stays below
``tol``.  CUDA operands are f32 or bf16 (both of one dtype), any width.
Rows are split into chunks as ``screen.chunking`` splits them, and the
chunks' partial sums are added in a fixed order, so a result does not vary
from run to run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, I, P, Kernel
from repro_torch.kernels.screen import chunking

RESIDUAL_NORM = Kernel(
    "residual_norm", "residual.cu", "launch_residual_norm",
    # x x_prev m W dtype chunks chunk dx2_part x2_part dx2 x2 dev stream
    [P, P, LL, LL, I, LL, LL, P, P, P, P, I, P],
    replaces="src/repro/kernels/residual.py:56",
)


def residual_norm(x, x_prev):
    """(dx2 (m,) f32, x2 (m,) f32): per row ||x - x_prev||^2 and ||x||^2 of
    the (m, W) tensors ``x`` and ``x_prev``."""
    k = RESIDUAL_NORM
    if _args.on_cpu(k.name, x):
        return ref.residual_norm_ref(x, x_prev)
    if x.ndim != 2:
        raise ValueError(f"{k.name}: x must be (m, W), got {tuple(x.shape)}")
    m, w = x.shape
    if x.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{k.name}: dtype {x.dtype} is not supported (f32 or bf16)")
    _args.check(k.name, "x", x, (m, w), (x.dtype,), x.device)
    _args.check(k.name, "x_prev", x_prev, (m, w), (x.dtype,), x.device)
    chunks, chunk = chunking(m, w, x.element_size())
    dev = x.device
    dx2 = torch.empty(m, dtype=torch.float32, device=dev)
    x2 = torch.empty(m, dtype=torch.float32, device=dev)
    dx2_part = x2_part = None
    if chunks > 1:
        dx2_part = torch.empty(m * chunks, dtype=torch.float32, device=dev)
        x2_part = torch.empty(m * chunks, dtype=torch.float32, device=dev)
    k.launch(_args.ptr(x), _args.ptr(x_prev), m, w, _args.DTYPE_CODES[x.dtype], chunks, chunk,
             _args.ptr(dx2_part), _args.ptr(x2_part), _args.ptr(dx2), _args.ptr(x2),
             *_args.stream_args(dev))
    return dx2, x2
