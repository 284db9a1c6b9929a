"""Kernel 6: the eq. (20) client step over one parameter leaf of any shape,
one CUDA pass (``csrc/fused_update.cu``); the port of
``src/repro/kernels/fused_update.py::fused_update_pallas``.

    x' = x - step * (g + rho * (x - xs) + lam)

It is the step of every per-leaf (pytree) round and of Inexact FedSplit.
Unlike the reference, which sends per-client steps to plain XLA
(``ops.py:276``), the kernel takes the per-client step as an operand, and
it may take the server leaf without the client dim and broadcast it.

The module also keeps the arena lane width shared by the port
(``LANES``, ``ceil_to``).  The TPU sizing constants of the reference
(``BLOCK_ROWS``, ``VMEM_CAP_BYTES``, ``assert_vmem_budget``) do not carry
over: each Hopper kernel sizes itself.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, F, I, P, Kernel

# every arena leaf is padded to a multiple of LANES (core.arena); the port
# keeps the reference's slice table element for element
LANES = 128

KERNEL = Kernel(
    "fused_update", "fused_update.cu", "launch_fused_update",
    # x g xs lam step_arr step rho n xs_n m dtype out dev stream
    [P, P, P, P, P, F, F, LL, LL, LL, I, P, I, P],
    replaces="src/repro/kernels/fused_update.py:71",
)


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fused_update(x, g, xs, lam, step, rho):
    """x, g, lam: one leaf (leading client dim m); ``xs`` of x's shape or
    x's shape without the client dim; ``lam`` may be None; ``step`` a
    Python float or a per-client f32 tensor, ``(m,)`` or ``(m, 1, ...)``.
    CUDA operands are f32 or bf16, all of x's dtype, contiguous."""
    name = KERNEL.name
    if _args.on_cpu(name, x):
        return ref.fused_update_ref(x, g, xs, lam, step, rho)
    shape, dev, dt = tuple(x.shape), x.device, x.dtype
    if dt not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} is not supported (f32 or bf16)")
    for arg, t in (("x", x), ("g", g)) + ((("lam", lam),) if lam is not None else ()):
        _args.check(name, arg, t, shape, (dt,), dev)
    xs_shape = shape if tuple(xs.shape) == shape else shape[1:]
    _args.check(name, "xs", xs, xs_shape, (dt,), dev)
    m = shape[0] if shape else 1
    if torch.is_tensor(step) and step.ndim > 0:
        if tuple(step.shape) != (m,) + (1,) * (step.ndim - 1):
            raise ValueError(f"{name}: step has shape {tuple(step.shape)}, expected "
                             f"({m},) or ({m}, 1, ...)")
        step = step.reshape(m)
    step_arr, step_f = _args.step_operand(name, step, m, dev)
    out = torch.empty_like(x)
    KERNEL.launch(_args.ptr(x), _args.ptr(g), _args.ptr(xs), _args.ptr(lam),
                  _args.ptr(step_arr), step_f, float(rho), math.prod(shape),
                  math.prod(xs_shape), m, _args.DTYPE_CODES[dt], _args.ptr(out),
                  *_args.stream_args(dev))
    return out
