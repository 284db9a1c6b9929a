"""The whole K-step eq. (20) inner loop for affine gradient oracles as one
CUDA kernel (``csrc/inner_loop.cu``); the port of
``src/repro/kernels/inner_loop.py::inner_loop_affine_pallas``.

For g_i(x) = H_i x - (c_i + off_i) the kernel runs all K steps

    x <- x - step_i (g + rho (x - x_s) + lam_i)

with one thread block per client and returns (x_K, mean_k x_k).  The block
keeps the client's rows in shared memory (``SMEM_ROWS`` rows of W f32) and
streams H from device memory on every step: one client's W x W block
(1 MiB at W = 512) does not fit the 227 KB a block may use, so this first
version reads the H stack K times.  ``fits`` is this kernel's own width
rule -- the rows must fit shared memory -- and replaces the TPU's 8 MiB
VMEM gate (``inner_loop.fits_vmem``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import F, I, P, Kernel
from repro_torch.kernels.fused_update import LANES

SMEM_ROWS = 6  # x, x sum, c + off, x_s, lam, g
SMEM_CAP_BYTES = 232_448  # the most dynamic shared memory one block may use

KERNEL = Kernel(
    "inner_loop_affine", "inner_loop.cu", "launch_inner_loop_affine",
    # x0 H c xs lam off step_arr step rho inv_k K m W x_out xbar_out dev stream
    [P, P, P, P, P, P, P, F, F, F, I, I, I, P, P, I, P],
    replaces="src/repro/kernels/inner_loop.py:100",
)


def smem_bytes(width: int) -> int:
    return 4 * SMEM_ROWS * width


def fits(width: int) -> bool:
    """Can the kernel take arena width ``width``?"""
    return width % LANES == 0 and smem_bytes(width) <= SMEM_CAP_BYTES


def inner_loop_affine(x0, H, c, x_s, lam, step, rho, K: int, *, off=None):
    """x0, c, lam, off: (m, W); H: (m, W, W); x_s: (W,); ``lam``/``off``
    may be None; ``step`` a Python float or an (m,) f32 tensor.  Returns
    (x_K, x_bar).  CUDA operands must all be f32."""
    name = KERNEL.name
    if _args.on_cpu(name, x0):
        return ref.inner_loop_affine_ref(x0, H, c, x_s, lam, step, rho, K, off=off)
    m, w = x0.shape
    if not fits(w):
        raise ValueError(f"{name}: width {w} is not a multiple of {LANES} or "
                         f"its {smem_bytes(w)} B of rows exceed {SMEM_CAP_BYTES} B "
                         f"of shared memory")
    dev, f32 = x0.device, (torch.float32,)
    _args.check(name, "x0", x0, (m, w), f32, dev)
    _args.check(name, "H", H, (m, w, w), f32, dev)
    _args.check(name, "c", c, (m, w), f32, dev)
    _args.check(name, "x_s", x_s, (w,), f32, dev)
    if lam is not None:
        _args.check(name, "lam", lam, (m, w), f32, dev)
    if off is not None:
        _args.check(name, "off", off, (m, w), f32, dev)
    step_arr, step_f = _args.step_operand(name, step, m, dev)
    x_K = torch.empty_like(x0)
    x_bar = torch.empty_like(x0)
    KERNEL.launch(
        _args.ptr(x0), _args.ptr(H), _args.ptr(c), _args.ptr(x_s), _args.ptr(lam),
        _args.ptr(off), _args.ptr(step_arr), step_f, float(rho), 1.0 / K, int(K),
        m, w, _args.ptr(x_K), _args.ptr(x_bar), *_args.stream_args(dev))
    return x_K, x_bar
