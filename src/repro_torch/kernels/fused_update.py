"""The arena lane width and the eq. (20) arithmetic shared by the plain
versions (the port's copy of ``src/repro/kernels/fused_update.py:24-53``).

The TPU sizing constants of the reference (``BLOCK_ROWS``,
``VMEM_CAP_BYTES``, ``assert_vmem_budget``) do not carry over: each Hopper
kernel sizes itself (see ``inner_loop.fits``).
"""
from __future__ import annotations

# every arena leaf is padded to a multiple of LANES (core.arena); the port
# keeps the reference's slice table element for element
LANES = 128


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def eq20(x, g, xs, lam, step, rho: float):
    """x - step * (g + rho * (x - xs) + lam) on f32 tensors, in the
    reference's operation order; ``lam=None`` drops the dual term.
    ``step`` is a Python float or a tensor broadcastable against ``x``."""
    acc = g + rho * (x - xs)
    if lam is not None:
        acc = acc + lam
    return x - step * acc
