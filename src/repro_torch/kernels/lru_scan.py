"""The RG-LRU's linear recurrence h_t = a_t h_{t-1} + b_t, one CUDA kernel
per call (``csrc/lru_scan.cu``), a kernel of the port's own: the reference
runs it as plain JAX (``src/repro/kernels/ops.py:683`` ``lru_scan``), not as
a Pallas kernel.

  * ``lru_scan``  a, b (B, S, D) f32, h0 (B, D) f32 -> y (B, S, D) f32 (the
                  states h_1 .. h_S), h_last (B, D) f32

Every ``rec`` block of ``models.rglru.rglru_apply`` calls it once on
prefill (26 a recurrentgemma-9b prefill); decode takes one step in plain
tensor code.  On the card each step is one rounded product and one rounded
sum in order, so y equals the plain sequential version (``ref.lru_ref``)
bit for bit; the reference's chunked associative scan sums in another
order.  The kernel has no backward: under autograd on the card
``ops.lru_scan`` raises (training the RG-LRU waits, ROADMAP.md item 8.1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import I, P, Kernel

LRU_SCAN = Kernel(
    "lru_scan", "lru_scan.cu", "launch_lru_scan",
    # a b h0 y h_last B S D dev stream
    [P, P, P, P, P, I, I, I, I, P],
    replaces="src/repro/kernels/ops.py:683 (plain JAX in the reference, not Pallas)",
)


def lru_scan(a, b, h0):
    """(y, h_last) of the recurrence over a, b (B, S, D) from h0 (B, D)
    (see the module doc).  On the CPU the plain version, in a's dtype as
    the reference returns it; on the card f32 operands only."""
    kern = LRU_SCAN
    if _args.on_cpu(kern.name, a):
        return ref.lru_ref(a, b, h0)
    if a.ndim != 3:
        raise ValueError(f"{kern.name}: a must be (B, S, D), got {tuple(a.shape)}")
    B, S, D = a.shape
    dev, f32 = a.device, torch.float32
    _args.check(kern.name, "a", a, (B, S, D), (f32,), dev)
    _args.check(kern.name, "b", b, (B, S, D), (f32,), dev)
    _args.check(kern.name, "h0", h0, (B, D), (f32,), dev)
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    kern.launch(_args.ptr(a), _args.ptr(b), _args.ptr(h0), _args.ptr(y), _args.ptr(h_last), B, S,
                D, *_args.stream_args(dev))
    return y, h_last
