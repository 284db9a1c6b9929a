"""The RG-LRU's linear recurrence h_t = a_t h_{t-1} + b_t and its backward,
one CUDA kernel per call each (``csrc/lru_scan.cu``), kernels of the port's
own: the reference runs the recurrence as plain JAX
(``src/repro/kernels/ops.py:683`` ``lru_scan``) and differentiates it with
``jax.grad``, not as a Pallas kernel.

  * ``lru_scan``      a, b (B, S, D) f32, h0 (B, D) f32 -> y (B, S, D) f32
                      (the states h_1 .. h_S), h_last (B, D) f32
  * ``lru_scan_bwd``  a, y (B, S, D), h0 (B, D), dy (B, S, D), dh_last (B,
                      D), all f32 -> (da, db, dh0): g_t = dy_t + a_{t+1}
                      g_{t+1} from g_{S-1} = dy_{S-1} + dh_last, da_t = g_t
                      h_{t-1} (h_{-1} = h0), db_t = g_t, dh0 = a_0 g_0

Every ``rec`` block of ``models.rglru.rglru_apply`` calls ``lru_scan`` once
on prefill (26 a recurrentgemma-9b prefill) and once a client gradient in
training, where ``lru_scan_bwd`` runs once (``kernels.ops.LruScan``, an
``autograd.Function`` with a vmap rule); decode takes one step in plain
tensor code.  On the card each step is one rounded product and one rounded
sum in order, so y equals the plain sequential version (``ref.lru_ref``)
and (da, db, dh0) autograd of it bit for bit; the reference's chunked
associative scan sums in another order.
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

LRU_SCAN_BWD = Kernel(
    "lru_scan_bwd", "lru_scan.cu", "launch_lru_scan_bwd",
    # a y h0 dy dh_last da db dh0 B S D dev stream
    [P, P, P, P, P, P, P, P, I, I, I, I, P],
    replaces="src/repro/kernels/ops.py:683 (its gradient: jax.grad of the plain JAX scan)",
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


def lru_scan_bwd(a, y, h0, dy, dh_last):
    """(da, db, dh0) of ``lru_scan`` at (a, h0) whose states were ``y``, for
    the incoming gradients ``dy`` and ``dh_last`` (see the module doc).  On
    the CPU the plain version (``ref.lru_bwd_ref``); on the card f32
    operands only."""
    kern = LRU_SCAN_BWD
    if _args.on_cpu(kern.name, a):
        return ref.lru_bwd_ref(a, y, h0, dy, dh_last)
    if a.ndim != 3:
        raise ValueError(f"{kern.name}: a must be (B, S, D), got {tuple(a.shape)}")
    B, S, D = a.shape
    dev, f32 = a.device, torch.float32
    for name, t, shape in (("a", a, (B, S, D)), ("y", y, (B, S, D)), ("dy", dy, (B, S, D)),
                           ("h0", h0, (B, D)), ("dh_last", dh_last, (B, D))):
        _args.check(kern.name, name, t, shape, (f32,), dev)
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    kern.launch(_args.ptr(a), _args.ptr(y), _args.ptr(h0), _args.ptr(dy), _args.ptr(dh_last),
                _args.ptr(da), _args.ptr(db), _args.ptr(dh0), B, S, D, *_args.stream_args(dev))
    return da, db, dh0
