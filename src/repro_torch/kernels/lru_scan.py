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

  * ``lru_scan_jvp``      a, y (B, S, D), h0 (B, D) and the tangents a',
                          b' (B, S, D), h0' (B, D), all f32 -> (y', h_last'):
                          y'_t = (h'_{t-1} a_t + a'_t h_{t-1}) + b'_t
  * ``lru_scan_bwd_jvp``  ``lru_scan_bwd``'s operands and their tangents ->
                          (da', db', dh0'), the reverse walk carrying g and
                          g' together

Every ``rec`` block of ``models.rglru.rglru_apply`` calls ``lru_scan`` once
on prefill (26 a recurrentgemma-9b prefill) and once a client gradient in
training, where ``lru_scan_bwd`` runs once (``kernels.ops.LruScan``, an
``autograd.Function`` with a vmap rule); decode takes one step in plain
tensor code.  On the card each step is one rounded product and one rounded
sum in order, so y equals the plain sequential version (``ref.lru_ref``)
and (da, db, dh0) autograd of it bit for bit; the reference's chunked
associative scan sums in another order.  The two tangent kernels are the
forward-mode rules of ``ops.LruScan`` and ``ops.LruScanBackward`` (the
curvature probe of ``--eta auto``); they round in the order of torch's
forward-mode formulas, so they equal ``torch.func.jvp`` of ``ref.lru_ref``
and ``ref.lru_bwd_ref`` bit for bit (their plain versions
``ref.lru_jvp_ref``, ``ref.lru_bwd_jvp_ref``).
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

LRU_SCAN_JVP = Kernel(
    "lru_scan_jvp", "lru_scan.cu", "launch_lru_scan_jvp",
    # a y h0 at bt h0t yt h_last_t B S D dev stream
    [P, P, P, P, P, P, P, P, I, I, I, I, P],
    replaces="none: jax.jvp of src/repro/kernels/ops.py:683 (the reference's curvature "
             "probe, src/repro/core/autotune.py:140-159)",
)

LRU_SCAN_BWD_JVP = Kernel(
    "lru_scan_bwd_jvp", "lru_scan.cu", "launch_lru_scan_bwd_jvp",
    # a y h0 dy dh_last at yt h0t dyt dh_last_t da_t db_t dh0_t B S D dev stream
    [P] * 13 + [I, I, I, I, P],
    replaces="none: jax.jvp of jax.grad of src/repro/kernels/ops.py:683 (the reference's "
             "curvature probe, src/repro/core/autotune.py:140-159)",
)


def _check_f32(name: str, a, named) -> tuple:
    """(B, S, D) of ``a`` once every (name, tensor) of ``named`` is an f32
    contiguous tensor on a's device: 3-D ones (B, S, D), 2-D ones (B, D)."""
    if a.ndim != 3:
        raise ValueError(f"{name}: a must be (B, S, D), got {tuple(a.shape)}")
    B, S, D = a.shape
    for arg, t in named:
        _args.check(name, arg, t, (B, S, D) if t.ndim == 3 else (B, D), (torch.float32,),
                    a.device)
    return B, S, D


def lru_scan(a, b, h0):
    """(y, h_last) of the recurrence over a, b (B, S, D) from h0 (B, D)
    (see the module doc).  On the CPU the plain version, in a's dtype as
    the reference returns it; on the card f32 operands only."""
    kern = LRU_SCAN
    if _args.on_cpu(kern.name, a):
        return ref.lru_ref(a, b, h0)
    B, S, D = _check_f32(kern.name, a, (("a", a), ("b", b), ("h0", h0)))
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    kern.launch(_args.ptr(a), _args.ptr(b), _args.ptr(h0), _args.ptr(y), _args.ptr(h_last), B, S,
                D, *_args.stream_args(a.device))
    return y, h_last


def lru_scan_bwd(a, y, h0, dy, dh_last):
    """(da, db, dh0) of ``lru_scan`` at (a, h0) whose states were ``y``, for
    the incoming gradients ``dy`` and ``dh_last`` (see the module doc).  On
    the CPU the plain version (``ref.lru_bwd_ref``); on the card f32
    operands only."""
    kern = LRU_SCAN_BWD
    if _args.on_cpu(kern.name, a):
        return ref.lru_bwd_ref(a, y, h0, dy, dh_last)
    B, S, D = _check_f32(kern.name, a, (("a", a), ("y", y), ("dy", dy), ("h0", h0),
                                        ("dh_last", dh_last)))
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    kern.launch(_args.ptr(a), _args.ptr(y), _args.ptr(h0), _args.ptr(dy), _args.ptr(dh_last),
                _args.ptr(da), _args.ptr(db), _args.ptr(dh0), B, S, D,
                *_args.stream_args(a.device))
    return da, db, dh0


def lru_scan_jvp(a, y, h0, at, bt, h0t):
    """(y', h_last'): the tangent of ``lru_scan`` at (a, b, h0), whose states
    were ``y``, along (a', b', h0') (see the module doc).  On the CPU the
    plain version (``ref.lru_jvp_ref``); on the card f32 operands only."""
    kern = LRU_SCAN_JVP
    if _args.on_cpu(kern.name, a):
        return ref.lru_jvp_ref(a, y, h0, at, bt, h0t)
    B, S, D = _check_f32(kern.name, a, (("a", a), ("y", y), ("at", at), ("bt", bt),
                                        ("h0", h0), ("h0t", h0t)))
    yt, h_last_t = torch.empty_like(a), torch.empty_like(h0)
    kern.launch(_args.ptr(a), _args.ptr(y), _args.ptr(h0), _args.ptr(at), _args.ptr(bt),
                _args.ptr(h0t), _args.ptr(yt), _args.ptr(h_last_t), B, S, D,
                *_args.stream_args(a.device))
    return yt, h_last_t


def lru_scan_bwd_jvp(a, y, h0, dy, dh_last, at, yt, h0t, dyt, dh_last_t):
    """(da', db', dh0'): the tangent of ``lru_scan_bwd`` at (a, y, h0, dy,
    dh_last) along (a', y', h0', dy', dh_last') (see the module doc).  On
    the CPU the plain version (``ref.lru_bwd_jvp_ref``); on the card f32
    operands only."""
    kern = LRU_SCAN_BWD_JVP
    if _args.on_cpu(kern.name, a):
        return ref.lru_bwd_jvp_ref(a, y, h0, dy, dh_last, at, yt, h0t, dyt, dh_last_t)
    B, S, D = _check_f32(kern.name, a, (
        ("a", a), ("y", y), ("dy", dy), ("at", at), ("yt", yt), ("dyt", dyt), ("h0", h0),
        ("dh_last", dh_last), ("h0t", h0t), ("dh_last_t", dh_last_t)))
    da_t, db_t, dh0_t = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    kern.launch(*(_args.ptr(t) for t in (a, y, h0, dy, dh_last, at, yt, h0t, dyt, dh_last_t,
                                         da_t, db_t, dh0_t)), B, S, D,
                *_args.stream_args(a.device))
    return da_t, db_t, dh0_t
