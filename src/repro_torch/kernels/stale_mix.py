"""Kernel 12: the bounded-staleness admission mix, one CUDA pass
(``csrc/stale_mix.cu``); the port of ``src/repro/kernels/stale_mix.py``:

  * ``stale_mix``  base = fresh ? uplink : cache; mixed = base + w (buf -
                   base) where w > 0, else base bitwise; buf' = store ?
                   uplink : buf

``core.staleness.step_arena`` computes the per-client ``fresh``, ``store``
and ``w`` and calls it once per async arena round.  CUDA operands: uplink
and buf (m, W), cache (m, W) or SCAFFOLD's (W,) server row, all f32 or all
bf16, any width; fresh and store (m,) bool, w (m,) f32.  Bitwise its plain
version in both dtypes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, I, P, Kernel

STALE_MIX = Kernel(
    "stale_mix", "stale_mix.cu", "launch_stale_mix",
    # u cache cache_per_row buf fresh store w m W dtype mixed buf_out dev stream
    [P, P, I, P, P, P, P, LL, LL, I, P, P, I, P],
    replaces="src/repro/kernels/stale_mix.py:58",
)


def stale_mix(uplink, cache, buf, fresh, store, w):
    """Returns (mixed (m, W), buf_new (m, W)); the inputs are not written."""
    k = STALE_MIX
    if _args.on_cpu(k.name, uplink):
        return ref.stale_mix_ref(uplink, cache, buf, fresh, store, w)
    if uplink.ndim != 2:
        raise ValueError(f"{k.name}: uplink must be (m, W), got {tuple(uplink.shape)}")
    m, width = uplink.shape
    dt, dev = uplink.dtype, uplink.device
    if dt not in _args.DTYPE_CODES:
        raise TypeError(f"{k.name}: dtype {dt} is not supported (f32 or bf16)")
    per_row = cache.ndim == 2
    for arg, t, shape in (("uplink", uplink, (m, width)), ("buf", buf, (m, width)),
                          ("cache", cache, (m, width) if per_row else (width,))):
        _args.check(k.name, arg, t, shape, (dt,), dev)
    for arg, t in (("fresh", fresh), ("store", store)):
        _args.check(k.name, arg, t, (m,), (torch.bool,), dev)
    _args.check(k.name, "w", w, (m,), (torch.float32,), dev)
    mixed, buf_new = torch.empty_like(uplink), torch.empty_like(buf)
    k.launch(_args.ptr(uplink), _args.ptr(cache), int(per_row), _args.ptr(buf),
             _args.ptr(fresh), _args.ptr(store), _args.ptr(w), m, width, _args.DTYPE_CODES[dt],
             _args.ptr(mixed), _args.ptr(buf_new), *_args.stream_args(dev))
    return mixed, buf_new
