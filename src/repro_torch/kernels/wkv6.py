"""Kernel 17: the RWKV-6 recurrence with a data-dependent decay, in chunks of
64 steps, one CUDA kernel (``csrc/wkv6.cu``: every chunk at once, the
state passed from chunk to chunk in order); the port of
``src/repro/kernels/wkv6.py``:

  * ``wkv6``  r, k, w (B, S, H, K); v (B, S, H, V); u (H, K); s0 (B, H, K,
              V) -> y (B, S, H, V) in r's dtype, final state (B, H, K, V) f32

Every RWKV block of ``models.rwkv6.rwkv_time_mix`` calls it once on
prefill; decode takes one step in plain tensor code (``ops.wkv6_step``).
CUDA operands: r, k and v all f32 or all bf16, w, u and s0 f32, all
contiguous; K, V <= 64; any S (the last chunk may be shorter; the
reference asserts S % min(64, S) == 0 and so takes a subset of these); w a
decay in (0, 1], as the model's exp(-exp(.)) is (the kernel factors the
pairwise decays of a chunk through its 16-step sub-chunks, which is the
clamped sum only where la falls along the chunk).  The wrapper allocates
the kernel's scratch: the states passed between chunks (B H ceil(S / 64) K
V floats) and a zeroed int32 buffer of their flags and the chunk ticket.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import I, P, Kernel

CHUNK = 64
MAX_DIM = 64

WKV6 = Kernel(
    "wkv6", "wkv6.cu", "launch_wkv6",
    # r k v w u s0 y s_out states sync B S H K V dtype dev stream
    [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/wkv6.py:73",
)


def wkv6(r, k, v, w, u, s0):
    """(y, s_final) of the recurrence (see the module doc)."""
    kern = WKV6
    if _args.on_cpu(kern.name, r):
        return ref.wkv6_ref(r, k, v, w, u, s0, chunk=CHUNK)
    if r.ndim != 4:
        raise ValueError(f"{kern.name}: r must be (B, S, H, K), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    if dt not in _args.DTYPE_CODES:
        raise TypeError(f"{kern.name}: dtype {dt} is not supported (f32 or bf16)")
    if K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"{kern.name}: K={K}, V={V}; the kernel takes K, V <= {MAX_DIM}")
    f32 = (torch.float32,)
    for arg, t, shape, dts in (("r", r, (B, S, H, K), (dt,)), ("k", k, (B, S, H, K), (dt,)),
                               ("v", v, (B, S, H, V), (dt,)), ("w", w, (B, S, H, K), f32),
                               ("u", u, (H, K), f32), ("s0", s0, (B, H, K, V), f32)):
        _args.check(kern.name, arg, t, shape, dts, dev)
    y = torch.empty((B, S, H, V), dtype=dt, device=dev)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    nc = -(-S // CHUNK)
    states = torch.empty(B * H * nc * K * V, dtype=torch.float32, device=dev)
    sync = torch.zeros(1 + B * H * nc, dtype=torch.int32, device=dev)
    kern.launch(_args.ptr(r), _args.ptr(k), _args.ptr(v), _args.ptr(w), _args.ptr(u),
                _args.ptr(s0), _args.ptr(y), _args.ptr(s_out), _args.ptr(states),
                _args.ptr(sync), B, S, H, K, V, _args.DTYPE_CODES[dt], *_args.stream_args(dev))
    return y, s_out
