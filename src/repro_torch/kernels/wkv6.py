"""Kernel 17: the RWKV-6 recurrence with a data-dependent decay, in chunks of
64 steps, one CUDA kernel (``csrc/wkv6.cu``: every chunk at once, the
state passed from chunk to chunk in order); the port of
``src/repro/kernels/wkv6.py``:

  * ``wkv6``  r, k, w (B, S, H, K); v (B, S, H, V); u (H, K), or (n, H, K)
              with row i of u for batch rows i B / n .. (i + 1) B / n - 1;
              s0 (B, H, K, V) -> y (B, S, H, V) in r's dtype, final state
              (B, H, K, V) f32

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

Kernel 17b, ``wkv6_bwd`` (``csrc/wkv6_bwd.cu``), is the backward: (dr, dk,
dv, dw, du, ds0) from the forward's operands, its final state and the states
it passed between chunks (``wkv6(..., keep_states=True)`` returns them
instead of freeing them), dy and ds_final.  Like the forward it is one
chunk-parallel kernel, walking the chunks in reverse: each block passes the
state gradient to the chunk before through flags in a zeroed scratch
buffer; du is summed in a second, small grid.  dw is with respect to the
kernel's w input; du has u's shape, each row summed over the batch rows that
read it.  ``kernels.ops`` makes the pair an ``autograd.Function``; the plain
backward (``ref.wkv6_bwd_ref``, autograd of the plain forward) runs on the
CPU.

Kernels 17j and 17bj (``csrc/wkv6_jvp.cu``) are their tangents, the
forward-mode rules of ``ops.Wkv6`` and ``ops.Wkv6Backward``:

  * ``wkv6_jvp``      (y', s_final') from the primals, the forward's
                      ``states`` and the tangents r', k', v' (r's dtype), w',
                      u', s0' (f32, u' u's shape): one chunk-parallel launch
                      passing the state's tangent from chunk to chunk;
  * ``wkv6_bwd_jvp``  (dr', dk', dv', dw', du', ds0') of ``wkv6_bwd``'s
                      outputs for the tangents of its inputs, dy' and
                      ds_final' with them (None: zero): one call, four
                      launches (the state tangents forward, the state
                      gradient and its tangent in reverse, the outputs, du').

Their plain versions, ``ref.wkv6_jvp_ref`` and ``ref.wkv6_bwd_jvp_ref``, run
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import I, P, Kernel

CHUNK = 64
SUB_CHUNKS = 4  # csrc/wkv6_bwd.cu: du's share is summed a sub-chunk of 16 steps at a time
MAX_DIM = 64

WKV6 = Kernel(
    "wkv6", "wkv6.cu", "launch_wkv6",
    # r k v w u s0 y s_out states sync B S H K V u_div dtype dev stream
    [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/wkv6.py:73",
)

WKV6_BWD = Kernel(
    "wkv6_bwd", "wkv6_bwd.cu", "launch_wkv6_bwd",
    # r k v w u s0 s_out states dy ds_final dr dk dv dw du ds0 dstates du_part dk_part
    # sync B S H K V u_div dtype dev stream
    [P] * 20 + [I, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/wkv6.py:73 (its backward: ops.py _wkv6_chunked_xla)",
)


WKV6_JVP = Kernel(
    "wkv6_jvp", "wkv6_jvp.cu", "launch_wkv6_jvp",
    # r k v w u s0 states rt kt vt wt ut s0t yt s_out_t tstates sync
    # B S H K V u_div dtype dev stream
    [P] * 17 + [I, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/ops.py:184 _wkv6_chunked_xla (its jvp)",
)

WKV6_BWD_JVP = Kernel(
    "wkv6_bwd_jvp", "wkv6_jvp.cu", "launch_wkv6_bwd_jvp",
    # r k v w u s0 s_out states dy ds_final rt kt vt wt ut s0t dyt ds_final_t
    # drt dkt dvt dwt dut ds0t tstates s_out_t dstates dstates_t du_part sync
    # B S H K V u_div dtype dev stream
    [P] * 30 + [I, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/ops.py:184 _wkv6_chunked_xla (the jvp of its grad)",
)


def _check(name, r, k, v, w, u, s0) -> int:
    """The operand rules of both kernels (see the module doc); returns
    u_div, the batch rows that read each row of u."""
    if r.ndim != 4:
        raise ValueError(f"{name}: r must be (B, S, H, K), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    if dt not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} is not supported (f32 or bf16)")
    if K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"{name}: K={K}, V={V}; the kernel takes K, V <= {MAX_DIM}")
    n_u = 1 if u.ndim == 2 else u.shape[0]
    if n_u < 1 or B % n_u:
        raise ValueError(f"{name}: {n_u} rows of u do not divide the batch of {B}")
    f32 = (torch.float32,)
    for arg, t, shape, dts in (("r", r, (B, S, H, K), (dt,)), ("k", k, (B, S, H, K), (dt,)),
                               ("v", v, (B, S, H, V), (dt,)), ("w", w, (B, S, H, K), f32),
                               ("u", u, tuple(u.shape[:-2]) + (H, K), f32),
                               ("s0", s0, (B, H, K, V), f32)):
        _args.check(name, arg, t, shape, dts, dev)
    return B // n_u


def wkv6(r, k, v, w, u, s0, *, keep_states: bool = False):
    """(y, s_final) of the recurrence (see the module doc); with
    ``keep_states`` also the states passed between chunks, for the backward
    (None on the CPU, whose plain backward recomputes them)."""
    kern = WKV6
    if _args.on_cpu(kern.name, r):
        y, s_out = ref.wkv6_ref(r, k, v, w, u, s0, chunk=CHUNK)
        return (y, s_out, None) if keep_states else (y, s_out)
    u_div = _check(kern.name, r, k, v, w, u, s0)
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    y = torch.empty((B, S, H, V), dtype=dt, device=dev)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    nc = -(-S // CHUNK)
    states = torch.empty(B * H * nc * K * V, dtype=torch.float32, device=dev)
    sync = torch.zeros(1 + B * H * nc, dtype=torch.int32, device=dev)
    kern.launch(_args.ptr(r), _args.ptr(k), _args.ptr(v), _args.ptr(w), _args.ptr(u),
                _args.ptr(s0), _args.ptr(y), _args.ptr(s_out), _args.ptr(states),
                _args.ptr(sync), B, S, H, K, V, u_div, _args.DTYPE_CODES[dt],
                *_args.stream_args(dev))
    return (y, s_out, states) if keep_states else (y, s_out)


def wkv6_bwd(r, k, v, w, u, s0, s_out, states, dy, ds_final=None):
    """(dr, dk, dv, dw, du, ds0) of ``wkv6`` for the incoming gradients dy
    and ds_final (None: zero), from its final state and the ``states`` that
    ``wkv6(..., keep_states=True)`` returned (kernel 17b)."""
    kern = WKV6_BWD
    if _args.on_cpu(kern.name, r):
        return ref.wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds_final, chunk=CHUNK)
    u_div = _check(kern.name, r, k, v, w, u, s0)
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    nc = -(-S // CHUNK)
    _args.check(kern.name, "s_out", s_out, (B, H, K, V), (torch.float32,), dev)
    _args.check(kern.name, "states", states, (B * H * nc * K * V,), (torch.float32,), dev)
    _args.check(kern.name, "dy", dy, (B, S, H, V), (dt,), dev)
    if ds_final is not None:
        _args.check(kern.name, "ds_final", ds_final, (B, H, K, V), (torch.float32,), dev)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du, ds0 = torch.empty_like(w), torch.empty_like(u), torch.empty_like(s0)
    dstates = torch.empty(B * H * nc * K * V, dtype=torch.float32, device=dev)
    du_part = torch.empty(B * H * nc * SUB_CHUNKS * K, dtype=torch.float32, device=dev)
    dk_part = torch.empty(B * H * nc * CHUNK * MAX_DIM, dtype=torch.float32, device=dev)
    sync = torch.zeros(1 + B * H * nc, dtype=torch.int32, device=dev)
    kern.launch(*(_args.ptr(t) for t in (r, k, v, w, u, s0, s_out, states, dy, ds_final, dr, dk,
                                          dv, dw, du, ds0, dstates, du_part, dk_part, sync)),
                B, S, H, K, V, u_div, _args.DTYPE_CODES[dt], *_args.stream_args(dev))
    return dr, dk, dv, dw, du, ds0


def _check_tangents(name, r, k, v, w, u, s0, rt, kt, vt, wt, ut, s0t) -> None:
    """Each tangent takes its primal's shape and dtype (``_check``'s rules)."""
    for arg, t, p in (("r'", rt, r), ("k'", kt, k), ("v'", vt, v), ("w'", wt, w), ("u'", ut, u),
                      ("s0'", s0t, s0)):
        _args.check(name, arg, t, tuple(p.shape), (p.dtype,), p.device)


def wkv6_jvp(r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t):
    """(y', s_final') of ``wkv6`` for the tangents r', k', v', w', u', s0'
    (kernel 17j), from the ``states`` that ``wkv6(..., keep_states=True)``
    returned (None on the CPU, whose plain version recomputes them)."""
    kern = WKV6_JVP
    if _args.on_cpu(kern.name, r):
        return ref.wkv6_jvp_ref(r, k, v, w, u, s0, rt, kt, vt, wt, ut, s0t, chunk=CHUNK)
    u_div = _check(kern.name, r, k, v, w, u, s0)
    _check_tangents(kern.name, r, k, v, w, u, s0, rt, kt, vt, wt, ut, s0t)
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    nc = -(-S // CHUNK)
    _args.check(kern.name, "states", states, (B * H * nc * K * V,), (torch.float32,), dev)
    yt = torch.empty((B, S, H, V), dtype=dt, device=dev)
    s_out_t = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    tstates = torch.empty(B * H * nc * K * V, dtype=torch.float32, device=dev)
    sync = torch.zeros(1 + B * H * nc, dtype=torch.int32, device=dev)
    kern.launch(*(_args.ptr(t) for t in (r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t, yt,
                                          s_out_t, tstates, sync)),
                B, S, H, K, V, u_div, _args.DTYPE_CODES[dt], *_args.stream_args(dev))
    return yt, s_out_t


def wkv6_bwd_jvp(r, k, v, w, u, s0, s_out, states, dy, ds_final, rt, kt, vt, wt, ut, s0t, dyt,
                 ds_final_t=None):
    """(dr', dk', dv', dw', du', ds0') of ``wkv6_bwd`` for the tangents of
    its inputs (kernel 17bj): r', k', v', w', u', s0' as ``wkv6_jvp`` takes
    them, dy' (dy's shape and dtype) and ds_final' (None: zero; ds_final None
    is zero too).  The tangents of the forward's states are formed inside,
    so none is taken."""
    kern = WKV6_BWD_JVP
    if _args.on_cpu(kern.name, r):
        return ref.wkv6_bwd_jvp_ref(r, k, v, w, u, s0, dy, ds_final, rt, kt, vt, wt, ut, s0t,
                                    dyt, ds_final_t, chunk=CHUNK)
    u_div = _check(kern.name, r, k, v, w, u, s0)
    _check_tangents(kern.name, r, k, v, w, u, s0, rt, kt, vt, wt, ut, s0t)
    B, S, H, K = r.shape
    V = v.shape[-1]
    dt, dev = r.dtype, r.device
    nc = -(-S // CHUNK)
    f32 = (torch.float32,)
    _args.check(kern.name, "s_out", s_out, (B, H, K, V), f32, dev)
    _args.check(kern.name, "states", states, (B * H * nc * K * V,), f32, dev)
    _args.check(kern.name, "dy", dy, (B, S, H, V), (dt,), dev)
    _args.check(kern.name, "dy'", dyt, (B, S, H, V), (dt,), dev)
    for arg, t in (("ds_final", ds_final), ("ds_final'", ds_final_t)):
        if t is not None:
            _args.check(kern.name, arg, t, (B, H, K, V), f32, dev)
    drt, dkt, dvt = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dwt, dut, ds0t = torch.empty_like(w), torch.empty_like(u), torch.empty_like(s0)
    tstates, dstates, dstates_t = (torch.empty(B * H * nc * K * V, dtype=torch.float32, device=dev)
                                   for _ in range(3))
    s_out_t = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    du_part = torch.empty(B * H * nc * K, dtype=torch.float32, device=dev)
    sync = torch.zeros(2 * (1 + B * H * nc), dtype=torch.int32, device=dev)
    kern.launch(*(_args.ptr(t) for t in (r, k, v, w, u, s0, s_out, states, dy, ds_final, rt, kt,
                                          vt, wt, ut, s0t, dyt, ds_final_t, drt, dkt, dvt, dwt,
                                          dut, ds0t, tstates, s_out_t, dstates, dstates_t, du_part,
                                          sync)),
                B, S, H, K, V, u_div, _args.DTYPE_CODES[dt], *_args.stream_args(dev))
    return drt, dkt, dvt, dwt, dut, ds0t
