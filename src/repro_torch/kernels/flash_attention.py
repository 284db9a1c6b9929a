"""Kernel 16: causal GQA attention with an online softmax, optionally over a
sliding window, one CUDA kernel per call (``csrc/flash_attention.cu``); the
port of ``src/repro/kernels/flash_attention.py``:

  * ``flash_attention``  q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk,
                         Hkv, vd) -> (B, Sq, H, vd) in q's dtype, f32
                         accumulators, query i at position q_offset + i

Every dense or local block of ``models.attention.gqa_apply`` and every MLA
block of ``models.attention.mla_apply`` calls it once on prefill.  CUDA
operands: q, k and v all f32 or all bf16, contiguous, hd and vd up to 256
(MLA's 192 / 128, recurrentgemma's 256, stablelm's 160), H a multiple of
Hkv, any Sq and Sk.  The positions are
contiguous: keys at 0..Sk-1, queries from ``q_offset``, a Python int the
caller passes so that no launch waits on a host read.  The plain version
(``ref.flash_attention_ref``) takes any position vectors.

Two routes on the card, chosen by ``route`` from the dtype and the head
dim (not a fallback: each route is the kernel for its operands):

  * ``"wgmma"``       bf16 with hd and vd multiples of 16: both products on
                      the tensor cores (wgmma, tiles brought in by TMA), p
                      rounded to bf16 before p v, l and the accumulators in
                      f32; key tiles of 128 up to hd, vd = 128, of 64 beyond
                      (shared memory and registers) -- every bf16 prefill
                      of the ten archs takes it;
  * ``"cuda_cores"``  f32 (f32 products, not TF32, so the f32 path holds
                      1e-4), or bf16 with another hd or vd.

``last_route`` records the route of the last call on the card.

Kernel 16b, ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), is
the backward: (dq, dk, dv) from q, k, v, the output o, the per-row
logsumexp ``lse`` (B, H, Sq) f32 that ``flash_attention(..., lse=True)``
also returns, and do, at every head dim kernel 16 takes (hd, vd <= 256,
``BWD_MAX_HEAD_DIM``).  It recomputes the scores tile by tile and has three
routes (``bwd_route``; ``last_bwd_route`` records the last call's):

  * ``"wgmma"``       bf16 with hd = vd a multiple of 16 up to 128: a dq grid,
                      which also forms D = do . o, then a dk/dv grid with the
                      transposed scores in registers, both on wgmma with
                      tiles brought in by TMA;
  * ``"mma"``         bf16 with other hd and vd multiples of 16 (MLA's 192 /
                      128, recurrentgemma's 256, stablelm's 160): the same
                      two grids on the warp tensor cores (``mma.sync``), P
                      and dS rounded to bf16 as on wgmma, dk and dv in
                      separate warps of a block (their accumulators at 256
                      do not fit one thread's registers together);
  * ``"cuda_cores"``  f32 (f32 products, not TF32), and bf16 at other dims.

On the last two a kv head's query heads are split across blocks when the
(key tile, kv head) grid is small (``dkdv_splits``) and the partials added
in a fixed order.  dk and dv are
summed over each kv head's query heads, every sum in a fixed order.
``kernels.ops`` makes the pair an ``autograd.Function``; the plain backward
(``ref.flash_attention_bwd_ref``, autograd of the plain forward) runs on the
CPU.

Kernels 16j and 16bj (``csrc/flash_attention_jvp.cu``) are the tangents
(forward mode) of 16 and 16b, for the curvature probe of ``--eta auto``
(``vmap(jvp(grad(loss)))``, ``core.autotune.estimate_L``), at every head
dim and dtype kernel 16 takes:

  * ``flash_attention_jvp``      q, k, v, lse and the tangents q', k', v' ->
                                 (o', lse'), one sweep over the keys;
  * ``flash_attention_bwd_jvp``  16b's operands q, k, v, o, lse, do and the
                                 tangents q', k', v', o', do' -> (dq', dk',
                                 dv'), lse' formed inside (a row grid for
                                 lse', D, D' and dq', then a key grid for
                                 dk', dv').

Both take two routes (``jvp_route``; ``last_jvp_route`` records the last
call's):

  * ``"mma"``         bf16 with hd and vd multiples of 16 (every bf16 arch):
                      the warp tensor cores (``mma.sync``), f32 accumulators,
                      16j's P and E = P S' as bf16 hi + lo pairs, 16bj's P,
                      P', dS, dS' rounded to bf16; 16bj's key grid splits a
                      kv head's query heads across blocks when it is small
                      (``dkdv_splits`` with ``JVP_KEY_TILE``);
  * ``"cuda_cores"``  f32 (f32 products, not TF32), and bf16 at other dims.

Their plain versions are ``ref.flash_attention_jvp_ref`` and
``ref.flash_attention_bwd_jvp_ref``; ``kernels.ops`` calls them from the
forward-mode rules of ``FlashAttention`` and ``FlashAttentionBackward``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import F, I, P, Kernel

MAX_HEAD_DIM = 256
BWD_MAX_HEAD_DIM = MAX_HEAD_DIM  # kernel 16b: every head dim kernel 16 takes
BWD_TC_MAX_HEAD_DIM = 128  # 16b's tensor-core route: bf16, hd = vd <= 128
# csrc/flash_attention_bwd.cu: keys a block of the dk/dv grid, by route
BWD_KEY_TILE = {"cuda_cores": 32, "mma": 64}
BWD_ROUTE_CODES = {"cuda_cores": 0, "wgmma": 1, "mma": 2}
JVP_ROUTE_CODES = {"cuda_cores": 0, "mma": 1}
JVP_KEY_TILE = 64  # csrc/flash_attention_jvp.cu jm::kKeys: keys a block of 16bj's key grid
TC_HEAD_DIM_STEP = 16  # the tensor-core route's hd: a multiple of wgmma's bf16 depth
SCRATCH_ROWS = 64  # csrc/flash_attention_bwd.cu tc::kRowsPad

FLASH_ATTENTION = Kernel(
    "flash_attention", "flash_attention.cu", "launch_flash_attention",
    # q k v o lse B Sq Sk H Hkv hd vd q_offset causal window dtype tensor_cores scale dev stream
    [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, F, I, P],
    replaces="src/repro/kernels/flash_attention.py:70",
)

FLASH_ATTENTION_BWD = Kernel(
    "flash_attention_bwd", "flash_attention_bwd.cu", "launch_flash_attention_bwd",
    # q k v o lse do dq dk dv scratch B Sq Sk H Hkv hd vd splits q_offset causal window
    # dtype route scale dev stream
    [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, F, I, P],
    replaces="src/repro/kernels/flash_attention.py:70 (its backward: ops.py _flash_xla)",
)

FLASH_ATTENTION_JVP = Kernel(
    "flash_attention_jvp", "flash_attention_jvp.cu", "launch_flash_attention_jvp",
    # q k v lse qt kt vt ot lse_t B Sq Sk H Hkv hd vd q_offset causal window dtype route scale
    # dev stream
    [P] * 9 + [I] * 12 + [F, I, P],
    replaces="none: jax.jvp through src/repro/kernels/ops.py _flash_xla (the reference's "
             "curvature probe, src/repro/core/autotune.py:140-159)",
)

FLASH_ATTENTION_BWD_JVP = Kernel(
    "flash_attention_bwd_jvp", "flash_attention_jvp.cu", "launch_flash_attention_bwd_jvp",
    # q k v o lse do qt kt vt ot dot dq_t dk_t dv_t scratch B Sq Sk H Hkv hd vd splits
    # q_offset causal window dtype route scale dev stream
    [P] * 15 + [I] * 13 + [F, I, P],
    replaces="none: jax.jvp of jax.grad through src/repro/kernels/ops.py _flash_xla (the "
             "reference's curvature probe, src/repro/core/autotune.py:140-159)",
)

last_route: str | None = None
last_bwd_route: str | None = None
last_jvp_route: str | None = None


def route(dtype: torch.dtype, hd: int, vd: int | None = None) -> str:
    """The kernel's route for these operands: ``"wgmma"`` for bf16 with hd
    and vd (default hd) multiples of 16, else ``"cuda_cores"`` (see the
    module doc)."""
    vd = hd if vd is None else vd
    if dtype == torch.bfloat16 and hd % TC_HEAD_DIM_STEP == 0 and vd % TC_HEAD_DIM_STEP == 0:
        return "wgmma"
    return "cuda_cores"


def bwd_route(dtype: torch.dtype, hd: int, vd: int) -> str:
    """Kernel 16b's route for these operands: ``"wgmma"`` for bf16 with hd =
    vd a multiple of 16 up to 128, ``"mma"`` for bf16 with other hd and vd
    multiples of 16 (the warp tensor cores), else ``"cuda_cores"`` (see the
    module doc)."""
    if dtype == torch.bfloat16 and hd % TC_HEAD_DIM_STEP == 0 and vd % TC_HEAD_DIM_STEP == 0:
        return "wgmma" if hd == vd and hd <= BWD_TC_MAX_HEAD_DIM else "mma"
    return "cuda_cores"


def jvp_route(dtype: torch.dtype, hd: int, vd: int) -> str:
    """The route of kernels 16j and 16bj for these operands: ``"mma"`` (the
    warp tensor cores) for bf16 with hd and vd multiples of 16, else
    ``"cuda_cores"`` (see the module doc)."""
    if dtype == torch.bfloat16 and hd % TC_HEAD_DIM_STEP == 0 and vd % TC_HEAD_DIM_STEP == 0:
        return "mma"
    return "cuda_cores"


def dkdv_splits(B: int, Sk: int, Hkv: int, G: int, sms: int, key_tile: int = 32) -> int:
    """Splits of each kv head's G query heads across the dk/dv grid's blocks
    (16b's CUDA-core and warp tensor-core routes, 16bj's key grid on the
    warp tensor cores): 1 while its B Hkv ceil(Sk / key_tile) blocks fill
    the ``sms`` SMs, else enough splits for about two blocks an SM (each
    split a ceil(G / splits) heads' share; no split left empty)."""
    blocks = B * Hkv * -(-Sk // key_tile)
    if blocks >= sms or G == 1:
        return 1
    per = -(-G // -(-2 * sms // max(blocks, 1)))
    return -(-G // per)


def backward_takes(hd: int, vd: int) -> bool:
    """Whether kernel 16b takes these head dims (hd, vd <= 256: every head
    dim kernel 16 takes)."""
    return 1 <= hd <= BWD_MAX_HEAD_DIM and 1 <= vd <= BWD_MAX_HEAD_DIM


def check_backward(hd: int, vd: int) -> None:
    """Raise ``NotImplementedError`` where a gradient would reach kernel 16
    at head dims that kernel 16b does not take (``ops.flash_attention``
    calls it on the card when a gradient can follow)."""
    if not backward_takes(hd, vd):
        raise NotImplementedError(
            f"flash_attention: no backward kernel at hd={hd}, vd={vd} (kernel 16b takes "
            f"hd, vd <= {BWD_MAX_HEAD_DIM})")


_sm_count: dict = {}


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def _positions(q, k, q_offset: int):
    dev = q.device
    return (torch.arange(q_offset, q_offset + q.shape[1], device=dev),
            torch.arange(k.shape[1], device=dev))


def flash_attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
                    lse: bool = False):
    """Attention of the Sq queries at positions q_offset .. q_offset + Sq - 1
    over the Sk keys at positions 0 .. Sk - 1 (see the module doc).  With
    ``lse`` also each query row's logsumexp, (B, H, Sq) f32, for the
    backward."""
    global last_route
    kern = FLASH_ATTENTION
    if _args.on_cpu(kern.name, q):
        q_pos, k_pos = _positions(q, k, q_offset)
        out = ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal, window=window)
        if lse:
            return out, ref.flash_attention_lse_ref(q, k, q_pos, k_pos, causal=causal,
                                                    window=window)
        return out
    _check(kern.name, q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dt, dev = q.dtype, q.device
    out = torch.empty((B, Sq, H, vd), dtype=dt, device=dev)
    lse_t = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if lse else None
    path = route(dt, hd, vd)
    kern.launch(_args.ptr(q), _args.ptr(k), _args.ptr(v), _args.ptr(out), _args.ptr(lse_t), B,
                Sq, Sk, H, Hkv, hd, vd, int(q_offset), int(causal),
                0 if window is None else int(window), _args.DTYPE_CODES[dt],
                int(path == "wgmma"), 1.0 / math.sqrt(hd), *_args.stream_args(dev))
    last_route = path
    return (out, lse_t) if lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                        q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the incoming
    gradient ``do``, from its output ``o`` and row logsumexp ``lse`` (kernel
    16b; see the module doc)."""
    kern = FLASH_ATTENTION_BWD
    if _args.on_cpu(kern.name, q):
        q_pos, k_pos = _positions(q, k, q_offset)
        return ref.flash_attention_bwd_ref(q, k, v, do, q_pos, k_pos, causal=causal,
                                           window=window)
    global last_bwd_route
    _check(kern.name, q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dt, dev = q.dtype, q.device
    if not backward_takes(hd, vd):
        raise ValueError(f"{kern.name}: head dims hd={hd}, vd={vd}; the kernel takes "
                         f"hd, vd <= {BWD_MAX_HEAD_DIM}")
    _args.check(kern.name, "o", o, (B, Sq, H, vd), (dt,), dev)
    _args.check(kern.name, "do", do, (B, Sq, H, vd), (dt,), dev)
    _args.check(kern.name, "lse", lse, (B, H, Sq), (torch.float32,), dev)
    path = bwd_route(dt, hd, vd)
    splits = 1 if path == "wgmma" else dkdv_splits(B, Sk, Hkv, H // Hkv, _sms(dev),
                                                   BWD_KEY_TILE[path])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the tensor-core route's lse and D rows, padded to whole query tiles,
    # then the CUDA-core dk/dv grid's partials when its heads are split
    pad = B * H * -(-Sq // SCRATCH_ROWS) * SCRATCH_ROWS
    parts = splits * B * Sk * Hkv * (hd + vd) if splits > 1 else 0
    scratch = torch.empty(2 * pad + parts, dtype=torch.float32, device=dev)
    kern.launch(_args.ptr(q), _args.ptr(k), _args.ptr(v), _args.ptr(o), _args.ptr(lse),
                _args.ptr(do), _args.ptr(dq), _args.ptr(dk), _args.ptr(dv), _args.ptr(scratch),
                B, Sq, Sk, H, Hkv, hd, vd, splits, int(q_offset), int(causal),
                0 if window is None else int(window), _args.DTYPE_CODES[dt],
                BWD_ROUTE_CODES[path], 1.0 / math.sqrt(hd), *_args.stream_args(dev))
    last_bwd_route = path
    return dq, dk, dv


def flash_attention_jvp(q, k, v, lse, qt, kt, vt, *, causal: bool = True, window=None,
                        q_offset: int = 0):
    """(o', lse') of ``flash_attention`` at (q, k, v), whose row logsumexp
    was ``lse``, along the tangents (q', k', v') (kernel 16j; see the module
    doc): o' in q's dtype, lse' (B, H, Sq) f32."""
    kern = FLASH_ATTENTION_JVP
    if _args.on_cpu(kern.name, q):
        q_pos, k_pos = _positions(q, k, q_offset)
        return ref.flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, q_pos, k_pos,
                                           causal=causal, window=window)
    global last_jvp_route
    _check(kern.name, q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dt, dev = q.dtype, q.device
    _args.check(kern.name, "lse", lse, (B, H, Sq), (torch.float32,), dev)
    for name, t, like in (("qt", qt, q), ("kt", kt, k), ("vt", vt, v)):
        _args.check(kern.name, name, t, like.shape, (dt,), dev)
    ot = torch.empty((B, Sq, H, vd), dtype=dt, device=dev)
    lse_t = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    path = jvp_route(dt, hd, vd)
    kern.launch(_args.ptr(q), _args.ptr(k), _args.ptr(v), _args.ptr(lse), _args.ptr(qt),
                _args.ptr(kt), _args.ptr(vt), _args.ptr(ot), _args.ptr(lse_t), B, Sq, Sk, H,
                Hkv, hd, vd, int(q_offset), int(causal), 0 if window is None else int(window),
                _args.DTYPE_CODES[dt], JVP_ROUTE_CODES[path], 1.0 / math.sqrt(hd),
                *_args.stream_args(dev))
    last_jvp_route = path
    return ot, lse_t


def flash_attention_bwd_jvp(q, k, v, o, lse, do, qt, kt, vt, ot, dot, *, causal: bool = True,
                            window=None, q_offset: int = 0):
    """(dq', dk', dv'): the tangent of ``flash_attention_bwd`` at (q, k, v,
    o, lse, do) along (q', k', v', o', do'), lse' formed inside (kernel 16bj;
    see the module doc), in q's dtype."""
    kern = FLASH_ATTENTION_BWD_JVP
    if _args.on_cpu(kern.name, q):
        q_pos, k_pos = _positions(q, k, q_offset)
        return ref.flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_pos,
                                               k_pos, causal=causal, window=window)
    global last_jvp_route
    _check(kern.name, q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dt, dev = q.dtype, q.device
    _args.check(kern.name, "lse", lse, (B, H, Sq), (torch.float32,), dev)
    for name, t, like in (("o", o, do), ("do", do, do), ("qt", qt, q), ("kt", kt, k),
                          ("vt", vt, v), ("ot", ot, do), ("dot", dot, do)):
        _args.check(kern.name, name, t, (B, Sq, H, vd) if like is do else like.shape, (dt,),
                    dev)
    path = jvp_route(dt, hd, vd)
    splits = (dkdv_splits(B, Sk, Hkv, H // Hkv, _sms(dev), JVP_KEY_TILE) if path == "mma"
              else 1)
    dq_t, dk_t, dv_t = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the rows' lse', D, D', then the key grid's partials when its heads are split
    parts = splits * B * Sk * Hkv * (hd + vd) if splits > 1 else 0
    scratch = torch.empty(3 * B * H * Sq + parts, dtype=torch.float32, device=dev)
    kern.launch(_args.ptr(q), _args.ptr(k), _args.ptr(v), _args.ptr(o), _args.ptr(lse),
                _args.ptr(do), _args.ptr(qt), _args.ptr(kt), _args.ptr(vt), _args.ptr(ot),
                _args.ptr(dot), _args.ptr(dq_t), _args.ptr(dk_t), _args.ptr(dv_t),
                _args.ptr(scratch), B, Sq, Sk, H, Hkv, hd, vd, splits, int(q_offset),
                int(causal), 0 if window is None else int(window), _args.DTYPE_CODES[dt],
                JVP_ROUTE_CODES[path], 1.0 / math.sqrt(hd), *_args.stream_args(dev))
    last_jvp_route = path
    return dq_t, dk_t, dv_t


def _check(name, q, k, v, window) -> None:
    """The operand rules of both kernels (see the module doc)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B, S, heads, dim)")
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    dt, dev = q.dtype, q.device
    if dt not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} is not supported (f32 or bf16)")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= vd <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims hd={hd}, vd={vd}; the kernel takes "
                         f"hd, vd <= {MAX_HEAD_DIM}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: {H} query heads are not a multiple of {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    _args.check(name, "q", q, (B, Sq, H, hd), (dt,), dev)
    _args.check(name, "k", k, (B, Sk, Hkv, hd), (dt,), dev)
    _args.check(name, "v", v, (B, Sk, Hkv, vd), (dt,), dev)


def contiguous_offset(q_pos, k_pos, sq: int, sk: int) -> int:
    """The query offset of explicit position vectors that the kernel can
    take (k_pos = arange(Sk), q_pos = q_pos[0] + arange(Sq)), read on the
    host; raises for any other positions."""
    q_pos, k_pos = q_pos.cpu(), k_pos.cpu()
    off = int(q_pos[0]) if sq else 0
    if not (torch.equal(k_pos, torch.arange(sk, dtype=k_pos.dtype))
            and torch.equal(q_pos, torch.arange(off, off + sq, dtype=q_pos.dtype))):
        raise ValueError("flash_attention: the CUDA kernel takes contiguous positions "
                         "(k_pos = arange(Sk), q_pos = offset + arange(Sq))")
    return off
