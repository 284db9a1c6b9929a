"""Public kernel surface of the port, with the reference's signatures
(``src/repro/kernels/ops.py``) minus its ``impl``/``block`` switches.

Dispatch goes by the device of the tensors: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel or
raises.  There is no switch that routes a CUDA tensor to the plain version.
``ef21_update`` (kernels 7-8 with the per-leaf scales between them, one
launch on the card where the reference runs two kernels around plain
code), ``fused_update_leaves`` (the step of a whole tree in one launch,
with x_bar's running sum) and the cohort row movement over a table of
buffers (``row_gather_buffers``, ``row_scatter_buffers_`` in place,
``row_scatter_``; ``row_scatter`` and ``row_scatter_buffers`` copy first)
and the arena round's server step (``server_step``: ``client_mean``, then
``server_dual``, the dual with lam's column sum in its pass;
``round_tail_mean``, the round tail with the client mean in its pass) are
the port's own; ``attend_cache`` and ``wkv6_step`` (one decode token) are
plain tensor code in the reference and here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import _args, ref
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import inner_loop as _il
from repro_torch.kernels import neighbor_reduce as _nr
from repro_torch.kernels import residual as _rs
from repro_torch.kernels import round_tail as _rt
from repro_torch.kernels import screen as _sc
from repro_torch.kernels import stale_mix as _sm
from repro_torch.kernels import wkv6 as _wk
from repro_torch.kernels.fused_update import (
    acc_mode_at, fused_update, fused_update_arena, fused_update_leaves,
)
from repro_torch.kernels.gather import row_gather as row_gather_buffers
from repro_torch.kernels.gather import row_scatter_ as row_scatter_buffers_
from repro_torch.kernels.inner_loop import inner_loop_affine
from repro_torch.kernels.neighbor_reduce import edge_flip, neighbor_reduce
from repro_torch.kernels.residual import residual_norm
from repro_torch.kernels.round_tail import (
    client_mean, dual_from_uplink, ef21_apply, ef21_rowmax, ef21_update, round_tail,
    round_tail_mean, scaffold_cv, server_dual, server_step,
)
from repro_torch.kernels.screen import screen_uplink
from repro_torch.kernels.stale_mix import stale_mix
from repro_torch.kernels.wkv6 import wkv6

# every kernel of the port, for launch accounting (chip_smoke.py): the
# seventeen in the order of the kernel table (ROADMAP.md), then the round
# tail's variant with the client mean in its pass (kernel 2's), the
# server step's mean pass (kernel 3's) and the EF21 uplink (kernels 7-8 in
# one pass)
KERNELS = (_il.KERNEL, _rt.ROUND_TAIL, _rt.DUAL_FROM_UPLINK, _fu.ARENA_KERNEL,
           _rt.SCAFFOLD_CV, _fu.KERNEL, _rt.EF21_ROWMAX, _rt.EF21_APPLY, _ga.ROW_GATHER,
           _ga.ROW_SCATTER, _sc.SCREEN_UPLINK, _sm.STALE_MIX, _rs.RESIDUAL_NORM,
           _nr.NEIGHBOR_REDUCE, _nr.EDGE_FLIP, _fa.FLASH_ATTENTION, _wk.WKV6,
           _rt.ROUND_TAIL_MEAN, _rt.CLIENT_MEAN, _rt.EF21_UPDATE)


def affine_inner_fits(width: int) -> bool:
    """Width gate of ``inner_loop_affine``: a width either of its routes takes."""
    return _il.fits(width)


# the plain per-leaf scales between kernels 7 and 8 (held against the card)
_ef21_row_scales = ref.ef21_row_scales_ref


def row_gather(arr, idx):
    """The (mc, W) cohort buffer arr[idx]: ``arr`` (m, W), ``idx`` (mc,)
    row ids in range (int32 or int64)."""
    return _ga.row_gather((arr,), idx)[0]


def row_scatter_(dst, idx, rows):
    """dst[idx[t]] = rows[t] in place (idx distinct); returns ``dst``."""
    return _ga.row_scatter_((dst,), idx, (rows,))[0]


def row_scatter_buffers(dsts, idx, rows) -> tuple:
    """The functional ``row_scatter_buffers_``: each buffer copied, then
    the copies scattered in one launch; ``dsts`` are not written."""
    return _ga.row_scatter_(tuple(d.clone(memory_format=torch.contiguous_format) for d in dsts),
                            idx, rows)


def row_scatter(dst, idx, rows):
    """``dst`` with row idx[t] replaced by rows[t] (idx distinct), as a new
    tensor (the reference's contract): a copy of ``dst``, then the in-place
    scatter of the cohort's rows."""
    return row_scatter_buffers((dst,), idx, (rows,))[0]


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal: bool = True,
                    window=None, q_offset=None):
    """Causal (optionally sliding-window) GQA attention, kernel 16.

    q (B, Sq, H, hd); k (B, Sk, Hkv, hd); v (B, Sk, Hkv, vd).  Without
    positions the keys sit at 0..Sk-1 and the queries at q_offset (default
    0) onwards: the model path, with no host read.  Explicit ``q_pos`` and
    ``k_pos`` (as ``ref.attention_ref`` takes them) run as they are on the
    CPU; on the card they must be contiguous, which is checked with a host
    read (``flash_attention.contiguous_offset``).  The reference's
    ``q_chunk``, ``k_chunk`` and ``causal_skip`` size its ``"xla"`` branch
    and have no counterpart here."""
    if q_pos is None:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset or 0)
    if _args.on_cpu(_fa.FLASH_ATTENTION.name, q):
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal, window=window)
    off = _fa.contiguous_offset(q_pos, k_pos, q.shape[1], k.shape[1])
    return _fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)


def attend_cache(q, k_cache, v_cache, q_pos, k_pos, *, window=None):
    """Single-token decode attention against a (possibly ring-buffer) cache,
    plain tensor code as in the reference (``ops.py:161``).

    q (B, 1, H, hd); caches (B, S, Hkv, hd/vd); q_pos an int32 scalar
    tensor; k_pos (S,), -1 = empty slot."""
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(f32)) / math.sqrt(hd)
    valid = (k_pos >= 0) & (k_pos <= q_pos)
    if window is not None:
        valid = valid & (k_pos > q_pos - window)
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhv->bhgv", p, v_cache.to(f32))
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def wkv6_step(r1, k1, v1, w1, u, s):
    """One decode step of the recurrence, plain tensor code as in the
    reference (``ops.py:247``).  r1, k1, w1 (B, H, K); v1 (B, H, V); s
    (B, H, K, V).  Returns (y (B, H, V) in r1's dtype, s' f32)."""
    f32 = torch.float32
    rf, kf, vf, wf = (a.to(f32) for a in (r1, k1, v1, w1))
    sf = s.to(f32)
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, sf + u.to(f32)[None, :, :, None] * kv)
    return y.to(r1.dtype), wf[..., :, None] * sf + kv


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "acc_mode_at", "affine_inner_fits", "attend_cache", "client_mean",
    "dual_from_uplink", "edge_flip", "ef21_apply", "ef21_rowmax", "ef21_update",
    "flash_attention", "fused_update", "fused_update_arena", "fused_update_leaves",
    "inner_loop_affine", "launches", "neighbor_reduce", "reset_launches", "residual_norm",
    "round_tail", "round_tail_mean", "row_gather", "row_gather_buffers", "row_scatter",
    "row_scatter_", "row_scatter_buffers", "row_scatter_buffers_", "scaffold_cv",
    "screen_uplink", "server_dual", "server_step", "stale_mix", "wkv6", "wkv6_step",
]
