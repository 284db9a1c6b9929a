"""Token-choice top-k MoE with capacity-based dispatch and shared experts,
the port of ``src/repro/models/moe.py``.

The routed path materialises (E, C, D) expert inputs, C the capacity
max(1, int(top_k T / E * CAPACITY_FACTOR)) (T at full capacity); a token
past its expert's capacity is dropped for that slot.  A Switch-style load
balance loss is returned beside the output.

What the port keeps exact where PyTorch's calls promise less than jax's:

  * top-k: ``jax.lax.top_k`` breaks ties toward the lower expert;
    ``torch.topk`` promises no order, so the top k come from a stable
    descending sort (router logits are bf16 cast to f32: ties are real);
  * the fused combine: the reference adds each (expert, slot)'s bf16
    contribution into its token with one scatter-add, which on the CPU adds
    a token's contributions in ascending expert order from 0; the port
    gathers them in that order and sums them one after another, with no
    atomics (``index_add_`` on CUDA adds in no fixed order);
  * the loop path's f32 combine hits each token once a slot, so it is a
    gather too;
  * drops: slot ``cap`` and the sentinel row T are written into an extra
    column and cut off, as ``mode="drop"`` drops them.

Training takes the client gradients as ``vmap(grad(loss))``, so the integer
bookkeeping (counts, slots, the (E, cap) tables) writes into no tensor in
place: every scatter is out of place, and the same integers come out.  The
fused dispatch's token gather (``xt_pad[tok]``, a token in up to k rows) is
``_DispatchGather``, whose backward gathers a token's k row gradients back
and adds them in ascending expert order, as the combine adds the forward's:
autograd's own backward of the gather (``index_put`` with accumulate) adds
them with float atomics on CUDA, in no fixed order, and a round would not
repeat bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def moe_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    ks = keys.split(5)
    p = {"router": L.dense_init(ks[0], (d, e), dtype),
         "wi": L.dense_init(ks[1], (e, d, ff), dtype),
         "wg": L.dense_init(ks[2], (e, d, ff), dtype),
         "wo": L.dense_init(ks[3], (e, ff, d), dtype)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(ks[4], d, cfg.n_shared_experts * ff, dtype)
    return p


def top_k(gates, k: int):
    """(values, indices) of the k largest gates of each row, ties toward the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ArchConfig, T: int, full_capacity: bool) -> int:
    """Slots an expert holds: T at full capacity, else max(1, int((k T / E)
    * 1.25)) in Python floats, as the reference computes it."""
    if full_capacity:
        return T
    return max(1, int((cfg.top_k * T / cfg.n_experts) * CAPACITY_FACTOR))


def _count(e, E: int):
    """Choices of each expert, (E,) int64 (integer sums: any order gives
    the same counts; ``bincount`` would wait on the device for its size)."""
    return torch.zeros(E, dtype=torch.int64, device=e.device).scatter_add(
        0, e, torch.ones_like(e))


def _slots(e, E: int, cap: int, counts=None):
    """Each choice's slot in its expert: its rank among the earlier choices
    of that expert (the reference's running one-hot sum), plus ``counts``
    of it, ``cap`` where it overflows; and each expert's choices.  The rank
    comes from a stable sort by expert, the same integers as the one-hot
    cumsum without its (n, E) scan: a choice's place in the sorted order
    less the choices of the experts before its own."""
    per_expert = _count(e, E)
    sorted_e, order = torch.sort(e, stable=True)
    starts = torch.cumsum(per_expert, 0) - per_expert
    rank = torch.arange(e.shape[-1], device=e.device) - starts[sorted_e]
    pos = torch.zeros_like(e).scatter(0, order, rank)
    if counts is not None:
        pos = pos + counts[e]
    return torch.where(pos < cap, pos, cap), per_expert


def _table(E: int, cap: int, e, slot, ids, fill: int):
    """(E, cap) of ``ids`` at (e, slot), ``fill`` elsewhere; slot ``cap``
    (an overflow) lands in an extra column that is cut off."""
    t = torch.full((E * (cap + 1),), fill, dtype=torch.int64, device=e.device)
    return t.scatter(0, e * (cap + 1) + slot, ids).reshape(E, cap + 1)[:, :cap]


class _DispatchGather(torch.autograd.Function):
    """``xt_pad[tok]`` for the fused dispatch: xt (T, D), tok (E, cap) token
    ids (T = the zero sentinel row) -> (E, cap, D).  Its backward sums each
    token's row gradients at ``rows`` (T, k): its (expert, slot) rows in
    ascending expert order, ``kept`` masking the dropped ones; the same
    order as the forward's combine, in the gradient's dtype.  Its tangent
    (forward mode, the curvature probe of ``--eta auto``) is the same gather
    of xt's tangent: the gather is linear in xt."""

    generate_vmap_rule = True

    @staticmethod
    def forward(xt, tok, rows, kept):
        return torch.cat([xt, xt.new_zeros((1, xt.shape[-1]))], dim=0)[tok]

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, tok, rows, kept = inputs
        # one list for both modes: the generated vmap rule keeps one set of
        # batch dims for what a context saves
        ctx.save_for_backward(tok, rows, kept)
        ctx.save_for_forward(tok, rows, kept)

    @staticmethod
    def jvp(ctx, xt_t, *_):
        tok = ctx.saved_tensors[0]
        return torch.cat([xt_t, xt_t.new_zeros((1, xt_t.shape[-1]))], dim=0)[tok]

    @staticmethod
    def backward(ctx, g):
        _, rows, kept = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        dx = torch.zeros((rows.shape[0], flat.shape[-1]), dtype=g.dtype, device=g.device)
        for j in range(rows.shape[1]):
            dx = torch.where(kept[:, j:j + 1], dx + flat[rows[:, j]], dx)
        return dx, None, None, None


def _experts(params, xg, act: str):
    """The routed experts' gated MLP on their (E, C, D) inputs -> f32."""
    h = torch.bmm(xg, params["wi"])
    g = L.activation(torch.bmm(xg, params["wg"]), act)
    return torch.bmm(h * g, params["wo"]).to(torch.float32)


def _aux(E: int, T: int, k: int, topi, gates):
    frac = _count(topi.reshape(-1), E).to(torch.float32) / (T * k)
    return E * torch.sum(frac * gates.mean(0))


def moe_apply(cfg: ArchConfig, params, x, act: str = "silu", full_capacity: bool = False,
              fused: Optional[bool] = None):
    """x (B, S, D) -> (out, aux_loss).  ``full_capacity`` (decode): capacity
    T, no token dropped.  ``fused`` (default ``cfg.moe_fused_dispatch``):
    one dispatch over all (token, slot) choices instead of one a slot."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = (xt @ params["router"]).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    cap = capacity(cfg, T, full_capacity)
    if cfg.moe_fused_dispatch if fused is None else fused:
        return _moe_fused(cfg, params, x, xt, topv, topi, gates, cap, act)
    xt_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)  # sentinel row T
    token_ids = torch.arange(T, device=x.device)

    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    # each choice's slot in its expert, capacity shared between the slots
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    for j in range(k):
        e_j = topi[:, j]
        slot, per_expert = _slots(e_j, E, cap, counts)
        counts = counts + per_expert
        idx = _table(E, cap, e_j, slot, token_ids, T)
        y = _experts(params, xt_pad[idx], act)  # (E, cap, D)
        # combine: token t's row of expert e_j[t] at its slot, gate-weighted
        kept = slot < cap
        y_t = y.reshape(E * cap, D)[(e_j * cap + torch.clamp_max(slot, cap - 1))]
        out = torch.where(kept[:, None], out + y_t * topv[:, j:j + 1], out)

    out = out.to(x.dtype)
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(params["shared"], xt, act)
    return out.reshape(B, S, D), _aux(E, T, k, topi, gates)


def _moe_fused(cfg: ArchConfig, params, x, xt, topv, topi, gates, cap, act):
    """One dispatch for all k slots, sharing one (E, cap) buffer, choices
    token-major (f = t k + j); the combine in the activation dtype, each
    token's contributions added in ascending expert order."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device

    e_flat = topi.reshape(-1)  # (T k,)
    slot, _ = _slots(e_flat, E, cap)
    fidx = _table(E, cap, e_flat, slot, torch.arange(T * k, device=dev), T * k)

    # token t's choices in ascending expert order, each at its (e, slot)
    e_sorted, order = torch.sort(topi, dim=-1, stable=True)
    slot_sorted = torch.gather(slot.reshape(T, k), 1, order)
    kept = slot_sorted < cap
    rows = e_sorted * cap + torch.clamp_max(slot_sorted, cap - 1)

    tok = torch.where(fidx < T * k, torch.div(fidx, k, rounding_mode="floor"), T)
    y = _experts(params, _DispatchGather.apply(xt, tok, rows, kept), act)  # (E, cap, D)
    w_ec = torch.where(fidx < T * k, topv.reshape(-1)[torch.clamp_max(fidx, T * k - 1)], 0.0)
    contrib = (y * w_ec[..., None]).to(x.dtype).reshape(E * cap, D)

    out = torch.zeros((T, D), dtype=x.dtype, device=dev)
    for j in range(k):
        out = torch.where(kept[:, j:j + 1], out + contrib[rows[:, j]], out)
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(params["shared"], xt, act)
    return out.reshape(B, S, D), _aux(E, T, k, topi, gates)
