"""Pattern-based decoder stack, the port of ``src/repro/models/stack.py``.

A config declares a repeating ``block_pattern``.  Layers are grouped as the
reference groups them:

    [lead]  first_dense_layers explicit dense blocks
    [units] n_units repetitions of the pattern, parameters stacked along a
            leading unit dim (the reference scans them with ``lax.scan``;
            here a Python loop walks them)
    [tail]  the remainder (< pattern length) explicit blocks

Block kinds: dense | local | moe | rwkv | rec, with GQA or MLA attention;
``dense_override`` builds and runs DeepSeek-V2's lead dense layer of an
otherwise-MoE config.  ``block_apply`` returns ``(x, new_cache, aux)``; the
unit caches are stacked along the unit dim, as the reference's scan stacks
them.  Decode updates the stacked caches in place (``models.attention``) and
writes each unit's recurrent state back into its slice.  MoE prefill runs
the per-slot loop and train and decode the fused dispatch where the config
asks for it, as the reference scopes it; ``exact_moe`` gives every MoE
block full capacity.  The units' parameters are stacked one unit at a
time into preallocated leaves, so the peak of an init is the model and one
unit, not twice the model.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree_util as T
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(keys: L.Keys, cfg: ArchConfig, kind: str, dtype,
               dense_override: bool = False) -> dict:
    """One block's parameters; ``dense_override`` builds the lead dense
    layer of an otherwise-MoE config."""
    dev = keys.device
    k1, k2 = keys.split(2)
    p: dict[str, Any] = {"ln1": L.norm_init(cfg.norm_kind, cfg.d_model, dev),
                         "ln2": L.norm_init(cfg.norm_kind, cfg.d_model, dev)}
    if kind in ("dense", "local", "moe"):
        p["attn"] = (A.mla_init(k1, cfg, dtype) if cfg.attn_kind == "mla"
                     else A.gqa_init(k1, cfg, dtype))
        if kind == "moe" and not dense_override:
            p["moe"] = M.moe_init(k2, cfg, dtype)
        else:
            p["mlp"] = L.mlp_init(k2, cfg.d_model, cfg.d_ff, dtype)
    elif kind == "rwkv":
        p["core"] = W.rwkv_init(k1, cfg, dtype)
    elif kind == "rec":
        p["rec"] = R.rglru_init(k1, cfg, dtype)
        p["mlp"] = L.mlp_init(k2, cfg.d_model, cfg.d_ff, dtype)
    else:
        raise ValueError(kind)
    return p


def block_apply(cfg: ArchConfig, kind: str, params, x, *, mode: str, cache=None, pos=None,
                cache_cap: int = 0, window_override: Optional[int] = None,
                dense_override: bool = False, exact_moe: bool = False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    nk = cfg.norm_kind
    if kind in ("dense", "local", "moe"):
        window = cfg.window if kind == "local" else window_override
        h = L.norm_apply(nk, params["ln1"], x)
        if cfg.attn_kind == "mla":
            a_out, new_cache = A.mla_apply(cfg, params["attn"], h, mode=mode, cache=cache,
                                           pos=pos, cache_cap=cache_cap)
        else:
            a_out, new_cache = A.gqa_apply(cfg, params["attn"], h, mode=mode, cache=cache,
                                           pos=pos, window=window, cache_cap=cache_cap)
        x = x + a_out
        h = L.norm_apply(nk, params["ln2"], x)
        if kind == "moe" and not dense_override:
            # decode always at full capacity; the fused dispatch outside
            # prefill, as the reference scopes it (stack.py:104-108)
            m_out, aux = M.moe_apply(cfg, params["moe"], h, cfg.act,
                                     full_capacity=(mode == "decode") or exact_moe,
                                     fused=cfg.moe_fused_dispatch and mode != "prefill")
        else:
            m_out = L.mlp_apply(params["mlp"], h, cfg.act)
        return x + m_out, new_cache, aux
    if kind == "rwkv":
        cp = params["core"]
        st_tm = None if cache is None else {"tm_last": cache["tm_last"], "s": cache["s"]}
        h = L.norm_apply(nk, params["ln1"], x)
        y, tm_state = W.rwkv_time_mix(cfg, cp, h, mode=mode, state=st_tm)
        x = x + y
        st_cm = None if cache is None else {"cm_last": cache["cm_last"]}
        h = L.norm_apply(nk, params["ln2"], x)
        y, cm_state = W.rwkv_channel_mix(cfg, cp, h, mode=mode, state=st_cm)
        x = x + y
        new_cache = None if mode == "train" else {**tm_state, **cm_state}
        return x, new_cache, aux
    if kind == "rec":
        h = L.norm_apply(nk, params["ln1"], x)
        y, new_cache = R.rglru_apply(cfg, params["rec"], h, mode=mode, state=cache)
        x = x + y
        h = L.norm_apply(nk, params["ln2"], x)
        return x + L.mlp_apply(params["mlp"], h, cfg.act), new_cache, aux
    raise ValueError(kind)


def block_cache_shape(cfg: ArchConfig, kind: str, batch: int, cap: int, dtype,
                      window_override=None):
    if kind in ("dense", "moe"):
        if cfg.attn_kind == "mla":
            return A.mla_cache_shape(cfg, batch, cap, dtype)
        return A.gqa_cache_shape(cfg, batch, cap, window_override, dtype)
    if kind == "local":
        return A.gqa_cache_shape(cfg, batch, cap, cfg.window, dtype)
    if kind == "rwkv":
        return W.rwkv_state_shape(cfg, batch, dtype)
    if kind == "rec":
        return R.rglru_state_shape(cfg, batch, dtype)
    raise ValueError(kind)


def block_cache_spec(cfg: ArchConfig, kind: str, window_override=None):
    """Logical axes of ``block_cache_shape``'s leaves (the reference's
    sharding input; carried, not used, on one card)."""
    if kind in ("dense", "moe"):
        if cfg.attn_kind == "mla":
            return A.mla_cache_spec()
        return A.gqa_cache_spec(window_override)
    if kind == "local":
        return A.gqa_cache_spec(cfg.window)
    if kind == "rwkv":
        return W.rwkv_state_spec()
    if kind == "rec":
        return R.rglru_state_spec()
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# layer grouping
# ---------------------------------------------------------------------------

def layer_plan(cfg: ArchConfig):
    """(n_lead, n_units, tail_kinds)."""
    lead = cfg.first_dense_layers
    rest = cfg.n_layers - lead
    return lead, rest // cfg.pattern_len, cfg.block_pattern[: rest % cfg.pattern_len]


def _stack(trees):
    return T.tmap(lambda *xs: torch.stack(xs), *trees)


def _stack_units(make, n: int):
    """The trees ``make(0) .. make(n - 1)`` stacked along a new leading dim,
    made one at a time into preallocated leaves (each unit freed once it is
    copied); one unit is a view of itself with a unit dim, no copy."""
    first = make(0)
    if n == 1:
        return T.tmap(lambda t: t[None], first)
    out = T.tmap(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for ui in range(n):
        unit = first if ui == 0 else make(ui)
        for dst, src in zip(T.leaves(out), T.leaves(unit)):
            dst[ui].copy_(src)
        first = unit = None
    return out


def stack_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    """The reference's key tree: split 3 ways, the lead blocks (dense
    overrides of the pattern's first kind) on splits of the first, unit u's
    block b on fold_in(split u of the second, b), tail block b on
    fold_in(the third, b)."""
    lead, n_units, tail = layer_plan(cfg)
    k_lead, k_units, k_tail = keys.split(3)
    p: dict[str, Any] = {}
    if lead:
        p["lead"] = [block_init(kk, cfg, cfg.block_pattern[0], dtype, dense_override=True)
                     for kk in k_lead.split(lead)]
    if n_units:
        unit_keys = k_units.split(n_units)
        p["units"] = _stack_units(
            lambda ui: {f"b{bi}": block_init(unit_keys[ui].fold_in(bi), cfg, kind, dtype)
                        for bi, kind in enumerate(cfg.block_pattern)}, n_units)
    if tail:
        p["tail"] = [block_init(k_tail.fold_in(bi), cfg, kind, dtype)
                     for bi, kind in enumerate(tail)]
    return p


def _write_back(dst, src) -> None:
    """Copy each leaf of ``src`` into the slice ``dst`` of a stacked cache,
    unless it already is that slice (an in-place KV write)."""
    for d, s in zip(T.leaves(dst), T.leaves(src)):
        if s.data_ptr() != d.data_ptr():
            d.copy_(s)


def stack_apply(cfg: ArchConfig, params, x, *, mode: str, cache=None, pos=None,
                cache_cap: int = 0, window_override: Optional[int] = None,
                exact_moe: bool = False):
    """Returns (x, new_cache, aux_sum).  Cache layout: {"lead": list,
    "units": stacked tree, "tail": list}, entries omitted when empty."""
    lead, n_units, tail = layer_plan(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict[str, Any] = {}
    ba = functools.partial(block_apply, cfg, mode=mode, pos=pos, cache_cap=cache_cap,
                           window_override=window_override, exact_moe=exact_moe)

    if lead:
        caches = []
        for i in range(lead):
            c = None if cache is None else cache["lead"][i]
            x, nc, aux = ba(cfg.block_pattern[0], params["lead"][i], x, cache=c,
                            dense_override=True)
            caches.append(nc)
            aux_total = aux_total + aux
        if mode != "train":
            new_cache["lead"] = caches

    if n_units:
        unit_caches = []
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for ui in range(n_units):
            up = T.tmap(lambda t: t[ui], params["units"])
            uc = None if cache is None else T.tmap(lambda t: t[ui], cache["units"])
            aux_u = torch.zeros((), dtype=torch.float32, device=x.device)
            ncs = {}
            for bi, kind in enumerate(cfg.block_pattern):
                c = None if uc is None else uc[f"b{bi}"]
                x, ncs[f"b{bi}"], aux = ba(kind, up[f"b{bi}"], x, cache=c)
                aux_u = aux_u + aux
            if uc is not None:
                _write_back(uc, ncs)
            else:
                unit_caches.append(ncs)
            aux_sum = aux_sum + aux_u
        if mode == "prefill":
            new_cache["units"] = _stack(unit_caches)
        elif mode == "decode":
            new_cache["units"] = cache["units"]
        aux_total = aux_total + aux_sum

    if tail:
        caches = []
        for bi, kind in enumerate(tail):
            c = None if cache is None else cache["tail"][bi]
            x, nc, aux = ba(kind, params["tail"][bi], x, cache=c)
            caches.append(nc)
            aux_total = aux_total + aux
        if mode != "train":
            new_cache["tail"] = caches

    return x, (new_cache if mode != "train" else None), aux_total


def stack_cache_shapes(cfg: ArchConfig, batch: int, cap: int, dtype, window_override=None):
    """Meta tensors in ``stack_apply``'s cache layout."""
    lead, n_units, tail = layer_plan(cfg)
    out: dict[str, Any] = {}

    def bc(kind):
        return block_cache_shape(cfg, kind, batch, cap, dtype, window_override)

    if lead:
        out["lead"] = [bc(cfg.block_pattern[0]) for _ in range(lead)]
    if n_units:
        unit = {f"b{bi}": bc(kind) for bi, kind in enumerate(cfg.block_pattern)}
        out["units"] = T.tmap(lambda t: t.new_empty((n_units,) + tuple(t.shape)), unit)
    if tail:
        out["tail"] = [bc(kind) for kind in tail]
    return out


def stack_cache_specs(cfg: ArchConfig, window_override=None):
    """Logical axes in ``stack_cache_shapes``' layout, the unit dim
    prefixed."""
    lead, n_units, tail = layer_plan(cfg)
    out: dict[str, Any] = {}

    def bs(kind):
        return block_cache_spec(cfg, kind, window_override)

    if lead:
        out["lead"] = [bs(cfg.block_pattern[0]) for _ in range(lead)]
    if n_units:
        out["units"] = {f"b{bi}": {name: ("unit",) + axes for name, axes in bs(kind).items()}
                        for bi, kind in enumerate(cfg.block_pattern)}
    if tail:
        out["tail"] = [bs(kind) for kind in tail]
    return out
