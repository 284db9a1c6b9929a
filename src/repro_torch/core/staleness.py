"""The bounded-staleness async round engine, ported from
``src/repro/core/staleness.py`` (``docs/async.md``): a delayed client's
uplink is kept in flight instead of thrown away, stored the round it was
produced, delivered ``s`` rounds later and admitted into the server mean
with weight ``stale_gamma ** s`` when ``s <= max_staleness``.

State (one in-flight slot per client, inside the round state):

    stale_buf  (m, W) arena | stacked tree -- the buffered uplink rows
    stale_age  (m,) int32 -- rounds the slot has been in flight; -1 = empty
    stale_lat  (m,) int32 -- the slot's drawn lateness; 0 = empty

Per round (integer bookkeeping, the same on both layouts):

    occ      = age >= 0
    age'     = occ ? age + 1 : age
    arriving = occ & (age' >= lat)
    admit    = arriving & (lat <= max_staleness)
    w        = admit ? stale_gamma ** lat : 0      (f32 pow)
    store    = delayed & (~occ | arriving)         (a busy slot drops the
                                                    new delayed uplink)

A delayed client's own state keeps the silence contract: only its uplink
travels late, so the fresh mask excludes delayed rows.  With
``max_staleness=0`` nothing is ever admitted (lateness >= 1) and the
``w > 0`` guard of ``ops.stale_mix`` (kernel 12) returns the masked select
bitwise, so the async round equals the synchronous masked round bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena as arena_mod
from repro_torch.core import tree_util as T
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import ops

# the state keys this engine owns, merged into every algorithm's init
# when faults.async_on
STATE_KEYS = ("stale_buf", "stale_age", "stale_lat")


def _slots(m: int, device) -> dict:
    return {"stale_age": torch.full((m,), -1, dtype=torch.int32, device=device),
            "stale_lat": torch.zeros(m, dtype=torch.int32, device=device)}


def init_arena(spec, m: int, device) -> dict:
    """Empty stale slots for the packed arena layout."""
    return {"stale_buf": arena_mod.zeros(spec, m, device=device)} | _slots(m, device)


def init_tree(params, m: int) -> dict:
    """Empty stale slots for the per-leaf pytree layout."""
    dev = T.leaves(params)[0].device
    return {"stale_buf": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params)} | _slots(
        m, dev)


def _schedule(cfg: FederatedConfig, fplan: FaultPlan, age, lat):
    """The round's slot bookkeeping (module docstring).  Returns
    (store, w, arriving, admit, age_new, lat_new)."""
    occ = age >= 0
    age_t = torch.where(occ, age + 1, age)
    arriving = occ & (age_t >= lat)
    admit = arriving & (lat <= cfg.max_staleness)
    gamma = torch.full((), float(np.float32(cfg.stale_gamma)), dtype=torch.float32,
                       device=age.device)
    w = torch.where(admit, torch.pow(gamma, lat.to(torch.float32)), 0.0)
    store = fplan.delayed & (~occ | arriving)
    age_new = torch.where(store, 0, torch.where(arriving, -1, age_t)).to(torch.int32)
    lat_new = torch.where(store, fplan.lateness, torch.where(arriving, 0, lat)).to(torch.int32)
    return store, w, arriving, admit, age_new, lat_new


def fresh_mask(mask, fplan: FaultPlan):
    """The round's fresh-uplink mask: the combined participation, fault and
    screen mask without the delayed clients (their uplink is in flight)."""
    alive = ~fplan.delayed
    return alive if mask is None else mask & alive


def stale_metrics(store, arriving, admit) -> dict:
    """Stale-slot counters, f32 scalars."""
    f32 = torch.float32
    return {
        "stale_buffered": torch.sum(store.to(f32)),
        "stale_admitted": torch.sum(admit.to(f32)),
        "stale_dropped": torch.sum((arriving & ~admit).to(f32)),
    }


def step_arena(cfg: FederatedConfig, fplan: FaultPlan, uplink, cache, mask, state):
    """One async step over the arena: ``uplink`` the (m, W) transmitted rows,
    ``cache`` the (m, W) ``u_hat`` or SCAFFOLD's (W,) server row, ``mask``
    the combined silence/screen mask.  Returns (mixed, fresh, state
    updates, metrics): ``mixed`` enters the server mean (and the cache),
    ``fresh`` is the active mask for the carry selects.  One ``stale_mix``
    kernel; the mix reads the old buffer, so an arrival and a new store in
    one slot compose in the one pass."""
    age, lat, buf = state["stale_age"], state["stale_lat"], state["stale_buf"]
    store, w, arriving, admit, age_new, lat_new = _schedule(cfg, fplan, age, lat)
    fresh = fresh_mask(mask, fplan)
    mixed, buf_new = ops.stale_mix(uplink, cache, buf, fresh, store, w)
    updates = {"stale_buf": buf_new, "stale_age": age_new, "stale_lat": lat_new}
    return mixed, fresh, updates, stale_metrics(store, arriving, admit)


def step_tree(cfg: FederatedConfig, fplan: FaultPlan, uplink, cache, mask, state):
    """``step_arena`` over stacked client trees, as plain tensor code (the
    reference's): the mix per leaf with the f32-and-guard arithmetic of
    ``ops.stale_mix``'s plain version."""
    age, lat, buf = state["stale_age"], state["stale_lat"], state["stale_buf"]
    store, w, arriving, admit, age_new, lat_new = _schedule(cfg, fplan, age, lat)
    fresh = fresh_mask(mask, fplan)
    base = T.tree_select(fresh, uplink, cache)

    def mix_leaf(b, s):
        shape = (-1,) + (1,) * (b.ndim - 1)
        wk = w.reshape(shape)
        bf = b.to(torch.float32)
        mixf = bf + wk * (s.to(torch.float32) - bf)
        return torch.where(wk > 0, mixf.to(b.dtype), b)

    mixed = T.tmap(mix_leaf, base, buf)
    buf_new = T.tree_select(store, uplink, buf)
    updates = {"stale_buf": buf_new, "stale_age": age_new, "stale_lat": lat_new}
    return mixed, fresh, updates, stale_metrics(store, arriving, admit)


__all__ = ["STATE_KEYS", "fresh_mask", "init_arena", "init_tree", "stale_metrics",
           "step_arena", "step_tree"]
