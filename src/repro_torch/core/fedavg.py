"""FedAvg (McMahan et al. 2017), the weakest baseline of the paper's
experiments: K local gradient steps from the server iterate and parameter
averaging, with no dual or control state, so it drifts under client
heterogeneity when K > 1 (paper Fig. 2).  Ported from
``src/repro/core/fedavg.py`` (star network).  Plain FedAvg keeps no
per-client state; EF21 and partial participation add GPDMM's ``u_hat``
cache of each client's uplink (silent clients' cached uplink enters the
mean), and on the arena ``cohort="auto"`` runs the round over the sampled
cohort only, scattering its uplink into the cache.  Faults, screening and
async rounds run GPDMM's pipeline on the uplink x_K (``cached_uplink``,
``cohort_cache``) against the same cache.

On the arena the K steps are SCAFFOLD's loop without the correction: one
``inner_loop_affine`` kernel (no lam, rho = 0) for an affine oracle, else
one ``fused_update_arena`` kernel per step; the tail is the uplink mean.  On
the pytree path each step is one ``fused_update`` kernel per leaf.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, faults, staleness
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, cohort_batch, eta_val, run_cohort_inner, use_arena, use_cohort,
)
from repro_torch.core.gpdmm import (
    arena_drift, broadcast_rows, cached_uplink, cohort_cache, cohort_eta, needs_cache,
    round_cohort, round_counter,
)
from repro_torch.core.scaffold import inner_steps_plain, inner_steps_plain_arena


def _num_clients(state, batch, per_step_batches) -> int:
    """Plain FedAvg keeps no per-client state, so the client count comes
    from the batch layout, (m, ...) or (K, m, ...); with the ``u_hat``
    cache it is the cache's."""
    if "u_hat" in state:
        return T.leaves(state["u_hat"])[0].shape[0]
    b0 = T.leaves(batch)[0]
    return b0.shape[1] if per_step_batches else b0.shape[0]


def _arena_metrics(x_K, x_s_row, mask=None):
    return {
        "client_drift": arena_drift(x_K, x_s_row, mask),
        "used_arena": torch.ones((), dtype=torch.float32, device=x_K.device),
    }


def _round_arena_cohort(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches):
    """FedAvg over the round's sampled cohort: no optimiser rows move; the
    cohort runs the K plain steps from the server row and its uplink is
    scattered into the ``u_hat`` cache, whose mean is the new server
    iterate (the masked round's mean of selected rows)."""
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    u_hat = state["u_hat"]
    m = u_hat.shape[0]
    x_s_row = spec.pack(state["x_s"])
    idx = round_cohort(cfg, state, m)
    batch_c = cohort_batch(batch, idx, m, per_step_batches)
    eta_c = cohort_eta(cfg, idx)

    def inner(rows, b):
        mc = T.leaves(b)[0].shape[1 if per_step_batches else 0]
        return inner_steps_plain_arena(
            spec, grad_fn, broadcast_rows(x_s_row, mc), x_s_row, b, K=cfg.inner_steps,
            eta=cfg.eta if eta_c is None else rows[0], per_step=per_step_batches)

    rows = () if eta_c is None else (eta_c,)
    x_K = run_cohort_inner(cfg, inner, rows, batch_c, per_step=per_step_batches)

    u_hat_new, keep_c, fm = cohort_cache(cfg, spec, state, x_K, idx, x_s_row)
    x_s_new = torch.mean(u_hat_new, dim=0)  # the round's single all-reduce
    new_state = {"u_hat": u_hat_new, "x_s": spec.unpack(x_s_new),
                 "round": state["round"] + 1}
    return new_state, _arena_metrics(x_K, x_s_row, keep_c) | fm


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches):
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    m = _num_clients(state, batch, per_step_batches)
    if use_cohort(cfg, m):
        return _round_arena_cohort(cfg, state, grad_fn, batch, per_step_batches)
    x_s_row = spec.pack(state["x_s"])
    x0 = broadcast_rows(x_s_row, m)

    x_K = inner_steps_plain_arena(
        spec, grad_fn, x0, x_s_row, batch, K=cfg.inner_steps, eta=cfg.eta,
        per_step=per_step_batches)
    uplink, mask, new_state, fm = cached_uplink(cfg, state, x_K, m, x_s_row, spec)
    if "u_hat" in state:
        new_state["u_hat"] = uplink
    x_s_new = torch.mean(uplink, dim=0)  # the round's single all-reduce
    new_state |= {"x_s": spec.unpack(x_s_new), "round": state["round"] + 1}
    return new_state, _arena_metrics(x_K, x_s_row, mask) | fm


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches)
    x_s = state["x_s"]
    m = _num_clients(state, batch, per_step_batches)
    eta = eta_val(cfg.eta, T.leaves(x_s)[0].device)
    x_K = inner_steps_plain(grad_fn, T.tree_broadcast(x_s, m), batch, K=cfg.inner_steps,
                            eta=eta, per_step=per_step_batches)

    uplink, mask, new_state, fm = cached_uplink(cfg, state, x_K, m, x_s)
    if "u_hat" in state:
        new_state["u_hat"] = uplink
    new_state |= {"x_s": T.tree_client_mean(uplink), "round": state["round"] + 1}
    metrics = {
        "client_drift": T.tree_client_drift(x_K, x_s, mask),
        "used_arena": torch.zeros((), dtype=torch.float32, device=T.leaves(x_K)[0].device),
    }
    return new_state, metrics | fm


def make(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        st = {"x_s": params, "round": round_counter(params)}
        on_arena = use_arena(cfg, params)
        spec = arena.ArenaSpec.from_tree(params) if on_arena else None
        if needs_cache(cfg):
            # the server's cached view of each client's uplink: x_s, the
            # round-0 uplink of a client that never moved
            if on_arena:
                st["u_hat"] = broadcast_rows(spec.pack(params), m)
            else:
                st["u_hat"] = T.tree_broadcast(params, m)
        if faults.async_on(cfg):
            st |= (staleness.init_arena(spec, m, T.leaves(params)[0].device) if on_arena
                   else staleness.init_tree(params, m))
        return st

    return FedOpt(
        name="fedavg",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
