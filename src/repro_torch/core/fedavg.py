"""FedAvg (McMahan et al. 2017), the weakest baseline of the paper's
experiments: K local gradient steps from the server iterate and parameter
averaging, with no dual or control state, so it drifts under client
heterogeneity when K > 1 (paper Fig. 2).  Ported from
``src/repro/core/fedavg.py`` (full participation, star network; without the
``u_hat`` cache, which only EF21 and partial participation need).

On the arena the K steps are SCAFFOLD's loop without the correction: one
``inner_loop_affine`` kernel (no lam, rho = 0) for an affine oracle, else
one ``fused_update_arena`` kernel per step; the tail is the uplink mean.  On
the pytree path each step is one ``fused_update`` kernel per leaf.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.core.api import FedOpt, eta_val, require_ported, use_arena
from repro_torch.core.gpdmm import arena_drift, broadcast_rows, round_counter
from repro_torch.core.scaffold import inner_steps_plain, inner_steps_plain_arena


def _num_clients(batch, per_step_batches) -> int:
    """FedAvg keeps no per-client state, so the client count comes from the
    batch layout, (m, ...) or (K, m, ...)."""
    b0 = T.leaves(batch)[0]
    return b0.shape[1] if per_step_batches else b0.shape[0]


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches):
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    m = _num_clients(batch, per_step_batches)
    x_s_row = spec.pack(state["x_s"])
    x0 = broadcast_rows(x_s_row, m)

    x_K = inner_steps_plain_arena(
        spec, grad_fn, x0, x_s_row, batch, K=cfg.inner_steps, eta=cfg.eta,
        per_step=per_step_batches)
    x_s_new = torch.mean(x_K, dim=0)  # the round's single all-reduce
    new_state = {"x_s": spec.unpack(x_s_new), "round": state["round"] + 1}
    metrics = {
        "client_drift": arena_drift(x_K, x_s_row),
        "used_arena": torch.ones((), dtype=torch.float32, device=x_K.device),
    }
    return new_state, metrics


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches)
    x_s = state["x_s"]
    m = _num_clients(batch, per_step_batches)
    eta = eta_val(cfg.eta, T.leaves(x_s)[0].device)
    x_K = inner_steps_plain(grad_fn, T.tree_broadcast(x_s, m), batch, K=cfg.inner_steps,
                            eta=eta, per_step=per_step_batches)

    new_state = {"x_s": T.tree_client_mean(x_K), "round": state["round"] + 1}
    metrics = {
        "client_drift": T.tree_client_drift(x_K, x_s),
        "used_arena": torch.zeros((), dtype=torch.float32, device=T.leaves(x_K)[0].device),
    }
    return new_state, metrics


def make(cfg: FederatedConfig) -> FedOpt:
    require_ported(cfg)

    def init(params, m):
        del m  # no per-client state without the u_hat cache
        return {"x_s": params, "round": round_counter(params)}

    return FedOpt(
        name="fedavg",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
