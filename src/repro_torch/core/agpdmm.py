"""AGPDMM (Algorithm 2, Zhang et al. 2021) on the flat client arena, ported
from ``src/repro/core/agpdmm.py`` (full participation, star network).

It differs from GPDMM in two places: every client starts the round from
the fresh server row x_s^r (no primal carry is stored), and the dual update
uses the last iterate x_i^{r,K} (eq. 24).  The inner loop and the round
tail are GPDMM's.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core.api import (
    FedOpt, pytree_path_unported, require_ported, resolved_rho, use_arena,
)
from repro_torch.core.gpdmm import (
    arena_metrics, arena_tail, broadcast_rows, inner_steps_arena,
)
from repro_torch.kernels import ops


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches):
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    lam = state["lam_s"]
    x_s_row = spec.pack(state["x_s"])
    x0 = broadcast_rows(x_s_row, lam.shape[0])

    x_K, _ = inner_steps_arena(
        spec, grad_fn, x0, x_s_row, lam, batch, K=cfg.inner_steps, eta=cfg.eta,
        rho=rho, per_step=per_step_batches)

    _, uplink = ops.round_tail(x_K, lam, x_s_row, rho, with_lam_is=False)
    x_s_new, lam_s_new = arena_tail(cfg, uplink)
    new_state = {
        "x_s": spec.unpack(x_s_new),
        "lam_s": lam_s_new,
        "round": state["round"] + 1,
    }
    return new_state, arena_metrics(lam_s_new, x_K, x_s_row)


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False):
    if not use_arena(cfg, state["x_s"]):
        raise pytree_path_unported(cfg, state["x_s"])
    return _round_arena(cfg, state, grad_fn, batch, per_step_batches)


def make(cfg: FederatedConfig) -> FedOpt:
    require_ported(cfg)

    def init(params, m):
        if not use_arena(cfg, params):
            raise pytree_path_unported(cfg, params)
        spec = arena.ArenaSpec.from_tree(params)
        device = spec.pack(params).device
        return {
            "x_s": params,
            "lam_s": arena.zeros(spec, m, device=device),
            "round": torch.zeros((), dtype=torch.int32, device=device),
        }

    return FedOpt(
        name="agpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
