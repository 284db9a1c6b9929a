"""AGPDMM (Algorithm 2, Zhang et al. 2021), ported from
``src/repro/core/agpdmm.py`` (full participation, star network), on the
flat client arena and on the per-leaf pytree path.

It differs from GPDMM in two places: every client starts the round from
the fresh server iterate x_s^r (no primal carry is stored), and the dual
update uses the last iterate x_i^{r,K} (eq. 24).  The inner loops and the
round tails are GPDMM's.  With K = 1 and rho = 1/eta the round is gradient
descent with stepsize eta (paper eq. (27)).
"""
from __future__ import annotations

from functools import partial

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.core.api import FedOpt, require_ported, resolved_rho, use_arena
from repro_torch.core.gpdmm import (
    arena_metrics, arena_tail, broadcast_rows, inner_steps, inner_steps_arena,
    round_counter, tree_metrics, tree_tail,
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
        rho=rho, per_step=per_step_batches,
        vr_snapshot=x0 if cfg.variance_reduction == "svrg" else None)

    _, uplink = ops.round_tail(x_K, lam, x_s_row, rho, with_lam_is=False)
    x_s_new, lam_s_new = arena_tail(cfg, uplink)
    new_state = {
        "x_s": spec.unpack(x_s_new),
        "lam_s": lam_s_new,
        "round": state["round"] + 1,
    }
    return new_state, arena_metrics(lam_s_new, x_K, x_s_row)


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches)
    rho = resolved_rho(cfg)
    x_s, lam_s = T.tree_dense(state["x_s"]), state["lam_s"]
    x_s_b = T.tree_broadcast(x_s, T.leaves(lam_s)[0].shape[0])  # the client init

    x_K, _ = inner_steps(
        grad_fn, x_s_b, x_s, lam_s, batch, K=cfg.inner_steps, eta=cfg.eta, rho=rho,
        per_step=per_step_batches,
        vr_snapshot=x_s_b if cfg.variance_reduction == "svrg" else None)
    _, x_s_new, lam_s_new = tree_tail(x_K, x_s, lam_s, rho)
    new_state = {"x_s": x_s_new, "lam_s": lam_s_new, "round": state["round"] + 1}
    return new_state, tree_metrics(lam_s_new, x_K, x_s)


def make(cfg: FederatedConfig) -> FedOpt:
    require_ported(cfg)

    def init(params, m):
        if not use_arena(cfg, params):
            return {
                "x_s": params,
                "lam_s": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params),
                "round": round_counter(params),
            }
        spec = arena.ArenaSpec.from_tree(params)
        device = spec.pack(params).device
        return {
            "x_s": params,
            "lam_s": arena.zeros(spec, m, device=device),
            "round": round_counter(params),
        }

    return FedOpt(
        name="agpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
