"""Exact PDMM on the centralised (star) graph, eqs. (14)-(15), ported from
``src/repro/core/pdmm.py``:

    clients:  x_i^{r+1}       = argmin_x f_i(x) + rho/2 ||x - x_s^r + lam_{s|i}^r/rho||^2
              lam_{i|s}^{r+1} = rho (x_s^r - x_i^{r+1}) - lam_{s|i}^r
    server:   x_s^{r+1}       = mean_i (x_i^{r+1} - lam_{i|s}^{r+1}/rho)
              lam_{s|i}^{r+1} = rho (x_i^{r+1} - x_s^{r+1}) - lam_{i|s}^{r+1}

It needs a stacked prox oracle (closed form for the paper's least squares:
``LeastSquares.make_client_prox``) and has no kernel: every step is plain
tensor ops.  With rho = 1/gamma and z_{s|i} = x_s - gamma lam_{s|i} its
iterates are exact FedSplit's (paper SIII-B).
"""
from __future__ import annotations

from functools import partial

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import tree_util as T
from repro_torch.core.api import FedOpt, resolved_rho
from repro_torch.core.gpdmm import round_counter


def _round(cfg: FederatedConfig, state, prox_fn, batch=None, per_step_batches=False):
    del batch, per_step_batches
    rho = resolved_rho(cfg)
    x_s, lam_s = state["x_s"], state["lam_s"]

    v = T.tmap(lambda s, l: s[None] - l / T.weak(rho, l), x_s, lam_s)
    x_i = prox_fn(v, rho)  # prox_fn maps the stacked client dim itself
    lam_is = T.tmap(lambda s, x, l: T.weak(rho, s) * (s[None] - x) - l, x_s, x_i, lam_s)
    uplink = T.tmap(lambda x, l: x - l / T.weak(rho, l), x_i, lam_is)
    x_s_new = T.tree_client_mean(uplink)
    lam_s_new = T.tmap(lambda x, s, l: T.weak(rho, x) * (x - s[None]) - l, x_i, x_s_new, lam_is)

    new_state = {"x_s": x_s_new, "lam_s": lam_s_new, "round": state["round"] + 1}
    return new_state, {"lam_sum_norm": T.tree_norm(T.tree_client_sum(lam_s_new))}


def make_exact(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        return {
            "x_s": params,
            "lam_s": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params),
            "round": round_counter(params),
        }

    return FedOpt(
        name="pdmm_exact",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
