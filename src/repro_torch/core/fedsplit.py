"""FedSplit (Pathak & Wainwright 2020), eqs. (16)-(17), and Inexact FedSplit,
eqs. (18)-(19), with the improper client initialisation x_i^{r,0} =
z_{s|i}^r whose failure the paper diagnoses (Fig. 1); ported from
``src/repro/core/fedsplit.py``.

Exact iterates (prox oracle):
    x_i^{r+1}     = prox_{gamma f_i}(z_{s|i}^r)
    z_{i|s}^{r+1} = 2 x_i^{r+1} - z_{s|i}^r
    x_s^{r+1}     = mean_i z_{i|s}^{r+1}
    z_{s|i}^{r+1} = 2 x_s^{r+1} - z_{i|s}^{r+1}

Inexact iterates: K gradient steps on h_i(x) = f_i(x) + ||x - z||^2 /
(2 gamma), from z_{s|i}^r (``fedsplit_init="z"``, the paper's stall) or
from x_s^r (``"xs"``, which converges).  Each step is one ``fused_update``
kernel (lam-free, xs = z, rho = 1/gamma): on the arena over the
``(m, width)`` buffers, on the pytree path once per leaf.

PDMM == FedSplit on the star graph (paper SIII-B): with rho = 1/gamma and
z_{s|i} = x_s - gamma lam_{s|i} the exact iterates coincide with
``core.pdmm``.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, arena_grad, client_batches, n_steps, resolved_rho, use_arena,
)
from repro_torch.core.gpdmm import arena_drift, broadcast_rows, round_counter
from repro_torch.kernels import ops


def _gamma(cfg: FederatedConfig) -> float:
    return cfg.gamma if cfg.gamma is not None else 1.0 / resolved_rho(cfg)


def _reflect(x, z):
    """z_is = 2 x - z, the server mean, and z_s' = 2 x_s' - z_is, per leaf."""
    z_is = T.tmap(lambda a, b: 2.0 * a - b, x, z)
    x_s = T.tree_client_mean(z_is)
    return x_s, T.tmap(lambda s, zi: 2.0 * s[None] - zi, x_s, z_is)


# ---------------------------------------------------------------------------
# exact (prox oracle)
# ---------------------------------------------------------------------------

def _round_exact(cfg: FederatedConfig, state, prox_fn, batch=None, per_step_batches=False):
    """``prox_fn(z, rho)`` maps the stacked client dim itself."""
    del batch, per_step_batches
    z_s = state["z_s"]
    x_i = prox_fn(z_s, 1.0 / _gamma(cfg))
    x_s, z_s_new = _reflect(x_i, z_s)
    return {"x_s": x_s, "z_s": z_s_new, "round": state["round"] + 1}, {}


def make_exact(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        return {
            "x_s": params,
            "z_s": T.tree_broadcast(params, m),  # z_{s|i}^0 = x_s^0 (lam = 0)
            "round": round_counter(params),
        }

    return FedOpt(
        name="fedsplit_exact",
        init=init,
        round=partial(_round_exact, cfg),
        server_params=lambda s: s["x_s"],
    )


# ---------------------------------------------------------------------------
# inexact (K gradient steps, paper eq. (18))
# ---------------------------------------------------------------------------

def _x0(cfg: FederatedConfig, z, x_s_b):
    if cfg.fedsplit_init == "z":
        return z  # the paper's diagnosed improper init
    if cfg.fedsplit_init == "xs":
        return x_s_b()
    raise ValueError(cfg.fedsplit_init)


def _round_inexact_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches):
    gamma = _gamma(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    z = state["z_s"]  # arena-resident (m, width)
    x_s_row = spec.pack(state["x_s"])
    grad_a, _native = arena_grad(grad_fn, spec)

    x = _x0(cfg, z, lambda: broadcast_rows(x_s_row, z.shape[0]))
    for k in range(n_steps(batch, cfg.inner_steps, per_step_batches)):
        g = grad_a(x, client_batches(batch, k, per_step_batches))
        # grad h = grad f + (x - z)/gamma: the lam-free step, rho = 1/gamma,
        # through kernel 6 on the (m, width) buffers (as the reference)
        x = ops.fused_update(x, g, z, None, cfg.eta, 1.0 / gamma)
    x_K = x

    x_s_new, z_s_new = _reflect(x_K, z)
    new_state = {"x_s": spec.unpack(x_s_new), "z_s": z_s_new, "round": state["round"] + 1}
    return new_state, {"client_drift": arena_drift(x_K, x_s_row),
                       "used_arena": torch.ones((), dtype=torch.float32, device=z.device)}


def _round_inexact(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False):
    if use_arena(cfg, state["x_s"]):
        return _round_inexact_arena(cfg, state, grad_fn, batch, per_step_batches)
    gamma = _gamma(cfg)
    z_s, x_s = state["z_s"], state["x_s"]
    m = T.leaves(z_s)[0].shape[0]
    vgrad = torch.func.vmap(grad_fn)

    x = _x0(cfg, z_s, lambda: T.tree_broadcast(x_s, m))
    for k in range(n_steps(batch, cfg.inner_steps, per_step_batches)):
        g = T.tree_dense(vgrad(x, client_batches(batch, k, per_step_batches)))
        x = T.tmap(lambda xx, gg, zz: ops.fused_update(xx, gg, zz, None, cfg.eta, 1.0 / gamma),
                   x, g, z_s)
    x_K = x

    x_s_new, z_s_new = _reflect(x_K, z_s)
    new_state = {"x_s": x_s_new, "z_s": z_s_new, "round": state["round"] + 1}
    metrics = {
        "client_drift": T.tree_client_drift(x_K, x_s),
        "used_arena": torch.zeros((), dtype=torch.float32, device=T.leaves(x_K)[0].device),
    }
    return new_state, metrics


def make_inexact(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        if use_arena(cfg, params):
            spec = arena.ArenaSpec.from_tree(params)
            z = broadcast_rows(spec.pack(params), m)
        else:
            z = T.tree_broadcast(params, m)
        return {"x_s": params, "z_s": z, "round": round_counter(params)}

    return FedOpt(
        name=f"fedsplit_inexact[{cfg.fedsplit_init}]",
        init=init,
        round=partial(_round_inexact, cfg),
        server_params=lambda s: s["x_s"],
    )
