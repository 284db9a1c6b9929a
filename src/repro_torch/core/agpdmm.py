"""AGPDMM (Algorithm 2, Zhang et al. 2021), ported from
``src/repro/core/agpdmm.py`` (star network), on the flat client arena and
on the per-leaf pytree path, with GPDMM's partial participation, cohort
engine and EF21 uplink.

It differs from GPDMM in two places: every client starts the round from
the fresh server iterate x_s^r (no primal carry is stored), and the dual
update uses the last iterate x_i^{r,K} (eq. 24).  The inner loops and the
round tails are GPDMM's (``arena_tail``, two passes over the arena),
faults, screening and async rounds included.
With K = 1 and rho = 1/eta the round is gradient descent with stepsize eta
(paper eq. (27)).  The inner loops keep no x_bar, which AGPDMM never
reads.  The cohort round moves no
primal carry: it gathers ``lam_s`` (and, with EF21 or faults, ``u_hat``)
rows in one launch and scatters ``u_hat``'s, in place when donated
(``FedOpt.round_``), before GPDMM's ``cohort_server``.
"""
from __future__ import annotations

from functools import partial

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, faults, staleness
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, cohort_batch, owned, resolved_rho, run_cohort_inner, scatter_cohort, use_arena,
    use_cohort,
)
from repro_torch.core.gpdmm import (
    arena_metrics, arena_tail, broadcast_rows, cohort_cache, cohort_eta, cohort_reads_cache,
    cohort_server, inner_steps, inner_steps_arena, needs_cache, popstore_metrics, popstore_tail,
    round_cohort, round_counter, tree_metrics, tree_tail,
)
from repro_torch.kernels import ops


def cohort_loop(cfg: FederatedConfig, spec, grad_fn, x_s_row, lam_c, batch_c, idx,
                per_step: bool):
    """The cohort's K client steps from the fresh server row with dual rows
    ``lam_c`` (tiled by ``cohort_tile``), shared by the device cohort round
    and the popstore body.  Returns x_K."""
    rho = resolved_rho(cfg)
    eta_c = cohort_eta(cfg, idx)

    def inner(rows, b):
        lam_t = rows[0]
        x0 = broadcast_rows(x_s_row, lam_t.shape[0])
        return inner_steps_arena(
            spec, grad_fn, x0, x_s_row, lam_t, b, K=cfg.inner_steps,
            eta=cfg.eta if eta_c is None else rows[1], rho=rho,
            per_step=per_step,
            vr_snapshot=x0 if cfg.variance_reduction == "svrg" else None, with_bar=False)

    rows = (lam_c,) + (() if eta_c is None else (eta_c,))
    x_K, _ = run_cohort_inner(cfg, inner, rows, batch_c, per_step=per_step)
    return x_K


def _round_arena_cohort(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches,
                        donate=False):
    """AGPDMM over the round's sampled cohort (see gpdmm): the client init
    is the fresh server row, so only the cohort's lam rows (and its cached
    uplink rows when the uplink reads them) are gathered, and only u_hat's
    are scattered back."""
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    if donate:
        state = owned(state, ("u_hat",))
    lam, u_hat = state["lam_s"], state["u_hat"]
    m = lam.shape[0]
    x_s_row = spec.pack(state["x_s"])
    idx = round_cohort(cfg, state, m)
    lam_c, *u_hat_c = ops.row_gather_buffers(
        (lam,) + ((u_hat,) if cohort_reads_cache(cfg) else ()), idx)
    batch_c = cohort_batch(batch, idx, m, per_step_batches)
    x_K = cohort_loop(cfg, spec, grad_fn, x_s_row, lam_c, batch_c, idx, per_step_batches)

    _, uplink = ops.round_tail(x_K, lam_c, x_s_row, rho, with_lam_is=False)
    uplink, keep_c, fm = cohort_cache(cfg, spec, state, uplink, idx, x_s_row,
                                      u_hat_c[0] if u_hat_c else None)
    u_hat_new, = scatter_cohort((u_hat,), idx, (uplink,), donate=donate)
    server, lam_sum = cohort_server(cfg, spec, u_hat_new)
    new_state = server | {"round": state["round"] + 1}
    return new_state, arena_metrics(lam_sum, x_K, x_s_row, keep_c) | fm


def popstore_body(cfg: FederatedConfig, spec, m: int, grad_fn, per_step):
    """The device half of a host-popstore AGPDMM round (see
    ``gpdmm.popstore_body``): only the ``u_hat`` rows stage -- the client
    init is the fresh server row (no primal carry) -- and the dual rows are
    rebuilt lazily from them, lam_{s|i} = rho (u_hat_i - x_s)."""
    rho = resolved_rho(cfg)

    def body(server, staged, idx, round_idx, batch):
        x_s_row = spec.pack(server["x_s"])
        u_hat_c = staged["u_hat"]
        lam_c = ops.dual_from_uplink(u_hat_c, x_s_row, rho)  # the lazy dual
        batch_c = cohort_batch(batch, idx, m, per_step)
        x_K = cohort_loop(cfg, spec, grad_fn, x_s_row, lam_c, batch_c, idx, per_step)
        _, uplink = ops.round_tail(x_K, lam_c, x_s_row, rho, with_lam_is=False)
        uplink, keep_c, fm = popstore_tail(cfg, spec, x_s_row, u_hat_c, uplink, idx,
                                           round_idx, m)
        return {"u_hat": uplink}, {}, popstore_metrics(x_K, x_s_row, keep_c) | fm

    return body


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches, donate):
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    lam = state["lam_s"]
    m = lam.shape[0]
    if use_cohort(cfg, m):
        return _round_arena_cohort(cfg, state, grad_fn, batch, per_step_batches, donate)
    x_s_row = spec.pack(state["x_s"])
    x0 = broadcast_rows(x_s_row, m)

    x_K, _ = inner_steps_arena(
        spec, grad_fn, x0, x_s_row, lam, batch, K=cfg.inner_steps, eta=cfg.eta,
        rho=rho, per_step=per_step_batches,
        vr_snapshot=x0 if cfg.variance_reduction == "svrg" else None, with_bar=False)

    _, new_state, x_s_new, lam_s_new, lam_sum, mask, fm = arena_tail(
        cfg, spec, state, x_K, lam, m, x_s_row)
    new_state |= {
        "x_s": spec.unpack(x_s_new),
        "lam_s": lam_s_new,
        "round": state["round"] + 1,
    }
    return new_state, arena_metrics(lam_sum, x_K, x_s_row, mask) | fm


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False, *,
           donate=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches, donate)
    rho = resolved_rho(cfg)
    x_s, lam_s = T.tree_dense(state["x_s"]), state["lam_s"]
    m = T.leaves(lam_s)[0].shape[0]
    x_s_b = T.tree_broadcast(x_s, m)  # the client init

    x_K, _ = inner_steps(
        grad_fn, x_s_b, x_s, lam_s, batch, K=cfg.inner_steps, eta=cfg.eta, rho=rho,
        per_step=per_step_batches,
        vr_snapshot=x_s_b if cfg.variance_reduction == "svrg" else None, with_bar=False)
    _, new_state, mask, fm = tree_tail(cfg, state, x_K, x_s, rho, m)
    new_state["round"] = state["round"] + 1
    return new_state, tree_metrics(new_state["lam_s"], x_K, x_s, mask) | fm


def make(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        if not use_arena(cfg, params):
            st = {
                "x_s": params,
                "lam_s": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params),
                "round": round_counter(params),
            }
            if needs_cache(cfg):
                st["u_hat"] = T.tree_broadcast(params, m)
            if faults.async_on(cfg):
                st |= staleness.init_tree(params, m)
            return st
        spec = arena.ArenaSpec.from_tree(params)
        row = spec.pack(params)
        st = {
            "x_s": params,
            "lam_s": arena.zeros(spec, m, device=row.device),
            "round": round_counter(params),
        }
        if needs_cache(cfg):
            st["u_hat"] = broadcast_rows(row, m)
        if faults.async_on(cfg):
            st |= staleness.init_arena(spec, m, row.device)
        return st

    return FedOpt(
        name="agpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
        round_=partial(_round, cfg, donate=True),
    )
