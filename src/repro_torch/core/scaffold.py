"""SCAFFOLD (Karimireddy et al. 2020), eqs. (29)-(30) of the paper, the
primary baseline; ported from ``src/repro/core/scaffold.py`` (star
network), on the flat client arena and on the per-leaf pytree path, with
partial participation and the cohort engine.

    x_i^{r,0}   = x_s^r
    x_i^{r,k+1} = x_i^{r,k} - eta (grad f_i(x_i^{r,k}) - c_i^r + c^r)
    c_i^{r+1}   = c_i^r - c^r + (x_s^r - x_i^{r,K}) / (K eta)
    x_s^{r+1}   = x_s^r + eta_g mean_i (x_i^{r,K} - x_s^r)   (all-reduce 1)
    c^{r+1}     = c^r + mean_i (c_i^{r+1} - c_i^r)           (all-reduce 2)

Both directions carry two variables per round (x and c), the contrast the
paper draws with GPDMM's one.  On the arena ``c_i`` is one ``(m, width)``
buffer.  For an affine oracle the correction folds into the affine
constant (``c`` into the constant, ``c_i`` as the kernel's ``off`` row), so
the whole inner loop is one ``inner_loop_affine`` kernel; otherwise each
step is one ``fused_update_arena`` kernel with rho = 0 and lam = c - c_i.
A full-arena round ends in ``scaffold_step``: c_i', both server means and
sum_i (c_i' - c') in two passes over the arena on the card; the cohort and
the async round run one ``scaffold_cv`` kernel and plain means.  On the
pytree path each step is one ``fused_update`` kernel per leaf and the tail
is plain tensor ops, as in the reference.

With participation < 1 silent clients transmit nothing: zero delta on both
server means, ``c_i`` kept.  The cohort round gathers the cohort's ``c_i``
rows, decomposes both means over the cohort's deltas (sum / m) and
scatters the rows back, in place when donated (``FedOpt.round_``).  EF21
uplink quantisation is not offered for SCAFFOLD (``make`` says why).

Faults, as in the reference: the wire corrupts the transmitted x_K, and
both the control-variate refresh and the screen see the corrupted x_t; a demoted or
silent client sends a zero delta and keeps c_i.  Under async rounds the
stale-slot step mixes toward the broadcast server row (``stale_mix`` with a
(W,) cache), and c_i refreshes only on the fresh mask.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, faults, staleness
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, affine_case, arena_grad, client_batches, cohort_batch, eta_val, n_steps, owned,
    run_cohort_inner, scatter_cohort, step_for, use_arena, use_cohort,
)
from repro_torch.core.gpdmm import (
    arena_drift, broadcast_rows, cohort_eta, cohort_fault_report, fault_report, participation,
    popstore_metrics, round_cohort, round_counter,
)
from repro_torch.kernels import ops


def inner_steps_plain_arena(spec, grad_fn, x0, x_s_row, batch, *, K, eta, per_step,
                            c_i=None, c_row=None):
    """K plain gradient steps over the arena, x <- x - eta (grad f_i(x) -
    c_i + c), the correction only with ``c_i``/``c_row`` set (SCAFFOLD;
    FedAvg runs without).  Returns x_K.

    An affine oracle (one batch for all steps) runs one ``inner_loop_affine``
    kernel: grad - c_i + c == H x - ((c_aff - c) + c_i), the server variate
    into the constant and the client variate as the ``off`` row.  Otherwise
    each step is one ``fused_update_arena`` kernel with rho = 0 and
    lam = c - c_i, built once per round.  ``eta`` is a float or the
    per-client tuple."""
    eta = eta_val(eta, x0.device)
    affine = affine_case(grad_fn, spec, per_step=per_step)
    if affine is not None:
        H, c = affine(spec, batch)
        off = None
        if c_i is not None:
            c = c - c_row[None]
            off = c_i
        x_K, _ = ops.inner_loop_affine(x0, H, c, x_s_row, None, eta, 0.0, K, off=off)
        return x_K

    grad_a, _native = arena_grad(grad_fn, spec)
    lam = None if c_i is None else c_row[None] - c_i
    x = x0
    for k in range(n_steps(batch, K, per_step)):
        g = grad_a(x, client_batches(batch, k, per_step))
        x = ops.fused_update_arena(x, g, x_s_row, lam, eta, 0.0)
    return x


def inner_steps_plain(grad_fn, x0, batch, *, K, eta, per_step, lam=None):
    """The per-leaf counterpart: K steps x <- x - eta (grad f_i(x) + lam),
    lam = c - c_i (SCAFFOLD) or none (FedAvg), each one
    ``fused_update_leaves`` launch per step with rho = 0 and x as its own
    server leaf (read once).  x0 and lam are stacked trees; ``eta`` a float
    or an (m,) tensor.  Returns x_K."""
    vgrad = torch.func.vmap(grad_fn)
    xl = T.leaves(x0)
    laml = [None] * len(xl) if lam is None else T.leaves(lam)
    x = x0
    for k in range(n_steps(batch, K, per_step)):
        g = T.tree_dense(vgrad(x, client_batches(batch, k, per_step)))
        xl = ops.fused_update_leaves(xl, T.leaves(g), xl, laml, eta, 0.0)
        x = T.unflatten(x0, xl)
    return x


def _arena_state(spec, x_s_new, c_new, c_i_new, state, x_K, x_s_row, mask, c_colsum=None):
    """The new arena state and its metrics; ``c_colsum`` is the f32 column
    sum of c_i' - c' where the round has it (``ops.scaffold_step``)."""
    f32 = torch.float32
    if c_colsum is None:
        c_colsum = torch.sum((c_i_new - c_new[None]).to(f32), dim=0)
    new_state = {
        "x_s": spec.unpack(x_s_new),
        "c": spec.unpack(c_new),
        "c_i": c_i_new,
        "round": state["round"] + 1,
    }
    metrics = {
        # invariant: sum_i (c_i - c) = 0 given zero init
        "c_sum_norm": torch.linalg.vector_norm(c_colsum),
        "client_drift": arena_drift(x_K, x_s_row, mask),
        "used_arena": torch.ones((), dtype=f32, device=c_i_new.device),
    }
    return new_state, metrics


def cohort_step(cfg: FederatedConfig, spec, grad_fn, x_s_row, c_row, c_i_c, idx, round_idx,
                m: int, batch_c, per_step: bool):
    """SCAFFOLD's round on the cohort's ``c_i`` rows ``c_i_c``, shared by the
    device cohort round and the popstore body: the offset inner loop,
    ``scaffold_cv`` on the wire's corrupted x_t, the screen and the keep
    select, and both server means as sums of the cohort's deltas over m
    (silent rows send zero).  Returns (c_i' rows, x_s', c', x_K, keep_c,
    fault metrics)."""
    K = cfg.inner_steps
    eta_c = cohort_eta(cfg, idx)

    def inner(rows, b):
        ci_t = rows[0]
        return inner_steps_plain_arena(
            spec, grad_fn, broadcast_rows(x_s_row, ci_t.shape[0]), x_s_row, b, K=K,
            eta=cfg.eta if eta_c is None else rows[1], per_step=per_step,
            c_i=ci_t, c_row=c_row)

    rows = (c_i_c,) + (() if eta_c is None else (eta_c,))
    x_K = run_cohort_inner(cfg, inner, rows, batch_c, per_step=per_step)

    # the wire corrupts the transmitted x_K: both uplinked deltas see it
    fplan = faults.plan(cfg, round_idx, m)
    plan_c = faults.take(fplan, idx)
    x_t = faults.inject(cfg.faults, plan_c, x_K)
    alpha = 1.0 / (K * (cfg.eta if eta_c is None else eta_c))
    c_i_new_c = ops.scaffold_cv(c_i_c, x_t, c_row, x_s_row, alpha)
    keep = faults.screen_keep(cfg, x_t, x_s_row) if faults.screening_on(cfg) else None
    keep_c = faults.combine_mask(None, plan_c, keep)
    if keep_c is not None:
        # demoted or silent cohort rows: zero delta on both means, c_i kept
        c_i_new_c = torch.where(keep_c[:, None], c_i_new_c, c_i_c)
        x_t = torch.where(keep_c[:, None], x_t, x_s_row[None])
    # server: two all-reduces over the cohort's deltas (silent rows are zero)
    f32 = torch.float32
    inv_m = 1.0 / m
    x_s_new = x_s_row + T.weak(cfg.eta_g * inv_m, x_s_row) * torch.sum(
        (x_t - x_s_row[None]).to(f32), dim=0).to(x_s_row.dtype)
    c_new = c_row + T.weak(inv_m, c_row) * torch.sum((c_i_new_c - c_i_c).to(f32), dim=0).to(c_row.dtype)
    return c_i_new_c, x_s_new, c_new, x_K, keep_c, cohort_fault_report(fplan, plan_c, keep)


def _round_arena_cohort(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches,
                        donate=False):
    """SCAFFOLD over the round's sampled cohort: gather the cohort's c_i
    rows, run ``cohort_step`` on them, scatter them back (in place when
    ``donate``).  Silent clients send nothing, so both server means are
    sums of the cohort's deltas over m (equal to the masked round's at f32:
    that one adds the server row into the mean and subtracts it back
    out)."""
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    if donate:
        state = owned(state, ("c_i",))
    c_i = state["c_i"]
    m = c_i.shape[0]
    x_s_row = spec.pack(state["x_s"])
    c_row = spec.pack(state["c"])
    idx = round_cohort(cfg, state, m)
    c_i_c = ops.row_gather(c_i, idx)
    batch_c = cohort_batch(batch, idx, m, per_step_batches)
    c_i_new_c, x_s_new, c_new, x_K, keep_c, fm = cohort_step(
        cfg, spec, grad_fn, x_s_row, c_row, c_i_c, idx, state["round"], m, batch_c,
        per_step_batches)
    c_i_new, = scatter_cohort((c_i,), idx, (c_i_new_c,), donate=donate)  # silent: c_i kept
    new_state, metrics = _arena_state(spec, x_s_new, c_new, c_i_new, state, x_K, x_s_row,
                                      keep_c)
    return new_state, metrics | fm


def popstore_body(cfg: FederatedConfig, spec, m: int, grad_fn, per_step):
    """The device half of a host-popstore SCAFFOLD round (see
    ``gpdmm.popstore_body``): the cohort's ``c_i`` rows stage from the host
    store.  SCAFFOLD's cohort server update is already O(cohort) (both
    means are sums of cohort deltas), so the body forms the new server rows
    itself, as the device cohort round does, and returns them in
    ``server_rows``; only the ``c_sum_norm`` diagnostic needs the host's
    running ``sum(c_i)``."""

    def body(server, staged, idx, round_idx, batch):
        x_s_row = spec.pack(server["x_s"])
        c_row = spec.pack(server["c"])
        batch_c = cohort_batch(batch, idx, m, per_step)
        c_i_new_c, x_s_new, c_new, x_K, keep_c, fm = cohort_step(
            cfg, spec, grad_fn, x_s_row, c_row, staged["c_i"], idx, round_idx, m, batch_c,
            per_step)
        return ({"c_i": c_i_new_c}, {"x_s": x_s_new, "c": c_new},
                popstore_metrics(x_K, x_s_row, keep_c) | fm)

    return body


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches, donate):
    K = cfg.inner_steps
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    c_i = state["c_i"]
    m = c_i.shape[0]
    if use_cohort(cfg, m):
        return _round_arena_cohort(cfg, state, grad_fn, batch, per_step_batches, donate)
    x_s_row = spec.pack(state["x_s"])
    c_row = spec.pack(state["c"])
    x0 = broadcast_rows(x_s_row, m)

    x_K = inner_steps_plain_arena(
        spec, grad_fn, x0, x_s_row, batch, K=K, eta=cfg.eta,
        per_step=per_step_batches, c_i=c_i, c_row=c_row)

    # c_i' = c_i - c + (x_s - x_K) / (K eta_i), as a multiply by the
    # precomputed 1/(K eta) (the reference's rounding)
    alpha = 1.0 / (K * eta_val(cfg.eta, c_i.device))
    # the wire corrupts the transmitted x_K: both uplinked deltas see it
    fplan = faults.plan(cfg, state["round"], m)
    x_t = faults.inject(cfg.faults, fplan, x_K)
    pmask = participation(cfg, state, m)
    keep = faults.screen_keep(cfg, x_t, x_s_row) if faults.screening_on(cfg) else None
    mask = faults.combine_mask(pmask, fplan, keep)
    stale_up, sm, c_colsum = {}, {}, None
    if faults.async_on(cfg):
        # a buffered x_t lands s rounds later and mixes toward the zero-delta
        # server row; c_i refreshes on fresh participation only
        c_i_new = ops.scaffold_cv(c_i, x_t, c_row, x_s_row, alpha)
        x_up, mask, stale_up, sm = staleness.step_arena(cfg, fplan, x_t, x_s_row, mask, state)
        c_i_new = torch.where(mask[:, None], c_i_new, c_i)
        # server: two all-reduces (x-delta and c-delta)
        x_s_new = x_s_row + T.weak(cfg.eta_g, x_s_row) * (torch.mean(x_up, dim=0) - x_s_row)
        c_new = c_row + torch.mean(c_i_new - c_i, dim=0)
    else:
        # c_i', both server means (silent clients send a zero delta and keep
        # c_i) and sum_i (c_i' - c'): two passes over the arena on the card
        c_i_new, x_s_new, c_new, c_colsum = ops.scaffold_step(c_i, x_t, c_row, x_s_row, alpha,
                                                              cfg.eta_g, mask)
    new_state, metrics = _arena_state(spec, x_s_new, c_new, c_i_new, state, x_K, x_s_row, mask,
                                      c_colsum)
    return new_state | stale_up, metrics | fault_report(cfg, fplan, pmask, keep, sm)


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False, *,
           donate=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches, donate)
    K = cfg.inner_steps
    x_s, c, c_i = state["x_s"], state["c"], state["c_i"]
    m = T.leaves(c_i)[0].shape[0]
    eta = eta_val(cfg.eta, T.leaves(c_i)[0].device)
    # lam := c - c_i enters the shared fused step with rho = 0
    lam = T.tmap(lambda cc, ci: cc[None] - ci, c, c_i)
    x_K = inner_steps_plain(grad_fn, T.tree_broadcast(x_s, m), batch, K=K, eta=eta,
                            per_step=per_step_batches, lam=lam)

    # multiply by the precomputed 1/(K eta), as the arena kernel does
    alpha = 1.0 / (K * eta)
    fplan = faults.plan(cfg, state["round"], m)
    x_t = faults.inject_tree(cfg.faults, fplan, x_K)
    c_i_new = T.tmap(lambda ci, cc, s, xk: ci - cc[None] + (s[None] - xk) * T.weak(step_for(alpha, xk), xk),
                     c_i, c, x_s, x_t)
    x_up = x_t
    pmask = participation(cfg, state, m)
    keep = faults.screen_keep_tree(cfg, x_t, x_s) if faults.screening_on(cfg) else None
    mask = faults.combine_mask(pmask, fplan, keep)
    stale_up, sm = {}, {}
    if faults.async_on(cfg):
        # as on the arena: the broadcast server row is the zero-delta
        # baseline, c_i refreshes on fresh participation only
        x_up, mask, stale_up, sm = staleness.step_tree(
            cfg, fplan, x_t, T.tree_broadcast(x_s, m), mask, state)
        c_i_new = T.tree_select(mask, c_i_new, c_i)
    elif mask is not None:
        # silent clients transmit nothing (zero delta, c_i kept)
        c_i_new = T.tree_select(mask, c_i_new, c_i)
        x_up = T.tree_select(mask, x_t, T.tree_broadcast(x_s, m))
    # server: two all-reduces (x-delta and c-delta)
    dx = T.tree_client_mean(T.tmap(lambda xk, s: xk - s[None], x_up, x_s))
    dc = T.tree_client_mean(T.tree_sub(c_i_new, c_i))
    x_s_new = T.tree_axpy(cfg.eta_g, dx, x_s)
    c_new = T.tree_add(c, dc)

    new_state = {"x_s": x_s_new, "c": c_new, "c_i": c_i_new, "round": state["round"] + 1,
                 **stale_up}
    metrics = {
        "c_sum_norm": T.tree_norm(T.tree_client_sum(
            T.tmap(lambda ci, cn: ci - cn[None], c_i_new, c_new))),
        "client_drift": T.tree_client_drift(x_K, x_s, mask),
        "used_arena": torch.zeros((), dtype=torch.float32, device=T.leaves(x_K)[0].device),
    }
    return new_state, metrics | fault_report(cfg, fplan, pmask, keep, sm)


def make(cfg: FederatedConfig) -> FedOpt:
    if cfg.uplink_bits is not None:
        raise NotImplementedError(
            "SCAFFOLD+EF21 (uplink_bits is not None) is not supported: each "
            "SCAFFOLD round uplinks two coupled variables per client -- the "
            "model delta dx_i = x_i^{r,K} - x_s^r and the control-variate "
            "delta dc_i = c_i^{r+1} - c_i^r = (x_s^r - x_i^{r,K})/(K eta) - "
            "c^r.  EF21 integrates ONE error-feedback state u_hat_i per "
            "client; quantising dx_i alone desynchronises the server's c = "
            "mean_i c_i invariant, and a second integrator for dc_i is NOT "
            "error-feedback (dc_i is a function of dx_i, so the two "
            "quantisation errors are coupled).  Use algorithm='gpdmm' (one "
            "uplink variable, EF21 supported) or drop uplink_bits."
        )
    def init(params, m):
        st = {"x_s": params, "c": T.tree_zeros_like(params), "round": round_counter(params)}
        if use_arena(cfg, params):
            # control variates arena-resident; x_s and c stay trees
            spec = arena.ArenaSpec.from_tree(params)
            dev = T.leaves(params)[0].device
            st["c_i"] = arena.zeros(spec, m, device=dev)
            if faults.async_on(cfg):
                st |= staleness.init_arena(spec, m, dev)
        else:
            st["c_i"] = T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params)
            if faults.async_on(cfg):
                st |= staleness.init_tree(params, m)
        return st

    return FedOpt(
        name="scaffold",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
        round_=partial(_round, cfg, donate=True),
    )
