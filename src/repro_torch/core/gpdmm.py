"""GPDMM (Algorithm 1, Zhang et al. 2021), ported from
``src/repro/core/gpdmm.py`` (star network), on the flat client arena and on
the per-leaf pytree path, with partial participation, the cohort engine and
the EF21 uplink.

Per round r (client i, K inner steps, rho = 1/(K eta) by default):

    x_i^{r,0}   = x_i^{r-1,K}                                   (carry)
    x_i^{r,k+1} = x_i^{r,k} - (1/(1/eta+rho)) [grad f_i(x_i^{r,k})
                  + rho (x_i^{r,k} - x_s^r) + lam_{s|i}^r]      (eq. 20)
    lam_{i|s}   = rho (x_s^r - xref_i) - lam_{s|i}^r            (eq. 23/24)
    u_i         = xref_i - lam_{i|s} / rho                      (uplink)
    x_s^{r+1}   = mean_i u_i
    lam_{s|i}^{r+1} = rho (u_i - x_s^{r+1})

with xref_i = mean_k x_i^{r,k} (``use_avg=True``) or x_i^{r,K}.  An arena
round is the inner loop (one ``inner_loop_affine`` kernel for an affine
oracle, else one ``fused_update_arena`` kernel per step, which also keeps
x_bar's running sum), then two passes over the arena for its tail: a
round that needs no cache (``needs_cache``) runs ``round_tail_mean`` (the
uplink with the client mean in its pass) and ``server_dual`` (the dual
refresh with lam's column sum, which ``lam_sum_norm`` reads); every other
round runs ``round_tail``, the cache's rows (``cached_uplink``) and
``server_step`` (the client mean, then ``server_dual``).  A pytree round
(``use_arena="auto"`` below ``arena_min_width``, or ``layout="fsdp"``) runs
one ``fused_update`` kernel per step for all the leaves of a dtype (x_bar's
running sum in the same pass), and its tail as plain tensor ops, as the
reference does.

``variance_reduction="svrg"`` (per-step batches) corrects the step-k
gradient with the round's server iterate as snapshot z:
g_k(x) - g_k(z) + mean_j g_j(z).

Partial participation (``participation < 1``): the round's mask is drawn
from ``cfg.seed`` and the round counter (``participation_key``, the
reference's ``jax.random`` draw reproduced by ``core.prng``).  Silent
clients transmit nothing: the server keeps its cached view ``u_hat`` of
their uplink, and they keep their primal carry.  ``uplink_bits`` quantises
the uplink's difference to ``u_hat`` (EF21; one kernel on the arena,
``ops.ef21_update``).  On the arena, ``cohort="auto"`` runs the round over
the sampled cohort only: one ``row_gather`` of the active rows of every
buffer the round reads, the same kernels on them, one ``row_scatter`` of
the rows it writes back, in place in a donated round (``_round_arena_cohort``, ``FedOpt.round_``);
``cohort=False`` keeps the masked full-population round.

Faults (``cfg.faults``, ``core.faults``), uplink screening and async rounds
(``core.staleness``) run in the reference's order after EF21: the wire
corrupts the transmitted rows, the participation mask, the plan's silence
and the screen's keep mask (``screen_uplink``, one kernel on the arena)
combine into the round's active mask, and either the stale-slot step
(``stale_mix``, one kernel on the arena) or the masked select against
``u_hat`` builds the rows the server averages.  Demoted and faulted
clients are silent, full stop.  Async rounds keep the masked
full-population path (``api.use_cohort``).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, faults, prng, staleness
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, affine_case, arena_grad, client_batches, cohort_batch, eta_val, n_steps, owned,
    resolved_rho, run_cohort_inner, scatter_cohort, step_size, use_arena, use_cohort,
)
from repro_torch.kernels import ops


def _svrg(vgrad, vr_snapshot, batch, steps, per_step):
    """SVRG at the snapshot z: the per-step gradients g_k(z) and their mean,
    the full-pass gradient; (None, None) without a snapshot.  Step k then
    uses g_k(x) - g_k(z) + mean_j g_j(z)."""
    if vr_snapshot is None:
        return None, None
    if not per_step:
        raise ValueError("SVRG needs per-step minibatches (K, m, ...)")
    snaps = [vgrad(vr_snapshot, client_batches(batch, k, True)) for k in range(steps)]
    return snaps, T.tmap(lambda *gs: torch.mean(torch.stack(gs), dim=0), *snaps)


def bar_buffer(like, steps: int):
    """x_bar's buffer for ``steps`` client steps: the step kernel writes it
    from its first step on (``ops.acc_mode_at``); zeros when no step runs,
    as the plain sum of no iterate."""
    return torch.empty_like(like) if steps else torch.zeros_like(like)


def inner_steps(grad_fn, x0, x_s, lam_s, batch, *, K, eta, rho, per_step,
                vr_snapshot=None, with_bar=True):
    """The K client steps on the per-leaf pytree path (shared by GPDMM and
    AGPDMM); returns (x_K, x_bar), x_bar None unless ``with_bar``.

    x0, lam_s and ``vr_snapshot`` are stacked ``(m, ...)`` trees; ``x_s`` is
    the server tree, broadcast inside the kernel.  Each step is one
    ``fused_update_leaves`` launch for all leaves of a dtype, which keeps
    x_bar's running sum in the same pass.  The gradient is the per-client
    ``grad_fn`` mapped over the client dim (``torch.func.vmap``)."""
    step_c = step_size(eta, rho, T.leaves(x0)[0].device)
    vgrad = torch.func.vmap(grad_fn)
    steps = n_steps(batch, K, per_step)
    snaps, gbar = _svrg(vgrad, vr_snapshot, batch, steps, per_step)
    x, xl, x_sl, laml = x0, T.leaves(x0), T.leaves(x_s), T.leaves(lam_s)
    accs = [bar_buffer(a, steps) for a in xl] if with_bar else None
    for k in range(steps):
        g = vgrad(x, client_batches(batch, k, per_step))
        if gbar is not None:
            g = T.tmap(lambda a, c, d: a - c + d, g, snaps[k], gbar)
        xl = ops.fused_update_leaves(xl, T.leaves(T.tree_dense(g)), x_sl, laml, step_c, rho,
                                     accs=accs, acc_mode=ops.acc_mode_at(k, steps),
                                     acc_scale=1.0 / K)
        x = T.unflatten(x0, xl)
    return x, (T.unflatten(x0, accs) if with_bar else None)


def inner_steps_arena(spec, grad_fn, x0, x_s_row, lam, batch, *, K, eta, rho, per_step,
                      vr_snapshot=None, with_bar=True):
    """The K client steps on the ``(m, width)`` arena; returns (x_K, x_bar),
    x_bar None unless ``with_bar`` (the affine kernel returns it anyway).

    An oracle with ``affine_arena`` (and one batch for all steps, no SVRG)
    runs the whole loop as one kernel; otherwise each step evaluates the
    arena gradient (``grad_arena``, or the plain grad through the tree
    boundary) and applies one ``fused_update_arena`` kernel, which keeps
    x_bar's running sum in the same pass.  Per-step batches run one step
    per leading batch entry, as the reference's scan does."""
    step_c = step_size(eta, rho, x0.device)
    affine = affine_case(grad_fn, spec, per_step=per_step, vr_snapshot=vr_snapshot)
    if affine is not None:
        H, c = affine(spec, batch)
        return ops.inner_loop_affine(x0, H, c, x_s_row, lam, step_c, rho, K)

    grad_a, _native = arena_grad(grad_fn, spec)
    steps = n_steps(batch, K, per_step)
    snaps, gbar = _svrg(grad_a, vr_snapshot, batch, steps, per_step)
    x, acc = x0, (bar_buffer(x0, steps) if with_bar else None)
    for k in range(steps):
        g = grad_a(x, client_batches(batch, k, per_step))
        if gbar is not None:
            g = g - snaps[k] + gbar
        x = ops.fused_update_arena(x, g, x_s_row, lam, step_c, rho, acc=acc,
                                   acc_mode=ops.acc_mode_at(k, steps), acc_scale=1.0 / K)
    return x, acc


def participation_key(cfg: FederatedConfig, round_idx):
    """The round's participation key, folded from ``cfg.seed``, so every
    algorithm draws the same mask sequence; on the device of the round
    counter."""
    return prng.fold_in(prng.key(cfg.seed), round_idx)


def participation(cfg: FederatedConfig, state, m: int):
    """The round's participation mask (m,) bool, or None under full
    participation."""
    if cfg.participation >= 1.0:
        return None
    return T.participation_mask(participation_key(cfg, state["round"]), m, cfg.participation)


def round_cohort(cfg: FederatedConfig, state, m: int):
    """The round's cohort ids (mc,) int64, ascending."""
    idx, _mask = T.cohort_indices(participation_key(cfg, state["round"]), m,
                                  cfg.participation)
    return idx


def fault_report(cfg: FederatedConfig, fplan, pmask, keep, stale: dict) -> dict:
    """The round's fault counters (``faults.fault_metrics``, with the stale
    slots' under async rounds), or {} when no plan was drawn and nothing was
    screened.  Transmitters are the participating, non-silent clients, less
    the delayed ones under async rounds."""
    if fplan is None and keep is None:
        return {}
    tx = faults.combine_mask(pmask, fplan, None)
    if faults.async_on(cfg):
        tx = staleness.fresh_mask(tx, fplan)
    return faults.fault_metrics(fplan, tx, keep) | stale


def cached_uplink(cfg: FederatedConfig, state, uplink, m: int, ref, spec=None):
    """The uplink as the server's cache sees it (shared with AGPDMM and
    FedAvg, on the arena with ``spec``, else on the pytree path), in the
    reference's order: EF21 against ``u_hat``; the wire's corruption of the
    round's fault plan; the participation mask, the plan's silence and the
    screen's keep mask (against the downlink ``ref``: the server row on the
    arena, the server tree on the pytree path) combined; then either the
    stale-slot step (async rounds) or the select, silent clients' rows taken
    from ``u_hat``.  Returns (uplink, mask, stale state updates, fault
    metrics); ``mask`` is the round's active mask (None: every uplink
    entered the mean), the result the state's new ``u_hat`` where it
    carries one."""
    u_hat = state.get("u_hat")  # present with EF21, participation < 1 or faults
    if cfg.uplink_bits is not None:
        uplink = (T.tree_quantize_delta(uplink, u_hat, cfg.uplink_bits) if spec is None
                  else ops.ef21_update(uplink, u_hat, cfg.uplink_bits, spec.leaf_rows()))
    # the wire corrupts what was transmitted: the EF21-integrated view
    fplan = faults.plan(cfg, state["round"], m)
    uplink = (faults.inject_tree if spec is None else faults.inject)(cfg.faults, fplan, uplink)
    pmask = participation(cfg, state, m)
    keep = None
    if faults.screening_on(cfg):
        keep = (faults.screen_keep_tree(cfg, uplink, ref) if spec is None
                else faults.screen_keep(cfg, uplink, ref))
    mask = faults.combine_mask(pmask, fplan, keep)
    stale_up, sm = {}, {}
    if faults.async_on(cfg):
        step = staleness.step_tree if spec is None else staleness.step_arena
        uplink, mask, stale_up, sm = step(cfg, fplan, uplink, u_hat, mask, state)
    elif mask is not None:
        uplink = T.tree_select(mask, uplink, u_hat)
    return uplink, mask, stale_up, fault_report(cfg, fplan, pmask, keep, sm)


def arena_tail(cfg: FederatedConfig, spec, state, x_ref, lam, m: int, x_s_row, *,
               with_lam_is: bool = False):
    """The arena round tail shared with AGPDMM, from the inner loop's
    ``x_ref``: the dual flip and the uplink, ``cached_uplink`` (screened
    against the server row ``x_s_row``), the client mean (the round's
    single all-reduce) and the dual refresh with lam's column sum.  Without
    a cache the uplink goes to the mean untouched, so the round tail takes
    the mean in its pass.  Returns (lam_is or None, state_updates,
    x_s_new_row, lam_s_new, lam's f32 column sum, mask, fault metrics)."""
    rho = resolved_rho(cfg)
    if not needs_cache(cfg):
        lam_is, uplink, x_s_new = ops.round_tail_mean(x_ref, lam, x_s_row, rho,
                                                      with_lam_is=with_lam_is)
        lam_s_new, lam_sum = ops.server_dual(uplink, x_s_new, rho)
        return lam_is, {}, x_s_new, lam_s_new, lam_sum, None, {}
    lam_is, uplink = ops.round_tail(x_ref, lam, x_s_row, rho, with_lam_is=with_lam_is)
    uplink, mask, new_state, fm = cached_uplink(cfg, state, uplink, m, x_s_row, spec)
    if "u_hat" in state:
        new_state["u_hat"] = uplink
    x_s_new, lam_s_new, lam_sum = ops.server_step(uplink, rho)
    return lam_is, new_state, x_s_new, lam_s_new, lam_sum, mask, fm


def cohort_reads_cache(cfg: FederatedConfig) -> bool:
    """Does the cohort's uplink read its cached ``u_hat`` rows: against
    EF21's integrator, or as the stand-in of a faulted or demoted client?"""
    return cfg.uplink_bits is not None or faults.needs_cache(cfg)


def cohort_cache(cfg: FederatedConfig, spec, state, uplink, idx, x_s_row, u_hat_c):
    """The cohort's uplink rows as the population cache will hold them
    (shared with AGPDMM and FedAvg): ``popstore_tail`` on the cohort's
    cached ``u_hat`` rows ``u_hat_c`` (gathered with the round's other rows
    when ``cohort_reads_cache``, else None) with the state's round and
    population.  The rows scattered into ``u_hat`` make its mean the masked
    round's mean of selected rows."""
    return popstore_tail(cfg, spec, x_s_row, u_hat_c, uplink, idx, state["round"],
                         state["u_hat"].shape[0])


def popstore_tail(cfg: FederatedConfig, spec, x_s_row, u_hat_c, uplink, idx, round_idx,
                  m: int):
    """The cohort-resident round tail, shared by the device cohort round
    (``cohort_cache``) and the host-popstore bodies of GPDMM, AGPDMM and
    FedAvg: EF21 against the cohort's cached ``u_hat`` rows, the wire's
    corruption of the population's fault plan (round ``round_idx``, m
    clients) restricted to the cohort, the screen on the (mc, W) cohort
    uplink (its median over the cohort, as the reference takes it), and
    the keep select back to the cached rows.  No O(m) work: the caller
    scatters the rows and forms the server mean.  Returns (uplink rows,
    keep_c, fault metrics); ``keep_c`` is the cohort's surviving mask
    (None: every cohort uplink entered)."""
    if cfg.uplink_bits is not None:
        uplink = ops.ef21_update(uplink, u_hat_c, cfg.uplink_bits, spec.leaf_rows())
    fplan = faults.plan(cfg, round_idx, m)
    plan_c = faults.take(fplan, idx)
    uplink = faults.inject(cfg.faults, plan_c, uplink)
    keep = faults.screen_keep(cfg, uplink, x_s_row) if faults.screening_on(cfg) else None
    keep_c = faults.combine_mask(None, plan_c, keep)
    if keep_c is not None:
        # demoted or faulted cohort rows are silent: the cache keeps their row
        uplink = torch.where(keep_c[:, None], uplink, u_hat_c)
    return uplink, keep_c, cohort_fault_report(fplan, plan_c, keep)


def cohort_fault_report(fplan, plan_c, keep) -> dict:
    """``fault_report`` of a cohort round: injected over the population's
    plan, demoted among the cohort's non-silent clients (``plan_c``, the
    plan restricted to the cohort)."""
    if fplan is None and keep is None:
        return {}
    return faults.fault_metrics(fplan, None if plan_c is None else ~plan_c.silent, keep)


def cohort_server(cfg: FederatedConfig, spec, u_hat_new):
    """The cohort round's server step over the scattered cache, shared with
    AGPDMM: the client mean and the full dual refresh with lam's column
    sum.  Returns ({u_hat, x_s, lam_s}, the column sum)."""
    x_s_new, lam_s_new, lam_sum = ops.server_step(u_hat_new, resolved_rho(cfg))
    return {"u_hat": u_hat_new, "x_s": spec.unpack(x_s_new), "lam_s": lam_s_new}, lam_sum


def cohort_eta(cfg: FederatedConfig, idx):
    """The cohort's rows of a per-client eta tuple, (mc,) f32, or None for
    a scalar eta."""
    if not isinstance(cfg.eta, tuple):
        return None
    return eta_val(cfg.eta, idx.device)[idx]


def arena_drift(x_K, x_s_row, mask=None):
    """Mean over (active) clients of ||x_K,i - x_s||^2 on the arena (f32;
    the padding is zero, so no masking of columns is needed)."""
    return T.masked_client_mean(
        torch.sum(torch.square((x_K - x_s_row[None]).to(torch.float32)), dim=1), mask)


def arena_metrics(lam_sum, x_K, x_s_row, mask=None):
    """KKT invariant (25), the norm of lam's f32 column sum ``lam_sum`` (the
    server step's), and drift straight off the arena buffers."""
    f32 = torch.float32
    return {
        "lam_sum_norm": torch.linalg.vector_norm(lam_sum),
        "client_drift": arena_drift(x_K, x_s_row, mask),
        "used_arena": torch.ones((), dtype=f32, device=x_K.device),
    }


def cohort_loop(cfg: FederatedConfig, spec, grad_fn, x_s_row, x0_c, lam_c, batch_c, idx,
                per_step: bool):
    """The cohort's K client steps from its carry rows ``x0_c`` and dual
    rows ``lam_c`` (tiled by ``cohort_tile``), shared by the device cohort
    round and the popstore body.  Returns (x_K, x_bar)."""
    rho = resolved_rho(cfg)
    eta_c = cohort_eta(cfg, idx)

    def inner(rows, b):
        x0, lam_t = rows[0], rows[1]
        snap = (broadcast_rows(x_s_row, x0.shape[0])
                if cfg.variance_reduction == "svrg" else None)
        return inner_steps_arena(
            spec, grad_fn, x0, x_s_row, lam_t, b, K=cfg.inner_steps,
            eta=cfg.eta if eta_c is None else rows[2], rho=rho,
            per_step=per_step, vr_snapshot=snap, with_bar=cfg.use_avg)

    rows = (x0_c, lam_c) + (() if eta_c is None else (eta_c,))
    return run_cohort_inner(cfg, inner, rows, batch_c, per_step=per_step)


def _round_arena_cohort(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches,
                        donate=False):
    """GPDMM over the round's sampled cohort: gather its lam and carry rows
    (and its cached uplink rows when the uplink reads them) in one launch,
    run the inner loop and the uplink on the (mc, width) cohort buffer
    (tiled by ``cohort_tile``), scatter the cached uplink and the carry
    rows back in one launch (in place when ``donate``), then the server
    step.  Row for row the masked round's arithmetic."""
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    if donate:
        state = owned(state, ("x_c", "u_hat"))
    lam, x_c, u_hat = state["lam_s"], state["x_c"], state["u_hat"]
    m = lam.shape[0]
    x_s_row = spec.pack(state["x_s"])
    idx = round_cohort(cfg, state, m)
    lam_c, x0_c, *u_hat_c = ops.row_gather_buffers(
        (lam, x_c) + ((u_hat,) if cohort_reads_cache(cfg) else ()), idx)
    batch_c = cohort_batch(batch, idx, m, per_step_batches)
    x_K, x_bar = cohort_loop(cfg, spec, grad_fn, x_s_row, x0_c, lam_c, batch_c, idx,
                             per_step_batches)
    x_ref = x_bar if cfg.use_avg else x_K

    _, uplink = ops.round_tail(x_ref, lam_c, x_s_row, rho, with_lam_is=False)
    uplink, keep_c, fm = cohort_cache(cfg, spec, state, uplink, idx, x_s_row,
                                      u_hat_c[0] if u_hat_c else None)
    # demoted cohort rows are silent: they keep their round-start carry
    x_K_kept = x_K if keep_c is None else torch.where(keep_c[:, None], x_K, x0_c)
    u_hat_new, x_c_new = scatter_cohort((u_hat, x_c), idx, (uplink, x_K_kept), donate=donate)
    server, lam_sum = cohort_server(cfg, spec, u_hat_new)
    new_state = server | {
        "x_c": x_c_new,  # silent clients keep their carry
        "round": state["round"] + 1,
    }
    return new_state, arena_metrics(lam_sum, x_K, x_s_row, keep_c) | fm


def popstore_metrics(x_K, x_s_row, keep_c) -> dict:
    """A popstore body's device metrics: drift over the surviving cohort
    rows (the invariant (25) is the host's, off its running sum)."""
    return {"client_drift": arena_drift(x_K, x_s_row, keep_c),
            "used_arena": torch.ones((), dtype=torch.float32, device=x_K.device)}


def popstore_body(cfg: FederatedConfig, spec, m: int, grad_fn, per_step):
    """The device half of a host-popstore GPDMM round (``core.popstore``).

    ``body(server, staged, idx, round_idx, batch)`` touches only O(cohort)
    device memory: ``staged`` carries the sampled rows of the host store,
    ``u_hat`` (the server's cached uplink view) and ``x_c`` (the primal
    carry), and the dual rows are rebuilt lazily from the round invariant
    lam_{s|i} = rho (u_hat_i - x_s) (``ops.dual_from_uplink`` on the staged
    rows, elementwise, so row for row the dense refresh the device round
    keeps).  ``idx`` is the cohort's ids on the device, ``round_idx`` the
    round as a device int32 (the fault plan's key).  Returns ``(rows_out,
    server_rows, metrics)``; ``rows_out = {u_hat, x_c}`` goes back into the
    host store, which forms the server mean."""
    rho = resolved_rho(cfg)

    def body(server, staged, idx, round_idx, batch):
        x_s_row = spec.pack(server["x_s"])
        u_hat_c, x0_c = staged["u_hat"], staged["x_c"]
        lam_c = ops.dual_from_uplink(u_hat_c, x_s_row, rho)  # the lazy dual
        batch_c = cohort_batch(batch, idx, m, per_step)
        x_K, x_bar = cohort_loop(cfg, spec, grad_fn, x_s_row, x0_c, lam_c, batch_c, idx,
                                 per_step)
        x_ref = x_bar if cfg.use_avg else x_K
        _, uplink = ops.round_tail(x_ref, lam_c, x_s_row, rho, with_lam_is=False)
        uplink, keep_c, fm = popstore_tail(cfg, spec, x_s_row, u_hat_c, uplink, idx,
                                           round_idx, m)
        x_K_kept = x_K if keep_c is None else torch.where(keep_c[:, None], x_K, x0_c)
        return ({"u_hat": uplink, "x_c": x_K_kept}, {},
                popstore_metrics(x_K, x_s_row, keep_c) | fm)

    return body


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches, return_trace,
                 donate):
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    lam, x_c = state["lam_s"], state["x_c"]
    m = lam.shape[0]
    if use_cohort(cfg, m) and not return_trace:
        # a trace stacks the whole population, so traced rounds stay masked
        return _round_arena_cohort(cfg, state, grad_fn, batch, per_step_batches, donate)
    x_s_row = spec.pack(state["x_s"])

    snapshot = None
    if cfg.variance_reduction == "svrg":
        snapshot = broadcast_rows(x_s_row, x_c.shape[0])
    x_K, x_bar = inner_steps_arena(
        spec, grad_fn, x_c, x_s_row, lam, batch, K=cfg.inner_steps, eta=cfg.eta,
        rho=rho, per_step=per_step_batches, vr_snapshot=snapshot,
        with_bar=cfg.use_avg or return_trace)
    x_ref = x_bar if cfg.use_avg else x_K

    # the uplink, and lam_is only when a trace wants it
    lam_is, new_state, x_s_new, lam_s_new, lam_sum, mask, fm = arena_tail(
        cfg, spec, state, x_ref, lam, m, x_s_row, with_lam_is=return_trace)
    new_state |= {
        "x_s": spec.unpack(x_s_new),
        "lam_s": lam_s_new,
        # silent clients did not run their inner steps: they keep their carry
        "x_c": x_K if mask is None else torch.where(mask[:, None], x_K, x_c),
        "round": state["round"] + 1,
    }
    metrics = arena_metrics(lam_sum, x_K, x_s_row, mask) | fm
    if return_trace:
        metrics["trace"] = {
            "x_ref": spec.unpack_stacked(x_ref),
            "x_bar": spec.unpack_stacked(x_bar),
            "lam_is": spec.unpack_stacked(lam_is),
            "x_K": spec.unpack_stacked(x_K),
        }
    return new_state, metrics


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False,
           return_trace=False, *, donate=False):
    """One round; ``donate`` (``FedOpt.round_``) lets the cohort round write
    the state's population buffers in place (``api.owned``)."""
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches, return_trace, donate)
    rho = resolved_rho(cfg)
    x_s = T.tree_dense(state["x_s"])
    lam_s, x_c = state["lam_s"], state["x_c"]
    m = T.leaves(lam_s)[0].shape[0]

    x_K, x_bar = inner_steps(
        grad_fn, x_c, x_s, lam_s, batch, K=cfg.inner_steps, eta=cfg.eta, rho=rho,
        per_step=per_step_batches,
        vr_snapshot=T.tree_broadcast(x_s, m) if cfg.variance_reduction == "svrg" else None,
        with_bar=cfg.use_avg or return_trace)
    x_ref = x_bar if cfg.use_avg else x_K
    lam_is, new_state, mask, fm = tree_tail(cfg, state, x_ref, x_s, rho, m)
    new_state |= {"x_c": x_K if mask is None else T.tree_select(mask, x_K, x_c),
                  "round": state["round"] + 1}
    metrics = tree_metrics(new_state["lam_s"], x_K, x_s, mask) | fm
    if return_trace:
        metrics["trace"] = {"x_ref": x_ref, "x_bar": x_bar, "lam_is": lam_is, "x_K": x_K}
    return new_state, metrics


def tree_tail(cfg: FederatedConfig, state, x_ref, x_s, rho: float, m: int):
    """The pytree round tail shared with AGPDMM, as plain tensor ops (the
    reference's, the server tree broadcast by indexing): lam_is, the
    uplink, ``cached_uplink`` (screened against the server tree), the
    client mean and the dual refresh.  Returns (lam_is, {x_s, lam_s[,
    u_hat][, stale slots]}, mask, fault metrics)."""
    lam_is = T.tmap(lambda s, xr, l: T.weak(rho, s) * (s[None] - xr) - l, x_s, x_ref, state["lam_s"])
    uplink = T.tmap(lambda xr, l: xr - l / T.weak(rho, l), x_ref, lam_is)
    uplink, mask, new_state, fm = cached_uplink(cfg, state, uplink, m, x_s)
    if "u_hat" in state:
        new_state["u_hat"] = uplink
    x_s_new = T.tree_client_mean(uplink)  # the round's single all-reduce
    new_state["x_s"] = x_s_new
    new_state["lam_s"] = T.tmap(lambda u, s: T.weak(rho, u) * (u - s[None]), uplink, x_s_new)
    return lam_is, new_state, mask, fm


def tree_metrics(lam_s_new, x_K, x_s, mask=None):
    """KKT invariant (25) and drift (over the active clients) on the
    pytree path."""
    dev = T.leaves(x_K)[0].device
    return {
        "lam_sum_norm": T.tree_norm(T.tree_client_sum(lam_s_new)),
        "client_drift": T.tree_client_drift(x_K, x_s, mask),
        "used_arena": torch.zeros((), dtype=torch.float32, device=dev),
    }


def broadcast_rows(row: torch.Tensor, m: int) -> torch.Tensor:
    """A fresh, contiguous ``(m, width)`` copy of the server row."""
    return row[None].expand(m, row.shape[0]).contiguous()


def needs_cache(cfg: FederatedConfig) -> bool:
    """Does the state carry ``u_hat``, the server's view of each client's
    uplink (the EF21 integrator and the silent, faulted or demoted clients'
    stand-in)?  Its init is the round-0 uplink of a client that never
    moved, x_s, as a fresh buffer of its own."""
    return (cfg.uplink_bits is not None or cfg.participation < 1.0
            or faults.needs_cache(cfg))


def round_counter(tree):
    """The int32 round counter, on the device of ``tree``."""
    return torch.zeros((), dtype=torch.int32, device=T.leaves(tree)[0].device)


def make(cfg: FederatedConfig) -> FedOpt:
    def init(params, m):
        if not use_arena(cfg, params):
            st = {
                "x_s": params,
                "lam_s": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params),
                "x_c": T.tree_broadcast(params, m),  # x_i^{0,K} = x_s^1 (Alg. 1)
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
            "x_c": broadcast_rows(row, m),  # x_i^{0,K} = x_s^1 (Alg. 1)
            "round": round_counter(params),
        }
        if needs_cache(cfg):
            st["u_hat"] = broadcast_rows(row, m)
        if faults.async_on(cfg):
            st |= staleness.init_arena(spec, m, row.device)
        return st

    return FedOpt(
        name="gpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
        round_=partial(_round, cfg, donate=True),
    )
