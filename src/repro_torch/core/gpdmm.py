"""GPDMM (Algorithm 1, Zhang et al. 2021), ported from
``src/repro/core/gpdmm.py`` (full participation, star network), on the flat
client arena and on the per-leaf pytree path.

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
oracle, else one ``fused_update_arena`` kernel per step), one ``round_tail``
kernel, the client mean (``torch.mean``) and one ``dual_from_uplink``
kernel.  A pytree round (``use_arena="auto"`` below ``arena_min_width``, or
``layout="fsdp"``) runs one ``fused_update`` kernel per leaf and step, and
its tail as plain tensor ops, as the reference does.

``variance_reduction="svrg"`` (per-step batches) corrects the step-k
gradient with the round's server iterate as snapshot z:
g_k(x) - g_k(z) + mean_j g_j(z).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, affine_case, arena_grad, client_batches, n_steps, require_ported,
    resolved_rho, step_for, step_size, use_arena,
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


def inner_steps(grad_fn, x0, x_s, lam_s, batch, *, K, eta, rho, per_step,
                vr_snapshot=None):
    """The K client steps on the per-leaf pytree path (shared by GPDMM and
    AGPDMM); returns (x_K, x_bar).

    x0, lam_s and ``vr_snapshot`` are stacked ``(m, ...)`` trees; ``x_s`` is
    the server tree, broadcast inside the ``fused_update`` kernel (one
    launch per leaf and step).  The gradient is the per-client ``grad_fn``
    mapped over the client dim (``torch.func.vmap``)."""
    step_c = step_size(eta, rho, T.leaves(x0)[0].device)
    vgrad = torch.func.vmap(grad_fn)
    steps = n_steps(batch, K, per_step)
    snaps, gbar = _svrg(vgrad, vr_snapshot, batch, steps, per_step)
    x, xsum = x0, T.tree_zeros_like(x0)
    for k in range(steps):
        g = vgrad(x, client_batches(batch, k, per_step))
        if gbar is not None:
            g = T.tmap(lambda a, c, d: a - c + d, g, snaps[k], gbar)
        g = T.tree_dense(g)
        x = T.tmap(lambda xx, gg, ss, ll: ops.fused_update(
            xx, gg, ss, ll, step_for(step_c, xx), rho), x, g, x_s, lam_s)
        xsum = T.tree_add(xsum, x)
    return x, T.tree_scale(xsum, 1.0 / K)


def inner_steps_arena(spec, grad_fn, x0, x_s_row, lam, batch, *, K, eta, rho, per_step,
                      vr_snapshot=None):
    """The K client steps on the ``(m, width)`` arena; returns (x_K, x_bar).

    An oracle with ``affine_arena`` (and one batch for all steps, no SVRG)
    runs the whole loop as one kernel; otherwise each step evaluates the
    arena gradient (``grad_arena``, or the plain grad through the tree
    boundary) and applies one ``fused_update_arena`` kernel.  Per-step
    batches run one step per leading batch entry, as the reference's scan
    does."""
    step_c = step_size(eta, rho, x0.device)
    affine = affine_case(grad_fn, spec, per_step=per_step, vr_snapshot=vr_snapshot)
    if affine is not None:
        H, c = affine(spec, batch)
        return ops.inner_loop_affine(x0, H, c, x_s_row, lam, step_c, rho, K)

    grad_a, _native = arena_grad(grad_fn, spec)
    steps = n_steps(batch, K, per_step)
    snaps, gbar = _svrg(grad_a, vr_snapshot, batch, steps, per_step)
    x, xsum = x0, torch.zeros_like(x0)
    for k in range(steps):
        g = grad_a(x, client_batches(batch, k, per_step))
        if gbar is not None:
            g = g - snaps[k] + gbar
        x = ops.fused_update_arena(x, g, x_s_row, lam, step_c, rho)
        xsum = xsum + x
    return x, xsum * (1.0 / K)


def arena_tail(cfg: FederatedConfig, uplink):
    """The full-participation round tail shared with AGPDMM: the client
    mean (the round's single all-reduce) and the fused dual refresh.
    Returns (x_s_new_row, lam_s_new)."""
    x_s_new = torch.mean(uplink, dim=0)
    return x_s_new, ops.dual_from_uplink(uplink, x_s_new, resolved_rho(cfg))


def arena_drift(x_K, x_s_row, mask=None):
    """Mean over (active) clients of ||x_K,i - x_s||^2 on the arena (f32;
    the padding is zero, so no masking of columns is needed)."""
    return T.masked_client_mean(
        torch.sum(torch.square((x_K - x_s_row[None]).to(torch.float32)), dim=1), mask)


def arena_metrics(lam_s_new, x_K, x_s_row, mask=None):
    """KKT invariant (25) and drift straight off the arena buffers."""
    f32 = torch.float32
    return {
        "lam_sum_norm": torch.linalg.vector_norm(torch.sum(lam_s_new.to(f32), dim=0)),
        "client_drift": arena_drift(x_K, x_s_row, mask),
        "used_arena": torch.ones((), dtype=f32, device=x_K.device),
    }


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches, return_trace):
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    lam, x_c = state["lam_s"], state["x_c"]
    x_s_row = spec.pack(state["x_s"])

    snapshot = None
    if cfg.variance_reduction == "svrg":
        snapshot = broadcast_rows(x_s_row, x_c.shape[0])
    x_K, x_bar = inner_steps_arena(
        spec, grad_fn, x_c, x_s_row, lam, batch, K=cfg.inner_steps, eta=cfg.eta,
        rho=rho, per_step=per_step_batches, vr_snapshot=snapshot)
    x_ref = x_bar if cfg.use_avg else x_K

    # the uplink, and lam_is only when a trace wants it
    lam_is, uplink = ops.round_tail(x_ref, lam, x_s_row, rho, with_lam_is=return_trace)
    x_s_new, lam_s_new = arena_tail(cfg, uplink)
    new_state = {
        "x_s": spec.unpack(x_s_new),
        "lam_s": lam_s_new,
        "x_c": x_K,
        "round": state["round"] + 1,
    }
    metrics = arena_metrics(lam_s_new, x_K, x_s_row)
    if return_trace:
        metrics["trace"] = {
            "x_ref": spec.unpack_stacked(x_ref),
            "x_bar": spec.unpack_stacked(x_bar),
            "lam_is": spec.unpack_stacked(lam_is),
            "x_K": spec.unpack_stacked(x_K),
        }
    return new_state, metrics


def _round(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches=False,
           return_trace=False):
    if use_arena(cfg, state["x_s"]):
        return _round_arena(cfg, state, grad_fn, batch, per_step_batches, return_trace)
    rho = resolved_rho(cfg)
    x_s = T.tree_dense(state["x_s"])
    lam_s, x_c = state["lam_s"], state["x_c"]
    m = T.leaves(lam_s)[0].shape[0]

    x_K, x_bar = inner_steps(
        grad_fn, x_c, x_s, lam_s, batch, K=cfg.inner_steps, eta=cfg.eta, rho=rho,
        per_step=per_step_batches,
        vr_snapshot=T.tree_broadcast(x_s, m) if cfg.variance_reduction == "svrg" else None)
    x_ref = x_bar if cfg.use_avg else x_K
    lam_is, x_s_new, lam_s_new = tree_tail(x_ref, x_s, lam_s, rho)
    new_state = {"x_s": x_s_new, "lam_s": lam_s_new, "x_c": x_K,
                 "round": state["round"] + 1}
    metrics = tree_metrics(lam_s_new, x_K, x_s)
    if return_trace:
        metrics["trace"] = {"x_ref": x_ref, "x_bar": x_bar, "lam_is": lam_is, "x_K": x_K}
    return new_state, metrics


def tree_tail(x_ref, x_s, lam_s, rho: float):
    """The pytree round tail shared with AGPDMM, as plain tensor ops (the
    reference's, the server tree broadcast by indexing): lam_is, the
    uplink, its client mean and the dual refresh.  Returns (lam_is,
    x_s_new, lam_s_new)."""
    lam_is = T.tmap(lambda s, xr, l: rho * (s[None] - xr) - l, x_s, x_ref, lam_s)
    uplink = T.tmap(lambda xr, l: xr - l / rho, x_ref, lam_is)
    x_s_new = T.tree_client_mean(uplink)  # the round's single all-reduce
    lam_s_new = T.tmap(lambda u, s: rho * (u - s[None]), uplink, x_s_new)
    return lam_is, x_s_new, lam_s_new


def tree_metrics(lam_s_new, x_K, x_s):
    """KKT invariant (25) and drift on the pytree path."""
    dev = T.leaves(x_K)[0].device
    return {
        "lam_sum_norm": T.tree_norm(T.tree_client_sum(lam_s_new)),
        "client_drift": T.tree_client_drift(x_K, x_s),
        "used_arena": torch.zeros((), dtype=torch.float32, device=dev),
    }


def broadcast_rows(row: torch.Tensor, m: int) -> torch.Tensor:
    """A fresh, contiguous ``(m, width)`` copy of the server row."""
    return row[None].expand(m, row.shape[0]).contiguous()


def round_counter(tree):
    """The int32 round counter, on the device of ``tree``."""
    return torch.zeros((), dtype=torch.int32, device=T.leaves(tree)[0].device)


def make(cfg: FederatedConfig) -> FedOpt:
    require_ported(cfg)

    def init(params, m):
        if not use_arena(cfg, params):
            return {
                "x_s": params,
                "lam_s": T.tmap(lambda p: p.new_zeros((m,) + tuple(p.shape)), params),
                "x_c": T.tree_broadcast(params, m),  # x_i^{0,K} = x_s^1 (Alg. 1)
                "round": round_counter(params),
            }
        spec = arena.ArenaSpec.from_tree(params)
        row = spec.pack(params)
        return {
            "x_s": params,
            "lam_s": arena.zeros(spec, m, device=row.device),
            "x_c": broadcast_rows(row, m),  # x_i^{0,K} = x_s^1 (Alg. 1)
            "round": round_counter(params),
        }

    return FedOpt(
        name="gpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
