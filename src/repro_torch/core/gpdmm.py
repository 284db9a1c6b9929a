"""GPDMM (Algorithm 1, Zhang et al. 2021) on the flat client arena, ported
from ``src/repro/core/gpdmm.py`` (full participation, star network).

Per round r (client i, K inner steps, rho = 1/(K eta) by default):

    x_i^{r,0}   = x_i^{r-1,K}                                   (carry)
    x_i^{r,k+1} = x_i^{r,k} - (1/(1/eta+rho)) [grad f_i(x_i^{r,k})
                  + rho (x_i^{r,k} - x_s^r) + lam_{s|i}^r]      (eq. 20)
    lam_{i|s}   = rho (x_s^r - xref_i) - lam_{s|i}^r            (eq. 23/24)
    u_i         = xref_i - lam_{i|s} / rho                      (uplink)
    x_s^{r+1}   = mean_i u_i
    lam_{s|i}^{r+1} = rho (u_i - x_s^{r+1})

with xref_i = mean_k x_i^{r,k} (``use_avg=True``) or x_i^{r,K}.  A round is
the inner loop (one ``inner_loop_affine`` kernel for an affine oracle, else
one ``fused_update_arena`` kernel per step), one ``round_tail`` kernel, the
client mean (``torch.mean``) and one ``dual_from_uplink`` kernel.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.core.api import (
    FedOpt, affine_case, arena_grad, client_batches, pytree_path_unported,
    require_ported, resolved_rho, step_size, use_arena,
)
from repro_torch.kernels import ops


def inner_steps_arena(spec, grad_fn, x0, x_s_row, lam, batch, *, K, eta, rho, per_step):
    """The K client steps on the ``(m, width)`` arena; returns (x_K, x_bar).

    An oracle with ``affine_arena`` (and one batch for all steps) runs the
    whole loop as one kernel; otherwise each step evaluates the arena
    gradient (``grad_arena``, or the plain grad through the tree boundary)
    and applies one ``fused_update_arena`` kernel.  Per-step batches run one
    step per leading batch entry, as the reference's scan does."""
    step_c = step_size(eta, rho, x0.device)
    affine = affine_case(grad_fn, spec, per_step=per_step)
    if affine is not None:
        H, c = affine(spec, batch)
        return ops.inner_loop_affine(x0, H, c, x_s_row, lam, step_c, rho, K)

    grad_a, _native = arena_grad(grad_fn, spec)
    n_steps = T.leaves(batch)[0].shape[0] if per_step else K
    x, xsum = x0, torch.zeros_like(x0)
    for k in range(n_steps):
        g = grad_a(x, client_batches(batch, k, per_step))
        x = ops.fused_update_arena(x, g, x_s_row, lam, step_c, rho)
        xsum = xsum + x
    return x, xsum * (1.0 / K)


def arena_tail(cfg: FederatedConfig, uplink):
    """The full-participation round tail shared with AGPDMM: the client
    mean (the round's single all-reduce) and the fused dual refresh.
    Returns (x_s_new_row, lam_s_new)."""
    x_s_new = torch.mean(uplink, dim=0)
    return x_s_new, ops.dual_from_uplink(uplink, x_s_new, resolved_rho(cfg))


def arena_metrics(lam_s_new, x_K, x_s_row, mask=None):
    """KKT invariant (25) and drift straight off the arena buffers (the
    padding is zero, so no masking is needed)."""
    f32 = torch.float32
    return {
        "lam_sum_norm": torch.linalg.vector_norm(torch.sum(lam_s_new.to(f32), dim=0)),
        "client_drift": T.masked_client_mean(
            torch.sum(torch.square((x_K - x_s_row[None]).to(f32)), dim=1), mask),
        "used_arena": torch.ones((), dtype=f32, device=x_K.device),
    }


def _round_arena(cfg: FederatedConfig, state, grad_fn, batch, per_step_batches, return_trace):
    rho = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    lam, x_c = state["lam_s"], state["x_c"]
    x_s_row = spec.pack(state["x_s"])

    x_K, x_bar = inner_steps_arena(
        spec, grad_fn, x_c, x_s_row, lam, batch, K=cfg.inner_steps, eta=cfg.eta,
        rho=rho, per_step=per_step_batches)
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
    if not use_arena(cfg, state["x_s"]):
        raise pytree_path_unported(cfg, state["x_s"])
    return _round_arena(cfg, state, grad_fn, batch, per_step_batches, return_trace)


def broadcast_rows(row: torch.Tensor, m: int) -> torch.Tensor:
    """A fresh, contiguous ``(m, width)`` copy of the server row."""
    return row[None].expand(m, row.shape[0]).contiguous()


def make(cfg: FederatedConfig) -> FedOpt:
    require_ported(cfg)

    def init(params, m):
        if not use_arena(cfg, params):
            raise pytree_path_unported(cfg, params)
        spec = arena.ArenaSpec.from_tree(params)
        row = spec.pack(params)
        return {
            "x_s": params,
            "lam_s": arena.zeros(spec, m, device=row.device),
            "x_c": broadcast_rows(row, m),  # x_i^{0,K} = x_s^1 (Alg. 1)
            "round": torch.zeros((), dtype=torch.int32, device=row.device),
        }

    return FedOpt(
        name="gpdmm",
        init=init,
        round=partial(_round, cfg),
        server_params=lambda s: s["x_s"],
    )
