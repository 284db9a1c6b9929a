"""Federated-optimiser interface (the port of ``src/repro/core/api.py``).

Every algorithm is a pair of functions on tensors:

    init(params, m)                  -> state
    round(state, grad_fn, batch)     -> (state, metrics)

``params`` is a tensor or a flat dict of tensors; per-client state is
stacked with a leading client dim m (on the arena: one ``(m, width)``
buffer; on the per-leaf pytree path: a tree of stacked leaves).  ``batch``
leaves have leading dim m, or (K, m, ...) with ``per_step_batches=True``.
The state lives on the device of ``params``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import autotune, faults
from repro_torch.core.autotune import mean_eta
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops


class FedOpt(NamedTuple):
    name: str
    init: Callable  # (params, m) -> state
    round: Callable  # (state, grad_fn, batch, per_step_batches=False) -> (state, metrics)
    server_params: Callable  # (state) -> params


# ---------------------------------------------------------------------------
# gradient-oracle protocol (see the reference for the full contract)
# ---------------------------------------------------------------------------
#   grad_fn.grad_arena(spec)          -> ga(x_arena, batch) -> g_arena
#   grad_fn.affine_arena(spec, batch) -> (H, c), grad_i(x) = H_i x - c_i
#   grad_fn.curvature_arena(spec)     -> curv(x_arena, batch) -> L (m,)
#       per-client smoothness for ``eta="auto"`` (``core.autotune``)
#
# The exact (prox-based) PDMM / FedSplit variants instead take a stacked
# ``prox_fn(v, rho) -> argmin_x f_i(x) + rho/2 ||x - v||^2`` oracle
# (``core.pdmm`` / ``core.fedsplit`` / ``core.pdmm_graph``).

def make_oracle(grad_fn, *, grad_arena=None, affine_arena=None, curvature_arena=None):
    """Annotate a per-client ``grad_fn`` with arena-native fast paths."""

    def oracle(x, batch):
        return grad_fn(x, batch)

    if grad_arena is not None:
        oracle.grad_arena = grad_arena
    if affine_arena is not None:
        oracle.affine_arena = affine_arena
    if curvature_arena is not None:
        oracle.curvature_arena = curvature_arena
    return oracle


def arena_grad(grad_fn, spec):
    """``(ga, native)``: the stacked arena gradient for ``grad_fn``.  A plain
    grad is vmapped through the tree boundary (unpack x, pack g)."""
    factory = getattr(grad_fn, "grad_arena", None)
    if factory is not None:
        return factory(spec), True
    vgrad = torch.func.vmap(grad_fn)

    def ga(xa, b):
        return spec.pack_stacked(vgrad(spec.unpack_stacked(xa), b))

    return ga, False


def use_arena(cfg: FederatedConfig, params=None) -> bool:
    """The reference's layout policy: fsdp and mixed-dtype trees keep the
    pytree path, and ``use_arena="auto"`` keeps widths below
    ``arena_min_width`` there too."""
    if cfg.use_arena is False or cfg.layout == "fsdp":
        return False
    if params is not None:
        if len({leaf.dtype for leaf in T.leaves(params)}) > 1:
            return False
    if cfg.use_arena == "auto" and params is not None:
        from repro_torch.core import arena

        return arena.ArenaSpec.from_tree(params).width >= cfg.arena_min_width
    return True


def affine_case(grad_fn, spec, *, per_step=False, vr_snapshot=None):
    """The oracle's ``affine_arena`` factory when the whole inner loop runs
    as one kernel (affine oracle, one batch for all steps, no SVRG
    correction, width within the kernel's shared-memory rule), else None."""
    affine = getattr(grad_fn, "affine_arena", None)
    if affine is None or per_step or vr_snapshot is not None:
        return None
    return affine if ops.affine_inner_fits(spec.width) else None


def resolved_rho(cfg: FederatedConfig) -> float:
    """The paper's default rho = 1/(K * eta), with the mean eta under
    per-client stepsizes.  Always a Python float."""
    if cfg.rho is not None:
        return cfg.rho
    rho = 1.0 / (cfg.inner_steps * mean_eta(cfg))
    if not rho > 0.0:
        raise ValueError(f"derived rho must be positive, got {rho}")
    return rho


def client_batches(batch, k: int, per_step: bool):
    """The batch for inner step k (shared or per-step)."""
    if not per_step:
        return batch
    return T.tmap(lambda x: x[k], batch)


def n_steps(batch, K: int, per_step: bool) -> int:
    """Inner steps of a round: K, or one per leading per-step batch entry
    (as the reference's scan over the batch runs)."""
    return T.leaves(batch)[0].shape[0] if per_step else K


# ---------------------------------------------------------------------------
# the cohort-sampled round engine (partial participation on the arena)
# ---------------------------------------------------------------------------
# With participation < 1 the arena rounds of the four algorithms below gather
# the round's active rows out of the population arena (``ops.row_gather``),
# run the same kernels on the (m_active, width) cohort buffer and scatter
# the updated rows back (``ops.row_scatter``).  The server mean is taken
# over the scattered population buffer, so it equals the masked path's
# mean of selected rows.  The per-algorithm cohort rounds live beside their
# masked siblings.

COHORT_ALGOS = ("gpdmm", "agpdmm", "scaffold", "fedavg")


def use_cohort(cfg: FederatedConfig, m: int) -> bool:
    """Does this arena round run the cohort engine?  With ``cohort="auto"``
    whenever participation < 1 and the cohort is smaller than the
    population; ``True`` forces it, ``False`` keeps the masked
    full-population round.  Only the four ``COHORT_ALGOS`` on the star have
    a cohort round.  Async rounds keep the masked full-population round, as
    the reference's do: a delayed client outside the cohort still has a
    stale slot to age and deliver."""
    if cfg.participation >= 1.0 or not cfg.cohort:
        return False
    if cfg.algorithm not in COHORT_ALGOS or cfg.topology != "star":
        return False
    if faults.async_on(cfg):
        return False
    if cfg.cohort == "auto":
        return T.cohort_count(m, cfg.participation) < m
    return True


def cohort_batch(batch, idx, m: int, per_step: bool):
    """The cohort's gradient batch: population-sized leaves (client dim m)
    are gathered by ``idx``; leaves already sized to the cohort (rows in
    ascending client id, ``cohort_indices``' order) pass through.  The
    client dim is axis 0, or 1 for per-step (K, m, ...) batches."""
    axis = 1 if per_step else 0
    mc = idx.shape[0]

    def one(x):
        if x.shape[axis] == mc and mc != m:
            return x
        if x.shape[axis] != m:
            raise ValueError(
                f"batch leaf client dim {x.shape[axis]} matches neither the "
                f"population ({m}) nor the cohort ({mc})")
        return torch.index_select(x, axis, idx)

    return T.tmap(one, batch)


def _cat(outs):
    """Concatenate the tiles' outputs (a tensor or a tuple of tensors)."""
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


def map_cohort_tiles(tile: int, fn, rows: tuple, batch, *, per_step: bool = False):
    """Run ``fn(rows_tile, batch_tile)`` over fixed-size tiles of the cohort
    in turn, so the inner loop's live state (the (tile, W, W) affine H
    blocks) is O(tile); the outputs come back concatenated to the cohort.
    ``rows`` are (mc, ...) tensors (may be empty: FedAvg carries none, the
    count then comes from the batch); ``tile`` must divide the cohort."""
    axis = 1 if per_step else 0
    mc = rows[0].shape[0] if rows else T.leaves(batch)[0].shape[axis]
    if mc % tile:
        raise ValueError(f"cohort_tile={tile} must divide the cohort size {mc}")
    outs = []
    for t0 in range(0, mc, tile):
        rows_t = tuple(r[t0:t0 + tile] for r in rows)
        batch_t = T.tmap(lambda x: x.narrow(axis, t0, tile), batch)
        outs.append(fn(rows_t, batch_t))
    return _cat(outs)


def run_cohort_inner(cfg: FederatedConfig, fn, rows: tuple, batch, *, per_step: bool = False):
    """The cohort inner loop: tiled when ``cfg.cohort_tile`` is set and
    smaller than the cohort, else one call."""
    mc = rows[0].shape[0] if rows else T.leaves(batch)[0].shape[1 if per_step else 0]
    tile = cfg.cohort_tile
    if tile is not None and tile < mc:
        return map_cohort_tiles(tile, fn, rows, batch, per_step=per_step)
    return fn(rows, batch)


def make_scan_rounds(fed: FedOpt, grad_fn, per_step_batches: bool = False, tol: float = 0.0):
    """Round-batched runner: ``run(state, batches) -> (state, metrics)``
    runs R full rounds, R the leading dim of every batch leaf, and returns
    the metrics stacked ``(R, ...)``.  State for state the same as R
    ``fed.round`` calls (the participation and fault draws fold in the
    carried round counter).  ``tol > 0`` adds each round's fixed-point
    residual (``res_dx2``/``res_x2``, ``autotune.state_residual``) to the
    metrics for the host's ``autotune.EarlyExit``; every round of the chunk
    runs either way."""

    def run(state, batches):
        R = T.leaves(batches)[0].shape[0]
        rows = []
        for r in range(R):
            b = T.tmap(lambda a: a[r], batches)
            new, metrics = fed.round(state, grad_fn, b, per_step_batches)
            if tol > 0.0:
                metrics = {**metrics, **autotune.state_residual(state, new)}
            state = new
            rows.append(metrics)
        return state, {k: torch.stack([mt[k] for mt in rows]) for k in rows[0]}

    return run


def make(cfg: FederatedConfig) -> FedOpt:
    """The optimiser of ``cfg.algorithm``, routed as the reference routes
    it: ``pdmm_graph``/``gpdmm_graph`` run graph-PDMM on any topology (the
    star included), plain ``gpdmm`` on a non-star topology is graph-PDMM,
    and the other algorithms have no decentralized analogue."""
    from repro_torch.core import agpdmm, fedavg, fedsplit, gpdmm, pdmm_graph, scaffold

    algos = {
        "gpdmm": gpdmm.make,
        "agpdmm": agpdmm.make,
        "scaffold": scaffold.make,
        "fedavg": fedavg.make,
        "fedsplit": fedsplit.make_inexact,
        "pdmm_graph": pdmm_graph.make_exact,
        "gpdmm_graph": pdmm_graph.make,
    }
    if cfg.algorithm not in algos:
        raise KeyError(f"unknown federated algorithm {cfg.algorithm!r}")
    if isinstance(cfg.eta, str):
        raise ValueError(
            "eta='auto' must be resolved host-side before the round is "
            "built: call core.autotune.resolve(cfg, grad_fn, params, m, "
            "batch) to derive the per-client stepsizes")
    if cfg.topology != "star" and cfg.algorithm not in ("pdmm_graph", "gpdmm_graph"):
        if cfg.algorithm == "gpdmm":
            # GPDMM over a general network is graph-PDMM with the gradient
            # inner loop
            return pdmm_graph.make(cfg)
        raise ValueError(
            f"algorithm {cfg.algorithm!r} has no decentralized analogue over "
            f"topology={cfg.topology!r}; use 'gpdmm' (rerouted to graph-PDMM), "
            f"'gpdmm_graph', or 'pdmm_graph'"
        )
    return algos[cfg.algorithm](cfg)


def eta_val(eta, device):
    """Kernel-ready eta: a Python float, or for a per-client tuple an (m,)
    f32 tensor on ``device`` (the reference's ``np.float32`` array)."""
    if isinstance(eta, tuple):
        return torch.tensor(eta, dtype=torch.float32, device=device)
    return eta


def step_size(eta, rho: float, device):
    """The eq. (20) stepsize 1/(1/eta + rho): a Python float for a scalar
    eta; for a per-client tuple an (m,) f32 tensor on ``device``, computed
    in f32 as the reference computes it from ``np.float32`` etas."""
    e = eta_val(eta, device)
    return 1.0 / (1.0 / e + rho)


def step_for(step, leaf):
    """Per-leaf view of a (possibly per-client) stepsize on the pytree path:
    a float passes through, an (m,) tensor becomes (m, 1, ...) against the
    leaf."""
    if torch.is_tensor(step) and step.ndim > 0:
        return step.reshape((-1,) + (1,) * (leaf.ndim - 1))
    return step


__all__ = [
    "COHORT_ALGOS", "FedOpt", "affine_case", "arena_grad", "client_batches", "cohort_batch",
    "eta_val", "make", "make_oracle", "make_scan_rounds", "map_cohort_tiles", "mean_eta",
    "n_steps", "resolved_rho", "run_cohort_inner", "step_for", "step_size", "use_arena",
    "use_cohort",
]
