"""Decentralized PDMM over a general graph topology, ported from
``src/repro/core/pdmm_graph.py``: the setting the paper specialises to a
star.

Consensus over a connected graph G = (V, E),

    min sum_i f_i(x_i)   s.t.  A_ij x_i + A_ji x_j = 0  for (i, j) in E,

with A_ij = +I if i < j else -I.  Each directed edge carries a dual z_{i|j}
held by node i; a node update reads only its own duals:

    x_i      = argmin_x f_i(x) + s_i^T x + (c d_i / 2) ||x||^2,
               s_i = sum_{j in N(i)} A_ij z_{i|j}               (prox step)
    z_{j|i}' = z_{i|j} + 2 c A_ij x_i   for j in N(i)           (dual flip)

Firing schedules (``graph_schedule``): ``"color"`` fires the colour classes
of the greedy colouring in turn, each phase re-reducing the freshly flipped
duals (on a star, {clients} then {server}, this is the centralised
algorithm round for round); ``"sync"`` fires every node at once.  With
``participation < 1`` a random subset of data nodes fires each round (the
shared participation draw), silent nodes keep their primal rows and their
neighbours keep the stale duals; aux nodes (the star's f = 0 centre)
always fire.  A fault plan silences data nodes and corrupts what they
transmit; screening demotes a node whose transmission is not finite or an
outlier against its own round-start carry, and a demoted node is silent.

One phase is one ``neighbor_reduce`` kernel, the firing data nodes' inner
loop (``make``: K inexact steps at stepsize 1/(1/eta + c d_i); the affine
oracle as one ``inner_loop_affine`` kernel, a constant degree as K
``fused_update_arena`` kernels, irregular degrees as plain tensor code) or
their prox (``make_exact``), a ``screen_uplink`` kernel when screening, and
one ``edge_flip`` kernel.  The slot tables are numpy (``core.topology``);
the kernels keep their device copies, and the per-phase index tensors,
static fire masks and per-node constants (steps, c d_i) are built once per
(topology, schedule, device, c, eta) here.
Rounds are functional: every update makes new tensors, so two states never
share a buffer.

State: ``x`` the ``(n, width)`` node-primal arena (the gradient carry),
``z`` the ``(2|E|, width)`` edge-dual arena, ``x_s`` the consensus estimate
tree (the aux node's row on a star, the node mean otherwise), ``round``.
"""
from __future__ import annotations

import functools
import inspect
import threading
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, faults, topology
from repro_torch.core import tree_util as T
from repro_torch.core.api import FedOpt, affine_case, arena_grad, resolved_rho
from repro_torch.core.gpdmm import participation_key, round_counter
from repro_torch.kernels import ops


def _prox_takes_idx(fn) -> bool:
    """Does the prox take the firing subset's ``idx`` keyword
    (``make_client_prox``'s does)?  A plain 2-argument prox is evaluated at
    the full stacking instead."""
    try:
        return "idx" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@functools.lru_cache(maxsize=None)
def _compiled(spec_str: str, m: int, seed: int) -> topology.Topology:
    """Topologies by (spec, m, seed): the round rebuilds them from the
    state's row count alone."""
    return topology.make(spec_str, m, seed=seed)


def topo_for(cfg: FederatedConfig, m: int) -> topology.Topology:
    return _compiled(cfg.topology, m, cfg.seed)


def _n_data_of(cfg: FederatedConfig, n_nodes: int) -> int:
    """Data-node count from the node arena's rows (a star carries one aux
    centre)."""
    return n_nodes - 1 if cfg.topology.partition(":")[0] == "star" else n_nodes


def edge_duals_init(topo: topology.Topology, row, c: float):
    """Round-0 edge duals z_{i|j} = -c sgn * row: on a star exactly the
    centralised zero-dual init."""
    sgnf = torch.as_tensor(topo.sgn, dtype=torch.float32).to(row.device)
    return ((-c) * sgnf[:, None] * row[None].to(torch.float32)).to(row.dtype)


# ---------------------------------------------------------------------------
# per-(topology, schedule, device, c, eta) tables
# ---------------------------------------------------------------------------

class NodeConsts(NamedTuple):
    """A firing set's per-node constants: host copies for the round's static
    choices, f32 device copies for the math (a synchronous copy from
    pageable memory in every phase would stall the host behind the
    device)."""

    step: np.ndarray  # 1/(1/eta_i + c d_i), float64
    cd: np.ndarray  # c d_i, float64
    step_t: torch.Tensor
    cd_t: torch.Tensor


class Phase(NamedTuple):
    """One firing phase: its static firing nodes and what the round needs
    of them on the device."""

    dm: np.ndarray  # firing data nodes
    am: np.ndarray  # firing aux (f = 0) nodes
    dm_t: Optional[torch.Tensor]  # dm, int64 on the device
    am_t: Optional[torch.Tensor]
    data: Optional[NodeConsts]  # of dm
    cd_am: Optional[torch.Tensor]  # c d_i of am, f32
    static_mask: Optional[torch.Tensor]  # (2E,) int32 fire mask, None = every slot
    fired_data: torch.Tensor  # (n_data,) bool: data node fires this phase
    fired_aux: torch.Tensor  # (n_aux,) bool


class Tables(NamedTuple):
    first: np.ndarray  # topo.first_flags(), one array for every phase
    src_t: torch.Tensor  # (2E,) int64
    nbr_t: torch.Tensor  # (2E,) int64
    cd_data: torch.Tensor  # (n_data,) c d_i, f32: a plain prox's full stacking
    phases: tuple


_lock = threading.Lock()
_tables: dict = {}
_MAX_TABLES = 256


def _phases_of(cfg: FederatedConfig, topo: topology.Topology):
    if cfg.graph_schedule == "color":
        return topo.colors
    if cfg.graph_schedule == "sync":
        return (np.arange(topo.n, dtype=np.int32),)
    raise ValueError(f"unknown graph_schedule {cfg.graph_schedule!r} (color | sync)")


def tables(cfg: FederatedConfig, topo: topology.Topology, device) -> Tables:
    """The round's index tensors, static fire masks and per-node constants,
    built once per (topology, schedule, device, c, eta); the entry holds the
    topology, so its id stays its own."""
    phases = _phases_of(cfg, topo)
    c = resolved_rho(cfg)
    key = (id(topo), cfg.graph_schedule, str(device), c, cfg.eta)
    with _lock:
        hit = _tables.get(key)
    if hit is not None and hit[0] is topo:
        return hit[1]

    def on(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    def consts(nodes):
        # per-node auto-eta: the firing subset of the resolved tuple
        eta = (np.asarray(cfg.eta, np.float64)[nodes] if isinstance(cfg.eta, tuple)
               else cfg.eta)
        cd = c * topo.deg[nodes].astype(np.float64)
        step = 1.0 / (1.0 / np.asarray(eta, np.float64) + cd)
        return NodeConsts(step=step, cd=cd, step_t=on(step, torch.float32),
                          cd_t=on(cd, torch.float32))

    out = []
    for members in phases:
        dm = members[members < topo.n_data]
        am = members[members >= topo.n_data]
        fired = np.zeros(topo.n, bool)
        fired[members] = True
        slot_static = fired[topo.nbr]
        out.append(Phase(
            dm=dm, am=am,
            dm_t=on(dm) if dm.size else None, am_t=on(am) if am.size else None,
            data=consts(dm) if dm.size else None,
            cd_am=on(c * topo.deg[am], torch.float32) if am.size else None,
            static_mask=None if slot_static.all() else on(slot_static, torch.int32),
            fired_data=on(fired[:topo.n_data], torch.bool),
            fired_aux=on(fired[topo.n_data:], torch.bool)))
    tab = Tables(first=topo.first_flags(), src_t=on(topo.src), nbr_t=on(topo.nbr),
                 cd_data=on(c * topo.deg[:topo.n_data], torch.float32), phases=tuple(out))
    with _lock:
        if len(_tables) >= _MAX_TABLES:
            _tables.pop(next(iter(_tables)))
        _tables[key] = (topo, tab)
    return tab


# ---------------------------------------------------------------------------
# the K-step gradient inner loop for one firing set of data nodes
# ---------------------------------------------------------------------------

def inner_steps_graph(spec, grad_fn, x0, s, batch, *, K, nc: NodeConsts, per_step):
    """K inexact-PDMM steps at stepsize 1/(1/eta + c d_i) for the stacked
    firing data nodes: x <- x - step_i (grad f_i(x) + c d_i x + s_i), the
    steps and c d_i from ``nc``.  Returns (x_K, x_bar).

      1. affine oracle within the kernel's width rule: the whole loop is one
         ``inner_loop_affine`` kernel, the per-node step and the c d_i I
         shift folded into (H, c) and the dual sum into the dual operand,
         run at unit step and zero rho;
      2. constant degree and step (star, ring, torus, complete): K
         ``fused_update_arena`` kernels with rho = c d and a zero server row;
      3. otherwise (er, per-node eta): plain per-node step/degree columns."""
    f32, dev = torch.float32, x0.device

    affine = affine_case(grad_fn, spec, per_step=per_step)
    if affine is not None:
        H, cc = affine(spec, batch)
        stepc = nc.step_t[:, None]
        cd = nc.cd_t[:, None, None]
        # + c d_i I touches padded diagonal entries too -- harmless: padded
        # coordinates update as x - step * c d_i * 0 and stay 0
        eye = torch.eye(spec.width, dtype=f32, device=dev)
        Hs = (H.to(f32) + cd * eye) * stepc[..., None]
        cs = cc.to(f32) * stepc
        lam = s.to(f32) * stepc
        zero_row = torch.zeros((spec.width,), dtype=x0.dtype, device=dev)
        return ops.inner_loop_affine(x0, Hs, cs, zero_row, lam, 1.0, 0.0, int(K))

    grad_a, _native = arena_grad(grad_fn, spec)
    const = bool((nc.cd == nc.cd[0]).all() and (nc.step == nc.step[0]).all())
    if const:
        rho_eff, stp = float(nc.cd[0]), float(nc.step[0])
        zero_row = torch.zeros((spec.width,), dtype=x0.dtype, device=dev)

        def one_step(x, b):
            return ops.fused_update_arena(x, grad_a(x, b), zero_row, s, stp, rho_eff)
    else:
        stp = nc.step_t[:, None]
        cd = nc.cd_t[:, None]
        sf = s.to(f32)

        def one_step(x, b):
            g = grad_a(x, b).to(f32)
            xf = x.to(f32)
            return (xf - stp * (g + cd * xf + sf)).to(x0.dtype)

    steps = T.leaves(batch)[0].shape[0] if per_step else K
    x, xsum = x0, torch.zeros_like(x0)
    for k in range(steps):
        b = T.tmap(lambda a: a[k], batch) if per_step else batch
        x = one_step(x, b)
        xsum = xsum + x
    return x, xsum * (1.0 / K)


# ---------------------------------------------------------------------------
# one firing phase (a colour class, or all nodes under the sync schedule)
# ---------------------------------------------------------------------------

def _phase(cfg, topo, tab, ph, spec, x, z, fn, batch, per_step, pmask, fplan, c, exact):
    """The nodes of ``ph`` fire: re-reduce the duals, update their primal
    rows, flip the duals on their incident edges.  ``pmask`` ((n_data,)
    bool or None) silences data nodes (participation and the plan's
    silence); ``fplan`` corrupts the transmitted ``x_ref`` of firing data
    nodes; screening compares each transmission with the node's own
    round-start carry and demotes outliers (their carry reverts, their
    flips are masked).  Returns ``(x, z, demoted_count)``."""
    s = ops.neighbor_reduce(z, seg=topo.src, first=tab.first, sgn=topo.sgn, n=topo.n)
    f32, dev = torch.float32, x.device
    x_flip = x
    keep = None
    demoted = torch.zeros((), dtype=f32, device=dev)

    if ph.dm.size:
        dm, dm_t = ph.dm, ph.dm_t
        x0 = x[dm_t]
        s_dm = s[dm_t]
        if exact:
            # x_i = prox_{f_i, c d_i}(-s_i / (c d_i)), a per-node rho
            rho_dm = ph.data.cd_t
            if _prox_takes_idx(fn):
                # only the firing subset's data
                v_rows = -s_dm.to(f32) / rho_dm[:, None]
                x_cand = spec.pack_stacked(
                    fn(spec.unpack_stacked(v_rows.to(x.dtype)), rho_dm, idx=dm_t))
            else:
                # a plain prox closes over data for all n_data nodes:
                # evaluate at the full stacking, keep the firing rows
                nd = topo.n_data
                rho_all = tab.cd_data
                v_rows = -s[:nd].to(f32) / rho_all[:, None]
                x_all = spec.pack_stacked(fn(spec.unpack_stacked(v_rows.to(x.dtype)), rho_all))
                x_cand = x_all[dm_t]
            x_ref = x_cand
        else:
            take = (lambda a: a[:, dm_t]) if per_step else (lambda a: a[dm_t])
            b_dm = None if batch is None else T.tmap(take, batch)
            x_K, x_bar = inner_steps_graph(
                spec, fn, x0, s_dm, b_dm, K=cfg.inner_steps, nc=ph.data, per_step=per_step)
            x_cand = x_K  # the primal carry
            x_ref = x_bar if cfg.use_avg else x_K  # what the dual flip sees
        # the wire corrupts the transmitted x_ref; the local carry stays
        plan_dm = faults.take(fplan, dm_t)
        x_ref = faults.inject(cfg.faults, plan_dm, x_ref)
        if faults.screening_on(cfg):
            keep = faults.screen_keep(cfg, x_ref, x0)
            sub_alive = (torch.ones(dm.size, dtype=torch.bool, device=dev) if pmask is None
                         else pmask[dm_t])
            demoted = torch.sum((sub_alive & ~keep).to(f32))
        sub = None if pmask is None else pmask[dm_t]
        sub = faults.combine_mask(sub, None, keep)
        if sub is not None:
            # demoted == silent: the carry reverts too
            x_cand = torch.where(sub[:, None], x_cand, x0)
            x_ref = torch.where(sub[:, None], x_ref, x0)
        x = x.index_copy(0, dm_t, x_cand)
        x_flip = x.index_copy(0, dm_t, x_ref)

    if ph.am.size:
        # f = 0 nodes (the star's centre): x = -s / (c d)
        x_aux = (-s[ph.am_t].to(f32) / ph.cd_am[:, None]).to(x.dtype)
        x = x.index_copy(0, ph.am_t, x_aux)
        x_flip = x_flip.index_copy(0, ph.am_t, x_aux)

    dyn = pmask
    if keep is not None:
        # this phase's keep over the data nodes; non-firing rows stay True
        # (the static members mask them anyway)
        keep_full = torch.ones(topo.n_data, dtype=torch.bool, device=dev).index_copy(
            0, ph.dm_t, keep)
        dyn = keep_full if dyn is None else dyn & keep_full
    if dyn is None:
        mask = ph.static_mask
    else:
        fire_nodes = torch.cat([ph.fired_data & dyn, ph.fired_aux])
        mask = fire_nodes[tab.nbr_t].to(torch.int32)
    z = ops.edge_flip(z, x_flip, c, rev=topo.rev, nbr=topo.nbr, sgn=topo.sgn, mask=mask)
    return x, z, demoted


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def _round(cfg: FederatedConfig, state, fn, batch, per_step_batches=False, *, exact: bool):
    c = resolved_rho(cfg)
    spec = arena.ArenaSpec.from_tree(state["x_s"])
    x, z = state["x"], state["z"]
    topo = topo_for(cfg, _n_data_of(cfg, x.shape[0]))
    tab = tables(cfg, topo, x.device)

    pmask = None
    if cfg.participation < 1.0:
        pmask = T.participation_mask(participation_key(cfg, state["round"]), topo.n_data,
                                     cfg.participation)
    # the round's fault plan over the data nodes; silence folds into the
    # firing mask (a silent node neither updates nor flips)
    fplan = faults.plan(cfg, state["round"], topo.n_data)
    if fplan is not None:
        alive = ~fplan.silent
        pmask = alive if pmask is None else pmask & alive

    f32 = torch.float32
    demoted = torch.zeros((), dtype=f32, device=x.device)
    for ph in tab.phases:
        x, z, dem = _phase(cfg, topo, tab, ph, spec, x, z, fn, batch, per_step_batches, pmask,
                           fplan, c, exact)
        demoted = demoted + dem

    # consensus estimate: the aux centre's row on a star (the centralised
    # x_s), the node mean otherwise
    est_row = x[topo.n_data].clone() if topo.n_aux else torch.mean(x, dim=0)
    xf = x.to(f32)
    consensus = torch.mean(torch.sum(torch.square(xf[tab.src_t] - xf[tab.nbr_t]), dim=1)) * 0.5
    new_state = {
        "x_s": spec.unpack(est_row),
        "x": x,
        "z": z,
        "round": state["round"] + 1,
    }
    metrics = {
        "consensus_err": consensus,
        "used_arena": torch.ones((), dtype=f32, device=x.device),
    }
    if fplan is not None or faults.screening_on(cfg):
        metrics["faults_injected"] = (
            torch.zeros((), dtype=f32, device=x.device) if fplan is None
            else torch.sum((fplan.silent | fplan.corrupt).to(f32)))
        metrics["faults_demoted"] = demoted
    return new_state, metrics


def _make(cfg: FederatedConfig, *, exact: bool, name: str) -> FedOpt:
    if cfg.uplink_bits is not None:
        raise NotImplementedError(
            "EF21 uplink quantisation integrates ONE cached server view per "
            "client; graph-PDMM exchanges one directed dual per edge, so a "
            "per-client integrator does not apply (a per-EDGE integrator is "
            "future work)"
        )
    if not exact and cfg.variance_reduction is not None:
        raise NotImplementedError(
            "variance reduction is not wired for graph-PDMM yet "
            "(snapshot gradients need a per-node consensus reference)"
        )

    def init(params, m):
        topo = topo_for(cfg, m)
        spec = arena.ArenaSpec.from_tree(params)
        row = spec.pack(params)
        c = resolved_rho(cfg)
        return {
            "x_s": params,
            "x": row[None].expand(topo.n, spec.width).contiguous(),
            "z": edge_duals_init(topo, row, c),
            "round": round_counter(params),
        }

    return FedOpt(name=name, init=init, round=partial(_round, cfg, exact=exact),
                  server_params=lambda s: s["x_s"])


def make(cfg: FederatedConfig) -> FedOpt:
    """Gradient-based graph-PDMM (the decentralized GPDMM)."""
    return _make(cfg, exact=False, name="gpdmm_graph")


def make_exact(cfg: FederatedConfig) -> FedOpt:
    """Exact (prox-oracle) graph-PDMM; ``round(state, prox_fn, batch)``."""
    return _make(cfg, exact=True, name="pdmm_graph")


__all__ = ["edge_duals_init", "inner_steps_graph", "make", "make_exact", "tables", "topo_for"]
