"""Deterministic fault injection and screening to silence, ported from
``src/repro/core/faults.py`` (the robustness layer under every centralised
round engine; ``docs/robustness.md``).

Client faults map onto the silence contract the rounds already keep for
partial participation:

* a **silent** client (dropout, straggler) never returns this round: the
  server uses its cached ``u_hat`` row and the client keeps its carry;
* a **delayed** client's uplink is in flight ``s`` rounds
  (``core.staleness``) when the bounded-staleness engine is on
  (``async_on``), else ``delay`` is one more silence class; a lateness past
  ``deadline`` is demoted to silence when the plan is drawn;
* a **corrupt** client transmits, but the wire mangles the row (all NaN,
  all Inf, sign flip, or ``blowup`` times the row).  Screening
  (``ops.screen_keep``, kernel 11 with the outlier rule in its launch)
  finds such rows by their finite flag and their squared deviation from the
  downlink row, and the server demotes them to silent for the round.

Every draw is a pure function of ``(FaultConfig.seed, round, client)``: the
round counter is folded into the fault seed with the port's bit-exact
``jax.random`` (``core.prng``), on the counter's device, so the plan equals
the reference's integer for integer and no round copies from the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import prng
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops, ref

# corruption classes, indexed by FaultPlan.kind
KINDS = ("nan", "inf", "sign", "blowup")
# fault-RNG fold ids are positional here (0 = dropout, 1 = straggler,
# 2 = delay); corrupt folds at 3, kind at 4, lateness at 5.  Delay keeps
# fold id 2 whether it is silence or staleness, so silent | delayed is the
# same client set either way.
_SILENCE_CLASSES = ("dropout", "straggler", "delay")


class FaultPlan(NamedTuple):
    """The round's fault draw over the client population, (m,) tensors:
    ``silent``, ``corrupt`` (disjoint from silent and delayed) and
    ``delayed`` bools; ``kind`` (index into ``KINDS``) and ``lateness``
    (rounds late of a delayed client, else 0) int32."""

    silent: torch.Tensor
    corrupt: torch.Tensor
    kind: torch.Tensor
    delayed: torch.Tensor
    lateness: torch.Tensor


def async_on(cfg: FederatedConfig) -> bool:
    """Does this config run the bounded-staleness engine?  It needs a
    ``delay`` schedule on the star; ``async_rounds="auto"`` engages when
    ``max_staleness > 0`` or ``deadline`` is finite."""
    fc = cfg.faults
    if fc is None or fc.delay <= 0.0 or cfg.topology != "star":
        return False
    if cfg.async_rounds == "auto":
        return cfg.max_staleness > 0 or math.isfinite(cfg.deadline)
    return bool(cfg.async_rounds)


def fault_key(fc: FaultConfig, round_idx):
    """The round's fault key: the round counter folded into the fault seed
    (independent of the data and participation seeds)."""
    return prng.fold_in(prng.key(fc.seed), round_idx)


def plan(cfg: FederatedConfig, round_idx, m: int) -> Optional[FaultPlan]:
    """The round's fault plan over m clients, or None without a fault
    schedule.  On the device of ``round_idx`` (the CPU for a Python int)."""
    fc = cfg.faults
    if fc is None or not fc.any:
        return None
    dev = round_idx.device if torch.is_tensor(round_idx) else torch.device("cpu")
    key = fault_key(fc, round_idx)

    def draw(cls_id: int, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return torch.zeros(m, dtype=torch.bool, device=dev)
        if rate >= 1.0:
            return torch.ones(m, dtype=torch.bool, device=dev)
        return prng.bernoulli(prng.fold_in(key, cls_id), rate, m, dev)

    a_on = async_on(cfg)
    silent = torch.zeros(m, dtype=torch.bool, device=dev)
    delayed = torch.zeros(m, dtype=torch.bool, device=dev)
    for cls_id, name in enumerate(_SILENCE_CLASSES):
        hit = draw(cls_id, getattr(fc, name))
        if name == "delay" and a_on:
            delayed = hit & ~silent
        else:
            silent = silent | hit
    lateness = torch.zeros(m, dtype=torch.int32, device=dev)
    if a_on:
        lateness = prng.randint(prng.fold_in(key, 5), m, 1, fc.delay_max + 1, dev)
        lateness = torch.where(delayed, lateness, 0)
        if math.isfinite(cfg.deadline):
            # past the deadline: silence, decided here, never buffered
            late = delayed & (lateness.to(torch.float32) > float(np.float32(cfg.deadline)))
            silent = silent | late
            delayed = delayed & ~late
            lateness = torch.where(delayed, lateness, 0)
    corrupt = draw(3, fc.corrupt) & ~silent & ~delayed
    kind = prng.randint(prng.fold_in(key, 4), m, 0, len(KINDS), dev)
    return FaultPlan(silent=silent, corrupt=corrupt, kind=kind, delayed=delayed,
                     lateness=lateness)


def take(plan_: Optional[FaultPlan], idx) -> Optional[FaultPlan]:
    """The plan restricted to the rows ``idx`` (the round's cohort)."""
    if plan_ is None:
        return None
    return FaultPlan(*(f[idx] for f in plan_))


def _mangle(fc: FaultConfig, kind, corrupt, u):
    """The wire's corruption of the rows of ``u`` (f32) where ``corrupt``:
    by ``kind``, NaN, Inf, -u or blowup * u; ``kind`` and ``corrupt`` are
    shaped to broadcast against u."""
    bad = torch.where(kind == 0, math.nan,
                      torch.where(kind == 1, math.inf,
                                  torch.where(kind == 2, -u, float(np.float32(fc.blowup)) * u)))
    return torch.where(corrupt, bad, u)


def inject(fc: Optional[FaultConfig], plan_: Optional[FaultPlan], uplink):
    """The transmitted (rows, W) uplink after the wire's corruption; no-op
    without a plan or a corrupt rate."""
    if plan_ is None or fc is None or fc.corrupt <= 0.0:
        return uplink
    u = uplink.to(torch.float32)
    return _mangle(fc, plan_.kind[:, None], plan_.corrupt[:, None], u).to(uplink.dtype)


def inject_tree(fc: Optional[FaultConfig], plan_: Optional[FaultPlan], uplink):
    """``inject`` over a stacked client tree (leading dim m on every leaf)."""
    if plan_ is None or fc is None or fc.corrupt <= 0.0:
        return uplink

    def one(u):
        shape = (-1,) + (1,) * (u.ndim - 1)
        uf = u.to(torch.float32)
        return _mangle(fc, plan_.kind.reshape(shape), plan_.corrupt.reshape(shape),
                       uf).to(u.dtype)

    return T.tmap(one, uplink)


def screening_on(cfg: FederatedConfig) -> bool:
    """``screen="auto"`` screens exactly when a fault schedule is set (a
    delay-only schedule included); True/False force it."""
    if cfg.screen == "auto":
        return cfg.faults is not None and cfg.faults.any
    return bool(cfg.screen)


def needs_cache(cfg: FederatedConfig) -> bool:
    """Must the server hold the ``u_hat`` cache for faults: any fault
    schedule (silent clients fall back to it) or any screening (demoted
    clients do)?"""
    return screening_on(cfg) or (cfg.faults is not None and cfg.faults.any)


# ``jnp.nanmedian`` of a 1-D f32 tensor: jax's interpolated median of the
# non-NaN values, NaN when there is none
nanmedian = ref.nanmedian_ref


def _keep_from(cfg: FederatedConfig, finite, sq):
    """Keep = finite, and not a norm outlier: sq at most ``screen_mult``
    times the median sq over the rows that screened finite
    (``kernels.ref.keep_from_ref``)."""
    return ref.keep_from_ref(finite, sq, cfg.screen_mult)


def screen_keep(cfg: FederatedConfig, uplink, ref_rows):
    """The (rows,) keep mask of a (rows, W) uplink screened against the
    downlink ``ref_rows`` ((W,), or (rows, W) per row): one ``screen_keep``
    launch on the card (kernel 11's pass with the rule of ``_keep_from`` in
    it, the median selected on the device), ``screen_uplink`` then the rule
    on the CPU."""
    return ops.screen_keep(uplink, ref_rows, cfg.screen_mult)


def screen_keep_tree(cfg: FederatedConfig, uplink, ref_tree):
    """``screen_keep`` over a stacked client tree against the server tree;
    the flags and deviations reduce over every leaf (plain tensor code, as
    in the reference)."""
    leaves_u, leaves_r = T.leaves(uplink), T.leaves(ref_tree)
    m, dev = leaves_u[0].shape[0], leaves_u[0].device
    f32 = torch.float32
    finite = torch.ones(m, dtype=torch.bool, device=dev)
    sq = torch.zeros(m, dtype=f32, device=dev)
    for u, r in zip(leaves_u, leaves_r):
        uf = u.to(f32).reshape(m, -1)
        rf = r.to(f32).reshape(1, -1)
        fin_e = torch.isfinite(uf)
        d = torch.where(fin_e, uf - rf, 0.0)
        finite = finite & torch.all(fin_e, dim=1)
        sq = sq + torch.sum(d * d, dim=1)
    return _keep_from(cfg, finite, sq)


def combine_mask(mask, plan_: Optional[FaultPlan], keep):
    """The participation mask AND the plan's non-silent clients AND the
    screen's keep mask: the round's effective active mask (None = all)."""
    out = mask
    if plan_ is not None:
        alive = ~plan_.silent
        out = alive if out is None else out & alive
    if keep is not None:
        out = keep if out is None else out & keep
    return out


def fault_metrics(plan_: Optional[FaultPlan], transmitters, keep) -> dict:
    """The round's fault counters, f32 scalars: ``faults_injected``
    (clients the schedule hit: silent, corrupt or delayed) and
    ``faults_demoted`` (transmitting clients the screen silenced)."""
    f32 = torch.float32
    dev = (plan_.silent if plan_ is not None else keep).device
    injected = (torch.zeros((), dtype=f32, device=dev) if plan_ is None
                else torch.sum((plan_.silent | plan_.corrupt | plan_.delayed).to(f32)))
    if keep is None:
        demoted = torch.zeros((), dtype=f32, device=dev)
    else:
        t = torch.ones_like(keep) if transmitters is None else transmitters
        demoted = torch.sum((t & ~keep).to(f32))
    return {"faults_injected": injected, "faults_demoted": demoted}


__all__ = [
    "KINDS", "FaultPlan", "async_on", "combine_mask", "fault_key", "fault_metrics", "inject",
    "inject_tree", "nanmedian", "needs_cache", "plan", "screen_keep", "screen_keep_tree",
    "screening_on", "take",
]
