"""Auto-tuned stepsizes and residual-based early termination, ported from
``src/repro/core/autotune.py``.

  * **Per-client smoothness L_i**: a batched power iteration over the
    per-client Hessian blocks on the stacked ``(m, ...)`` operands (no loop
    over clients).  Affine oracles (``affine_arena``: grad_i(x) = H_i x -
    c_i) power-iterate their H blocks; other oracles fall back to a
    Hessian-vector power iteration through ``torch.func.jvp`` (forward
    mode, as the reference's ``jax.jvp``).  An oracle may override both
    with a ``curvature_arena`` hook (``core.api`` protocol).
  * **Derived stepsizes**: eta_i = safety / L_i.  ``resolve`` turns
    ``eta="auto"`` into the per-client tuple; the kernels take it as a
    per-client stepsize operand.
  * **Residual-based stopping**: ``state_residual`` folds one
    ``ops.residual_norm`` kernel per 2-D state buffer into two scalars
    (``res_dx2``/``res_x2``); the host's ``EarlyExit`` stops the run once
    sqrt(res_dx2 / res_x2) stays below ``tol`` for ``patience`` rounds.

The matvecs of the power iteration are ``torch.einsum`` (batched matrix
products outside any kernel, as the reference leaves them to XLA).  An
oracle whose gradient launches one of the port's CUDA kernels cannot be
differentiated with ``torch.func.jvp`` (a ctypes call reads raw pointers):
the HVP fallbacks raise an error naming the oracle there, never a silent
wrong tangent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena
from repro_torch.core import tree_util as T
from repro_torch.kernels import _args, ops

# Power-iteration budget: the Rayleigh quotient converges as
# (lambda_2/lambda_1)^(2k).
POWER_ITERS = 96

# 1/eta_i = L_i / safety must exceed L_i (the theory's contraction
# condition); 0.5 doubles the margin.
SAFETY = 0.5


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _v0(m: int, w: int, device):
    """The reference's start vector: a constant plus a ramp (never
    orthogonal to a top eigenvector a ones vector could miss).  Padded
    coordinates are annihilated by the first multiply."""
    ramp = torch.linspace(0.0, 0.5, w, dtype=torch.float32, device=device)
    return (1.0 + ramp).expand(m, w)


def power_iter_arena(H, iters: int = POWER_ITERS):
    """Largest eigenvalue of each PSD block of ``H (m, W, W)`` by batched
    power iteration.  Returns ``L (m,)`` f32, the Rayleigh quotients of the
    final normalised iterates."""
    m, w, _ = H.shape
    Hf = H.to(torch.float32)
    v = _normalize(_v0(m, w, H.device))
    for _ in range(iters):
        v = _normalize(torch.einsum("mij,mj->mi", Hf, v))
    return torch.einsum("mi,mij,mj->m", v, Hf, v)


def power_iter_hvp(hvp, m: int, w: int, iters: int = POWER_ITERS, device="cpu"):
    """Power iteration through a stacked Hessian-vector product
    ``hvp(v (m, w)) -> (m, w)``.  Returns ``|L| (m,)`` (curvature away from
    a minimum may be indefinite)."""
    v = _normalize(_v0(m, w, device))
    for _ in range(iters):
        v = _normalize(hvp(v))
    return torch.abs(torch.einsum("mi,mi->m", v, hvp(v)))


def _name(fn) -> str:
    return repr(getattr(fn, "__qualname__", None) or type(fn).__name__)


def estimate_L(grad_fn, params, m: int, batch, *, spec=None, iters: int = POWER_ITERS):
    """Per-client smoothness estimates ``L (m,) np.float64`` at ``params``.

    Resolution order (the ``core.api`` oracle protocol):
      1. ``grad_fn.curvature_arena(spec)``, the oracle's own estimator;
      2. ``grad_fn.affine_arena``, power iteration on the H blocks;
      3. ``grad_fn.grad_arena``, HVP power iteration via ``torch.func.jvp``
         of the arena gradient;
      4. plain ``grad_fn``, HVP power iteration via a vmapped per-client
         ``torch.func.jvp`` of the tree gradient.
    """
    if spec is None:
        spec = arena.ArenaSpec.from_tree(params)
    w = spec.width
    dev = T.leaves(params)[0].device

    def host(L):
        # a bf16 model's estimates come back in bf16, which numpy does not
        # take; widening to f32 is exact (the reference's np.float64 cast)
        return _host(L.float() if torch.is_tensor(L) else L).astype(np.float64)

    curv = getattr(grad_fn, "curvature_arena", None)
    if curv is not None:
        x0 = spec.pack(params)[None].expand(m, w)
        return host(curv(spec)(x0, batch))

    affine = getattr(grad_fn, "affine_arena", None)
    if affine is not None:
        H, _ = affine(spec, batch)
        return host(power_iter_arena(H, iters))

    ga_factory = getattr(grad_fn, "grad_arena", None)
    what = f"the oracle {_name(grad_fn)}"
    if ga_factory is not None:
        ga = ga_factory(spec)
        what += f" (its grad_arena {_name(ga)})"
        x0 = spec.pack(params)[None].expand(m, w).contiguous()

        def hvp(v):
            return torch.func.jvp(lambda xa: ga(xa, batch), (x0,), (v,))[1]
    else:
        # the tangent comes out of ``spec.unpack`` with every dict's keys
        # sorted; jvp wants the primal in that same structure
        primal = T.tmap(lambda x: x, params)

        def one(bi, vi):
            tangent = spec.unpack(vi)
            return spec.pack(torch.func.jvp(lambda p: grad_fn(p, bi), (primal,),
                                            (tangent,))[1])

        def hvp(v):
            return torch.func.vmap(one)(batch, v)

    with _args.jvp_target(what):
        return host(power_iter_hvp(hvp, m, w, iters, dev))


def derive_eta(L, safety: float = SAFETY):
    """``eta_i = safety / L_i``, L clamped at 1e-12 (zero curvature takes
    any stepsize)."""
    L = np.maximum(np.asarray(L, np.float64), 1e-12)
    return safety / L


def resolve(cfg: FederatedConfig, grad_fn, params, m: int, batch, *,
            iters: int = POWER_ITERS, safety: float = SAFETY) -> FederatedConfig:
    """Host-side ``eta="auto"`` resolution: estimate L_i, derive eta_i =
    safety / L_i, and return the config with ``eta`` the per-client tuple.
    A no-op (the same object) for a scalar or tuple eta."""
    if cfg.eta != "auto":
        return cfg
    L = estimate_L(grad_fn, params, m, batch, iters=iters)
    eta = derive_eta(L, safety)
    return dataclasses.replace(cfg, eta=tuple(float(e) for e in eta))


def _unresolved():
    return ValueError("eta='auto' must be resolved host-side (core.autotune.resolve) "
                      "before the round is built")


def client_eta(cfg: FederatedConfig, m: Optional[int] = None):
    """The round's eta: a Python float, or an ``(m,) np.float32`` array for
    per-client stepsizes.  Raises on an unresolved ``eta="auto"``."""
    if isinstance(cfg.eta, str):
        raise _unresolved()
    if isinstance(cfg.eta, tuple):
        eta = np.asarray(cfg.eta, np.float32)
        if m is not None and eta.shape != (m,):
            raise ValueError(f"per-client eta has {eta.shape[0]} entries for {m} clients")
        return eta
    return float(cfg.eta)


def mean_eta(cfg: FederatedConfig) -> float:
    """The scalar eta server-side quantities derive from: the mean over
    clients for a per-client tuple, the value otherwise."""
    if isinstance(cfg.eta, str):
        raise _unresolved()
    if isinstance(cfg.eta, tuple):
        return float(np.mean(np.asarray(cfg.eta, np.float64)))
    return float(cfg.eta)


def scale_eta(cfg: FederatedConfig, scale: float) -> FederatedConfig:
    """Every stepsize times ``scale`` (each tuple entry, or the scalar)."""
    if scale == 1.0:
        return cfg
    if isinstance(cfg.eta, tuple):
        return dataclasses.replace(cfg, eta=tuple(float(e) * scale for e in cfg.eta))
    return dataclasses.replace(cfg, eta=cfg.eta * scale)


# ---------------------------------------------------------------------------
# residual-based early termination
# ---------------------------------------------------------------------------

# State entries that converge at the PDMM fixed point, in the reference's
# order; entries an algorithm lacks are skipped, non-float leaves (round
# counters, stale ages) never contribute.
RESIDUAL_KEYS = ("x_s", "x_c", "lam_s", "u_hat", "c_i", "c", "z_s", "x", "z")


def state_residual(prev, new):
    """The round's squared fixed-point residual as two f32 scalars:
    ``res_dx2`` = sum over state buffers of ||new - prev||^2 and ``res_x2``
    = sum of ||new||^2.  2-D ``(rows, W)`` buffers go through one
    ``ops.residual_norm`` kernel each; other float leaves through plain f32
    reductions; summed in key and leaf order."""
    if not (isinstance(prev, dict) and isinstance(new, dict)):
        raise TypeError("state_residual expects dict round states")
    dx2 = x2 = None
    for k in RESIDUAL_KEYS:
        if k not in new or k not in prev:
            continue
        for p, q in zip(T.leaves(prev[k]), T.leaves(new[k])):
            if not q.is_floating_point():
                continue
            if dx2 is None:
                dx2 = torch.zeros((), dtype=torch.float32, device=q.device)
                x2 = torch.zeros((), dtype=torch.float32, device=q.device)
            if q.ndim == 2:
                d_rows, n_rows = ops.residual_norm(q, p)
                dx2 = dx2 + torch.sum(d_rows)
                x2 = x2 + torch.sum(n_rows)
            else:
                qf = q.to(torch.float32)
                d = qf - p.to(torch.float32)
                dx2 = dx2 + torch.sum(d * d)
                x2 = x2 + torch.sum(qf * qf)
    if dx2 is None:
        dx2 = x2 = torch.zeros((), dtype=torch.float32)
    return {"res_dx2": dx2, "res_x2": x2}


class EarlyExit:
    """Host-side tracker of the relative-residual stopping rule.

    ``update`` takes the ``res_dx2``/``res_x2`` of one round or a stacked
    chunk of rounds and returns the 0-based in-chunk index of the round
    after which the run may stop (the round that brings the count of
    consecutive sub-``tol`` rounds to ``patience``), or None.  With
    ``tol=0`` it never fires."""

    def __init__(self, tol: float, patience: int = 1):
        self.tol = float(tol)
        self.patience = int(patience)
        self.hits = 0
        self.last_rel = float("inf")

    def update(self, dx2, x2) -> Optional[int]:
        if self.tol <= 0.0:
            return None
        dx2 = np.atleast_1d(np.asarray(_host(dx2), np.float64))
        x2 = np.atleast_1d(np.asarray(_host(x2), np.float64))
        for j in range(dx2.shape[0]):
            rel = math.sqrt(dx2[j] / max(x2[j], 1e-30))
            self.last_rel = rel
            if rel < self.tol:
                self.hits += 1
                if self.hits >= self.patience:
                    return j
            else:
                self.hits = 0
        return None


def _host(v):
    """A tensor's values on the host (one sync), else ``v`` as it is."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


__all__ = [
    "EarlyExit", "POWER_ITERS", "RESIDUAL_KEYS", "SAFETY", "client_eta", "derive_eta",
    "estimate_L", "mean_eta", "power_iter_arena", "power_iter_hvp", "resolve", "scale_eta",
    "state_residual",
]
