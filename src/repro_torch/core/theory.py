"""Convergence-theory instruments for GPDMM (Theorem 1), ported from
``src/repro/core/theory.py``.

* ``gpdmm_beta``    -- the linear rate bound beta of Theorem 1 (Python
  floats, the reference's arithmetic).
* ``q_functional``  -- the Lyapunov quantity Q^r of eq. (35) on a traced
  round's tensors; Q^{r+1} <= beta Q^r along real GPDMM trajectories.
* ``kkt_residuals`` -- the three KKT conditions of eq. (7) at the current
  iterates (primal gap, dual feasibility, gradient match).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core.api import resolved_rho


def gpdmm_gammas(L: float, mu: float, eta: float, rho: float, theta: float, phi: float):
    g1 = min((1.0 - theta) / (2.0 * L * eta**2), (1.0 / eta - L) / 2.0)
    g2 = min(theta * mu * phi / (2.0 * rho**2), g1 * eta**2 / 2.0)
    return g1, g2


def gpdmm_beta(L: float, mu: float, eta: float, rho: float, theta: float = 0.5, phi: float = 0.5) -> float:
    """Theorem 1 rate: Q^{r+1} <= beta Q^r, requires 1/eta > L >= mu > 0,
    theta, phi in (0,1) with theta*mu*phi/(4 rho^2) < 1/(4 rho)."""
    assert 1.0 / eta > L >= mu > 0, (eta, L, mu)
    assert 0 < theta < 1 and 0 < phi < 1
    assert theta * mu * phi / (4 * rho**2) < 1.0 / (4 * rho), "phi too large for this rho"
    _, g2 = gpdmm_gammas(L, mu, eta, rho, theta, phi)
    b1 = (1.0 / (4 * rho) - g2 / 2.0) / (1.0 / (4 * rho))
    b2 = (1.0 / eta - theta * mu) / (1.0 / eta - theta * mu * phi)
    beta = max(b1, b2)
    assert 0 < beta < 1, beta
    return beta


def q_functional(
    cfg: FederatedConfig,
    *,
    x_c_prev,  # stacked (m, d): x_i^{r-1,K}
    x_bar,  # stacked (m, d): x-bar_i^{r,K}
    lam_is,  # stacked (m, d): lam_{i|s}^{r+1}
    x_star,  # (d,)
    lam_star,  # (m, d): lam*_{i|s} = grad f_i(x*)
    L: float,
    mu: float,
    theta: float = 0.5,
    phi: float = 0.5,
) -> torch.Tensor:
    """Q^r of eq. (35) for vector-valued least-squares states (a 0-d
    tensor on the states' device)."""
    rho = resolved_rho(cfg)
    eta, K = cfg.eta, cfg.inner_steps
    _, g2 = gpdmm_gammas(L, mu, eta, rho, theta, phi)
    t1 = (1.0 / eta - theta * mu) / (2.0 * K) * torch.sum((x_c_prev - x_star[None]) ** 2)
    resid = rho * (x_bar - x_star[None]) + (lam_is - lam_star)
    t2 = (1.0 / (4 * rho) - g2 / 2.0) * torch.sum(resid**2)
    return t1 + t2


def kkt_residuals(problem, x_s, lam_s) -> dict:
    """Residuals of eq. (7) on the least-squares problem.

    lam_s: stacked (m, d) server duals lam_{s|i}; lam_{i|s} = -lam_{s|i} at a
    fixed point.  Returns a dict of 0-d tensors, all -> 0 at the optimum.
    """
    grad_at_xs = torch.einsum("mde,e->md", problem.AtA, x_s) - problem.Atb
    return {
        "grad_match": torch.linalg.vector_norm(grad_at_xs - (-lam_s)) / problem.m,
        "dual_sum": torch.linalg.vector_norm(lam_s.sum(0)),
        "primal_gap": problem.gap(x_s),
    }
