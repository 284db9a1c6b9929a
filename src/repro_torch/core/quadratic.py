"""The paper's least-squares testbed (SSVI-A), ported from
``src/repro/core/quadratic.py``: f_i(x) = 1/2 ||A_i x - b_i||^2 (+ reg/2
||x||^2), A_i ~ N(0, 1)^{n x d}, b_i = A_i y0 + v_i, v_i ~ N(0, noise^2 I).

``oracle()`` returns the gradient annotated with the arena fast paths:
``grad_arena`` on the packed ``(m, width)`` buffer, ``affine_arena``,
the (H, c) the fused K-step kernel consumes, and ``curvature_arena``, the
per-client L_i of ``eta="auto"``.  ``make_client_prox()`` is the
exact prox of every client at once, from the kept eigendecompositions (exact
PDMM and FedSplit).  Like the reference,
``affine_arena`` builds the padded ``H = AtA + reg I`` on every call, i.e.
once per round (about 1.5 GB of traffic at m = d = 500).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as nnf

from repro_torch.core.api import make_oracle
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class LeastSquares:
    AtA: torch.Tensor  # (m, d, d)
    Atb: torch.Tensor  # (m, d)
    btb: torch.Tensor  # (m,)
    evals: torch.Tensor  # (m, d) eigenvalues of AtA (kept for exact PDMM)
    evecs: torch.Tensor  # (m, d, d)
    x_star: torch.Tensor  # (d,) global optimum
    f_star: torch.Tensor  # () optimal value of F = sum_i f_i
    L: float  # max_i lambda_max(AtA_i + reg I)
    mu: float  # min_i lambda_min(AtA_i + reg I)
    reg: float = 0.0

    @property
    def m(self) -> int:
        return self.AtA.shape[0]

    @property
    def d(self) -> int:
        return self.AtA.shape[1]

    # -- oracles -----------------------------------------------------------
    def grad(self, x, client_batch):
        """grad f_i(x) = (AtA_i + reg I) x - Atb_i; client_batch = {"AtA","Atb"}."""
        return client_batch["AtA"] @ x - client_batch["Atb"] + self.reg * x

    def batch(self):
        return {"AtA": self.AtA, "Atb": self.Atb}

    def oracle(self):
        """``grad`` with the arena fast paths; the tree is one flat (d,)
        leaf, so the arena row is ``[x | 0-pad]``."""
        reg = self.reg

        def grad_arena(spec):
            (e,) = spec.leaves
            d, w = e.size, spec.width

            def ga(xa, cb):
                x = xa[:, :d]
                g = torch.einsum("mde,me->md", cb["AtA"], x) - cb["Atb"] + reg * x
                return nnf.pad(g, (0, w - d)) if w != d else g

            return ga

        def affine_arena(spec, cb):
            (e,) = spec.leaves
            d, w = e.size, spec.width
            AtA = cb["AtA"]
            H = AtA + reg * torch.eye(d, dtype=AtA.dtype, device=AtA.device)
            c = cb["Atb"]
            if w != d:
                H = nnf.pad(H, (0, w - d, 0, w - d))
                c = nnf.pad(c, (0, w - d))
            return H, c

        def curvature_arena(spec):
            # L_i = lambda_max(AtA_i + reg I) by batched power iteration on
            # the H blocks the fused inner loop consumes (exact here: the
            # gradient is affine, so the Hessian is H)
            def curv(xa, cb):
                from repro_torch.core import autotune

                H, _ = affine_arena(spec, cb)
                return autotune.power_iter_arena(H)

            return curv

        return make_oracle(self.grad, grad_arena=grad_arena, affine_arena=affine_arena,
                           curvature_arena=curvature_arena)

    def make_client_prox(self):
        """``prox(v, rho, idx=None)``: argmin_x f_i(x) + rho/2 ||x - v_i||^2
        for every client i at once, v ``(m, d)``.  ``rho`` is a scalar or an
        ``(m,)`` tensor; ``idx`` (client indices) restricts the evaluation to
        those clients' data, with the rows of ``v`` and ``rho`` in the same
        order.  AtA + reg I shares AtA's eigenvectors, so the solve is two
        products with them and a division by the shifted eigenvalues."""
        ev, eV, Atb, reg = self.evals, self.evecs, self.Atb, self.reg

        def stacked_prox(v, rho, idx=None):
            e, V, B = (ev, eV, Atb) if idx is None else (ev[idx], eV[idx], Atb[idx])
            r = torch.as_tensor(rho, dtype=torch.float32, device=v.device)
            r = r.expand(v.shape[0])[:, None]
            rhs = B + r * v
            coef = torch.einsum("mji,mj->mi", V, rhs) / (e + reg + r)
            return torch.einsum("mij,mj->mi", V, coef)

        return stacked_prox

    # -- objective ---------------------------------------------------------
    def F(self, x):
        """Global objective sum_i f_i(x) (x: (d,))."""
        quad = torch.einsum("d,mde,e->", x, self.AtA, x)
        lin = torch.einsum("md,d->", self.Atb, x)
        ridge = 0.5 * self.reg * self.m * torch.sum(torch.square(x))
        return 0.5 * quad - lin + 0.5 * torch.sum(self.btb) + ridge

    def gap(self, x):
        return self.F(x) - self.f_star

    def dist(self, x):
        """||x - x*|| (accurate through convergence, unlike the f32 gap)."""
        return torch.linalg.vector_norm(x - self.x_star)


def generate(gen: torch.Generator, m: int, n: int, d: int, noise_std: float = 0.5,
             device="cuda") -> LeastSquares:
    """Draw a problem from ``gen`` (on the generator's device) and build it
    on ``device``.  The batched ``eigh`` of the m Gram matrices is the slow
    part of set-up (seconds at m = d = 500 on a card)."""
    dev = resolve(device)
    draw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    A = torch.randn((m, n, d), **draw).to(dev)
    y0 = torch.randn((d,), **draw).to(dev)
    v = noise_std * torch.randn((m, n), **draw).to(dev)
    b = torch.einsum("mnd,d->mn", A, y0) + v

    AtA = torch.einsum("mnd,mne->mde", A, A)
    Atb = torch.einsum("mnd,mn->md", A, b)
    btb = torch.einsum("mn,mn->m", b, b)
    del A
    evals, evecs = torch.linalg.eigh(AtA)

    H = AtA.sum(0)
    g = Atb.sum(0)
    x_star = torch.linalg.solve(H, g)
    f_star = 0.5 * x_star @ H @ x_star - g @ x_star + 0.5 * btb.sum()
    return LeastSquares(
        AtA=AtA, Atb=Atb, btb=btb, evals=evals, evecs=evecs, x_star=x_star,
        f_star=f_star, L=float(evals[:, -1].max()), mu=float(evals[:, 0].min()),
    )
