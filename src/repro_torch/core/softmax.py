"""Softmax regression, the objective of the paper's Table I (ported from
``src/repro/core/softmax.py``).  Parameters are one flat ``(F*C + C,)``
vector: the row-major weight matrix W (F, C) followed by the bias b (C,).

``oracle()`` carries the closed-form arena gradient

    err = (softmax(x W + b) - onehot(y)) / B,   gW = x^T err,   gb = sum_b err

evaluated directly on the packed ``(m, width)`` buffer, and the
``curvature_arena`` bound of ``eta="auto"``.  The gradient is not affine, so
rounds take one ``fused_update_arena`` kernel per inner step.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as nnf

from repro_torch.core.api import make_oracle
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class SoftmaxRegression:
    n_features: int = 784
    n_classes: int = 10

    @property
    def dim(self) -> int:
        return self.n_features * self.n_classes + self.n_classes

    def unravel(self, w):
        F, C = self.n_features, self.n_classes
        return w[: F * C].reshape(F, C), w[F * C:]

    def init_params(self, device="cuda"):
        return torch.zeros((self.dim,), dtype=torch.float32, device=resolve(device))

    def _onehot(self, y):
        return nnf.one_hot(y.long(), self.n_classes).to(torch.float32)

    def loss(self, w, batch):
        """Mean cross-entropy; batch = {"x": (B, F), "y": (B,) int labels}."""
        W, b = self.unravel(w)
        logp = torch.log_softmax(batch["x"] @ W + b, dim=-1)
        return -torch.mean(torch.sum(self._onehot(batch["y"]) * logp, dim=-1))

    def accuracy(self, w, x, y):
        W, b = self.unravel(w)
        pred = torch.argmax(x @ W + b, dim=-1)
        return torch.mean((pred == y).to(torch.float32))

    def grad(self, w, batch):
        """Closed-form gradient of ``loss``."""
        W, b = self.unravel(w)
        p = torch.softmax(batch["x"] @ W + b, dim=-1)
        err = (p - self._onehot(batch["y"])) / batch["y"].shape[-1]
        gW = batch["x"].T @ err
        return torch.cat([gW.reshape(-1), torch.sum(err, dim=0)])

    def oracle(self):
        F, C = self.n_features, self.n_classes

        def grad_arena(spec):
            (e,) = spec.leaves
            if e.size != self.dim:
                raise ValueError(f"arena leaf has {e.size} entries, expected {self.dim}")
            w = spec.width

            def ga(xa, batch):
                m = xa.shape[0]
                W = xa[:, : F * C].reshape(m, F, C)
                b = xa[:, F * C: F * C + C]
                logits = torch.einsum("mbf,mfc->mbc", batch["x"], W) + b[:, None]
                p = torch.softmax(logits, dim=-1)
                err = (p - self._onehot(batch["y"])) / batch["y"].shape[-1]
                gW = torch.einsum("mbf,mbc->mfc", batch["x"], err)
                g = torch.cat([gW.reshape(m, F * C), torch.sum(err, dim=1)], dim=-1)
                return nnf.pad(g, (0, w - self.dim)) if w != self.dim else g

            return ga

        def curvature_arena(spec):
            # The cross-entropy Hessian is (1/B) sum_b G_b kron (diag(p_b) -
            # p_b p_b^T) over augmented features [x_b | 1]; lambda_max of the
            # second factor is at most 1/2, so L_i <= lambda_max(Xa_i^T Xa_i)
            # / (2B): a point-free upper bound (the safe side for a
            # stepsize), by batched power iteration on the Gram blocks
            def curv(xa, batch):
                from repro_torch.core import autotune

                x = batch["x"]  # (m, B, F)
                B = x.shape[1]
                ones = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
                xaug = torch.cat([x, ones], dim=-1)
                G = torch.einsum("mbf,mbg->mfg", xaug, xaug) / (2.0 * B)
                return autotune.power_iter_arena(G)

            return curv

        return make_oracle(self.grad, grad_arena=grad_arena, curvature_arena=curvature_arena)
