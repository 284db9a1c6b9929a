"""Minimal optax-style optimizers as (init, update) pairs over parameter
trees, the port of ``src/repro/optim/optimizers.py``.

The federated core has its own update rules (GPDMM's prox-gradient step);
these are the plain local optimizers for the non-federated baselines and
the serving-side tooling.  Trees are the port's (``core.tree_util``): the
state's tensors lie on the parameters' device, and ``step`` is an int32
tensor there.

The reference's scalars meet tensors by JAX's promotion rules, which the
port spells out: a Python learning rate or coefficient is weakly typed
(rounded to a bf16 leaf's dtype first, ``tree_util.weak``); a schedule's
learning rate is an f32 tensor, which promotes a bf16 gradient to f32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import tree_util as T
from repro_torch.core.tree_util import weak

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _times(s, x):
    """s * x as JAX forms it: a Python s weakly typed against x; an f32
    tensor s (a schedule's) promoting x to f32 where x is narrower."""
    if torch.is_tensor(s):
        return s * x.to(torch.promote_types(s.dtype, x.dtype))
    return weak(s, x) * x


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params):
    leaves = T.leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else "cpu")


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """Plain or heavy-ball SGD: m' = momentum m + g, update -lr(step) m'
    (-lr(step) g without momentum), step counted from 1."""
    lr_fn = _lr_fn(lr)

    def init(params):
        mom = T.tmap(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mom": mom}

    def update(grads, state, params=None):
        step = state["step"] + 1
        neg = -lr_fn(step)
        if momentum:
            mom = T.tmap(lambda m, g: weak(momentum, m) * m + g, state["mom"], grads)
            return T.tmap(lambda m: _times(neg, m), mom), {"step": step, "mom": mom}
        return T.tmap(lambda g: _times(neg, g), grads), {"step": step, "mom": None}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with f32 moments and bias correction by b1^t, b2^t in f32;
    decoupled weight decay on the f32 parameter; each update cast back to
    its parameter's dtype."""
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = T.tmap(lambda p: torch.zeros_like(p, dtype=_F32), params)
        return {"step": _step0(params), "mu": zeros,
                "nu": T.tmap(lambda p: torch.zeros_like(p, dtype=_F32), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        mu = T.tmap(lambda m, g: b1 * m + (1 - b1) * g.to(_F32), state["mu"], grads)
        nu = T.tmap(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(_F32)), state["nu"],
                    grads)
        t = step.to(_F32)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        neg = -lr_fn(step)

        def one(m, v, p):
            d = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.to(_F32)
            return (neg * d).to(p.dtype)

        return T.tmap(one, mu, nu, params), {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params, updates):
    """p + u, the update cast to its parameter's dtype first."""
    return T.tmap(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(||g||, 1e-9)), ||g||): the
    global norm over every leaf's f32 squares."""
    sq = [torch.sum(torch.square(g.to(_F32))) for g in T.leaves(grads)]
    gn = torch.sqrt(sum(sq[1:], sq[0]))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return T.tmap(lambda g: _times(scale, g), grads), gn
