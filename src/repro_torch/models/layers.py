"""Shared layers: norms, rotary embeddings, the gated MLP, embedding and
head, and the init helpers; the port of ``src/repro/models/layers.py``.

Parameters are plain nested dicts of tensors, laid out as the reference's
(``convert.model_params`` carries its trees across).  The init functions
take ``keys``, a source of draws with the reference's ``split`` /
``fold_in`` / ``normal`` tree (``Keys``): ``Keys.from_key`` walks a
``core.prng`` key through that tree, so the draws are the reference's
(``prng.normal`` is ``jax.random.normal`` to a few f32 roundings, which
bf16 mostly absorbs); ``Keys.from_generator`` makes every split the same
``torch.Generator``, which then draws in the tree's order (the serving
path's init: the same distributions, not the reference's numbers).  The
f32 upcasts and the casts back sit where the reference has them.
``torch.var`` defaults to the unbiased variance and ``jnp.var`` is the
population one, so the norms pass ``correction=0``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class Keys:
    """A source of N(0, 1) f32 draws on ``device`` with the reference's key
    tree: ``split(n)``, ``fold_in(i)``, ``normal(shape)`` (see the module
    doc)."""

    def __init__(self, key=None, gen: Optional[torch.Generator] = None, device=None):
        self.key, self.gen = key, gen
        self.device = torch.device(device) if device is not None else gen.device

    @classmethod
    def from_key(cls, key, device) -> "Keys":
        return cls(key=key, device=device)

    @classmethod
    def from_generator(cls, gen: torch.Generator) -> "Keys":
        return cls(gen=gen)

    def split(self, n: int) -> list:
        if self.gen is not None:
            return [self] * n
        return [Keys(key=k, device=self.device) for k in prng.split(self.key, self.device, n)]

    def fold_in(self, i: int) -> "Keys":
        if self.gen is not None:
            return self
        return Keys(key=prng.fold_in(self.key, i), device=self.device)

    def normal(self, shape) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.gen is not None:
            return torch.randn(shape, generator=self.gen, device=self.device,
                               dtype=torch.float32)
        return prng.normal(self.key, math.prod(shape), self.device).reshape(shape)

    def uniform(self, shape, minval: float, maxval: float) -> torch.Tensor:
        """U(minval, maxval) f32, as ``jax.random.uniform`` with bounds."""
        shape = tuple(int(s) for s in shape)
        if self.gen is not None:
            u = torch.rand(shape, generator=self.gen, device=self.device, dtype=torch.float32)
            return torch.clamp_min(u * (maxval - minval) + minval, minval)
        return prng.uniform_range(self.key, math.prod(shape), minval, maxval,
                                  self.device).reshape(shape)


def as_keys(src, device=None) -> Keys:
    """``src`` as a ``Keys``: a generator, a ``core.prng`` key (drawn on
    ``device``) or a ``Keys`` already."""
    if isinstance(src, Keys):
        return src
    if isinstance(src, torch.Generator):
        return Keys.from_generator(src)
    return Keys.from_key(src, device)


DRAW_CHUNK = 1 << 26  # values drawn at once from a key (f32 and the hash's int64 words)


def normal(keys: Keys, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the keys' device, cast to ``dtype``.
    A draw of more than ``DRAW_CHUNK`` values is made ``DRAW_CHUNK`` at a
    time into the ``dtype`` result, so a 5.4e9-value expert leaf never
    holds its f32 draw whole: from a key, each range of the flat index (the
    partitionable draw gives an index the same value either way); from a
    generator, one draw after another."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n <= DRAW_CHUNK:
        return (keys.normal(shape) * scale).to(dtype)
    out = torch.empty(n, dtype=dtype, device=keys.device)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        draw = (keys.normal((hi - lo,)) if keys.gen is not None
                else prng.normal(keys.key, hi - lo, keys.device, lo))
        out[lo:hi] = (draw * scale).to(dtype)
    return out.reshape(shape)


def dense_init(keys: Keys, shape, dtype, scale: Optional[float] = None):
    """N(0, scale^2) with scale 1/sqrt(fan_in) by default."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return normal(keys, shape, scale, dtype)


def zeros_init(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def const_init(value, shape, dtype, device) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, dim: int, device) -> dict:
    """Norm params are always f32; OLMo's non-parametric LayerNorm has none."""
    if kind == "rmsnorm":
        return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
                "bias": torch.zeros(dim, dtype=torch.float32, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def norm_apply(kind: str, params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * params["scale"]
    elif kind in ("layernorm", "nonparam_ln"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"] + params["bias"]
    else:
        raise ValueError(kind)
    return y.to(dt)


def groupnorm_heads(x, n_heads: int, eps: float = 64e-5):
    """Per-head LayerNorm of the RWKV wkv output; x (..., H * hd)."""
    dt, shp = x.dtype, x.shape
    xf = x.to(torch.float32).reshape(*shp[:-1], n_heads, shp[-1] // n_heads)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.reshape(shp).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., head_dim // 2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # theta as a scalar argument (f32 in the kernel), not a tensor copied to
    # the card, which would wait on the device once a layer
    freqs = 1.0 / torch.pow(float(np.float32(theta)), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """x (..., S, H, hd) with cos/sin (..., S, hd // 2) broadcast over heads."""
    half = x.shape[-1] // 2
    c, s = cos[..., None, :], sin[..., None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(keys: Keys, d_model: int, d_ff: int, dtype) -> dict:
    k1, k2, k3 = keys.split(3)
    return {"wi": dense_init(k1, (d_model, d_ff), dtype),
            "wg": dense_init(k2, (d_model, d_ff), dtype),
            "wo": dense_init(k3, (d_ff, d_model), dtype)}


def activation(x, act: str):
    """silu, or the tanh-approximated gelu that ``jax.nn.gelu`` computes."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(params, x, act: str = "silu"):
    h = x @ params["wi"]
    g = activation(x @ params["wg"], act)
    return (h * g) @ params["wo"]


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def embed_init(keys: Keys, vocab: int, d_model: int, dtype) -> dict:
    return {"w": dense_init(keys, (vocab, d_model), dtype, scale=1.0)}


def embed_apply(params, tokens):
    return params["w"][tokens]


def head_apply(embed_or_head_w, x):
    """x (..., D) @ W^T -> f32 logits (..., V), the product in x's dtype."""
    return (x @ embed_or_head_w.T.to(x.dtype)).to(torch.float32)
