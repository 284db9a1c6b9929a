"""Parameter-tree helpers: the subset of ``src/repro/core/tree_util.py`` the
ported path uses.

A parameter tree here is a single tensor or a flat ``dict`` of tensors;
dict leaves are visited in sorted key order, as ``jax.tree`` flattens a
dict, so arena rows match the reference's element for element.
"""
from __future__ import annotations

import math

import torch


def leaves(tree) -> list:
    """The tree's tensors in flattening order."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tmap(fn, *trees):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


def cohort_count(m: int, frac: float) -> int:
    """Static active-cohort size: ceil(frac * m), at least 1, with the
    reference's representation-tolerant ceil (``0.07 * 100`` counts 7)."""
    prod = frac * m
    nearest = round(prod)
    if abs(prod - nearest) <= 1e-9 * max(1.0, abs(prod)):
        n = int(nearest)
    else:
        n = int(math.ceil(prod))
    return max(1, n)


def masked_client_mean(vals: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean of a per-client ``(m,)`` metric over the active clients only
    (``mask=None`` = all)."""
    if mask is None:
        return torch.mean(vals)
    mk = mask.to(vals.dtype)
    return torch.sum(vals * mk) / torch.clamp(torch.sum(mk), min=1.0)
