"""Parameter-tree helpers: the subset of ``src/repro/core/tree_util.py`` the
ported paths use, with the participation draw and the EF21 uplink
quantiser of the per-leaf path.

A parameter tree here is a single tensor or a flat ``dict`` of tensors;
dict leaves are visited in sorted key order, as ``jax.tree`` flattens a
dict, so arena rows match the reference's element for element.  Per-client
state is stacked: every leaf gains a leading client dim m, and
``tree_client_mean`` is the server aggregation of the star network.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng


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


def tree_add(a, b):
    return tmap(torch.add, a, b)


def tree_sub(a, b):
    return tmap(torch.sub, a, b)


def tree_scale(a, s):
    return tmap(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y"""
    return tmap(lambda a, b: alpha * a + b, x, y)


def tree_zeros_like(a):
    return tmap(torch.zeros_like, a)


def tree_client_mean(stacked):
    """Mean over the leading client dim: the server aggregation."""
    return tmap(lambda x: torch.mean(x, dim=0), stacked)


def tree_client_sum(stacked):
    return tmap(lambda x: torch.sum(x, dim=0), stacked)


def tree_broadcast(tree, m: int):
    """The server tree replicated to the stacked (m, ...) layout, as a fresh
    contiguous copy (a kernel operand or a state entry of its own)."""
    return tmap(lambda x: x[None].expand((m,) + tuple(x.shape)).contiguous(), tree)


def tree_dense(tree):
    """Each leaf contiguous and 16-byte aligned, as the kernels take their
    operands; a leaf that already is passes through uncopied."""
    return tmap(lambda x: x if x.is_contiguous() and x.data_ptr() % 16 == 0
                else x.clone(memory_format=torch.contiguous_format), tree)


def tree_norm(a):
    """sqrt(sum over leaves of sum(x * x)), accumulated in f32."""
    f32 = torch.float32
    return torch.sqrt(sum((torch.sum(x.to(f32) * x.to(f32)) for x in leaves(a)),
                          start=torch.zeros((), dtype=f32, device=leaves(a)[0].device)))


def tree_client_sqnorms(stacked):
    """Per-client squared norms, ``(m,)``, summed over all leaves (f32)."""
    def one(x):
        sq = torch.square(x.to(torch.float32))
        return sq if x.ndim == 1 else torch.sum(sq, dim=tuple(range(1, x.ndim)))

    return sum(one(x) for x in leaves(stacked))


def tree_client_drift(x_K, x_s, mask=None):
    """Mean over the (active) clients of ||x_K,i - x_s||^2 (f32), the
    server tree broadcast by indexing."""
    return masked_client_mean(tree_client_sqnorms(tmap(lambda xk, s: xk - s[None], x_K, x_s)),
                              mask)


def tree_select(mask, a, b):
    """Per-client select over stacked (m, ...) trees: leaf[i] = a[i] if
    mask[i] else b[i]."""
    def one(x, y):
        return torch.where(mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1)), x, y)

    return tmap(one, a, b)


# ---------------------------------------------------------------------------
# EF21 delta-quantised uplink on the per-leaf path (the arena runs the fused
# ``ops.ef21_update`` instead)
# ---------------------------------------------------------------------------

def _qdq(x, bits: int):
    """Symmetric per-(client, leaf) fake-quantise: the scale is the max-abs
    over each client's slice (dim 0 is the client dim) over 2^(bits-1) - 1;
    returns the dequantised value in x's dtype."""
    lo = float(2 ** (bits - 1) - 1)
    xf = x.to(torch.float32)
    red = tuple(range(1, x.ndim))
    a = torch.abs(xf)
    # torch.amax over no dims would reduce over all of them
    scale = (torch.amax(a, dim=red, keepdim=True) if red else a) / lo
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -lo, lo)
    return (q * scale).to(x.dtype)


def tree_quantize_delta(tree, u_hat, bits: int):
    """EF21 difference compression of a stacked uplink tree: each client
    sends q(u_i - u_hat_i) and both sides integrate u_hat_i += q(.).
    Returns the new server view u_hat'."""
    sent = tmap(lambda p: _qdq(p, bits), tree_sub(tree, u_hat))
    return tree_add(u_hat, sent)


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


def participation_mask(key, m: int, frac: float, device="cpu") -> torch.Tensor:
    """The reference's participation mask: exactly ``cohort_count(m, frac)``
    active clients, those whose entry of the seeded permutation is below
    the count.  ``key`` is a ``core.prng`` key (on the device of the round
    counter it was folded from, else ``device``)."""
    return prng.permutation(key, m, device) < cohort_count(m, frac)


def cohort_indices(key, m: int, frac: float, device="cpu"):
    """The round's cohort as (idx, mask): ``mask`` is exactly
    ``participation_mask`` and ``idx`` (static size ``cohort_count``) the
    active client ids in ascending order, as int64.

    The reference takes ``nonzero(mask, size=n)``; torch has no static-size
    nonzero that avoids a host sync, so the ids come from the permutation
    itself: the positions holding the values 0..n-1 are the inverse
    permutation's first n entries, sorted."""
    order = prng.permutation(key, m, device)
    n = cohort_count(m, frac)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, dtype=order.dtype, device=order.device))
    return torch.sort(inv[:n]).values, order < n


def masked_client_mean(vals: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean of a per-client ``(m,)`` metric over the active clients only
    (``mask=None`` = all)."""
    if mask is None:
        return torch.mean(vals)
    mk = mask.to(vals.dtype)
    return torch.sum(vals * mk) / torch.clamp(torch.sum(mk), min=1.0)
