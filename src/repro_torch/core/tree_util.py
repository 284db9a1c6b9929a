"""Parameter-tree helpers: the subset of ``src/repro/core/tree_util.py`` the
ported paths use, with the participation draw and the EF21 uplink
quantiser of the per-leaf path.

A parameter tree is a tensor or any nesting of dicts, lists and tuples of
tensors, flattened as ``jax.tree`` flattens it: dict keys sorted at every
level, lists and tuples in order; ``None`` and empty containers hold no
leaf but keep their place in the structure.  So arena rows match the
reference's element for element.  Per-client state is stacked: every leaf
gains a leading client dim m, and ``tree_client_mean`` is the server
aggregation of the star network.

JAX casts a Python scalar to the dtype of the tensor it meets (a weak
type); PyTorch keeps it at the op's f32 precision.  In bf16 the two round
differently, so the plain tensor code passes every Python scalar that meets
a leaf through ``weak`` first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.kernels.ref import scalar_as

_NARROW = (torch.bfloat16, torch.float16)


def weak(s, like: torch.Tensor):
    """The Python scalar ``s`` as JAX's weak-type rule gives it against the
    tensor ``like``: rounded to ``like``'s dtype when that is narrower than
    f32, so that ``x * weak(s, x)`` rounds as ``x * s`` does in JAX.  Still
    a Python float (no device op); a tensor ``s`` passes through."""
    if isinstance(s, (int, float)) and not isinstance(s, bool) and like.dtype in _NARROW:
        return scalar_as(s, like.dtype)
    return s


def _flatten(tree, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _flatten(t, out)
    elif tree is not None:
        out.append(tree)


def leaves(tree) -> list:
    """The tree's tensors in flattening order."""
    out: list = []
    _flatten(tree, out)
    return out


def paths(tree, prefix: str = "") -> list:
    """Each leaf's key path, as ``jax.tree_util.keystr`` writes it
    (``"['a'][0]"``), in flattening order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in paths(t, f"{prefix}[{i}]")]
    return [] if tree is None else [prefix]


def tmap(fn, *trees):
    """Apply ``fn`` leafwise over trees of one structure (that of the first
    tree; the others may hold ``None`` where it holds a leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, (list, tuple)):
        out = [tmap(fn, *(t[i] for t in trees)) for i in range(len(t0))]
        return out if isinstance(t0, list) else tuple(out)
    if t0 is None:
        return None
    return fn(*trees)


def unflatten(like, flat):
    """A tree of ``like``'s structure whose leaves are ``flat``, in
    flattening order."""
    it = iter(flat)
    out = tmap(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_add(a, b):
    return tmap(torch.add, a, b)


def tree_sub(a, b):
    return tmap(torch.sub, a, b)


def tree_scale(a, s):
    return tmap(lambda x: x * weak(s, x), a)


def tree_axpy(alpha, x, y):
    """alpha * x + y"""
    return tmap(lambda a, b: weak(alpha, a) * a + b, x, y)


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
