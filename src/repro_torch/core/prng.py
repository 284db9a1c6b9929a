"""The ``jax.random`` functions the reference's participation and fault
draws call (``key``, ``fold_in``, ``split``, 32-bit ``random_bits``,
``permutation``, ``uniform``, ``normal``, ``bernoulli`` and ``randint``), in torch, bit
for bit with jax's threefry2x32 under ``jax_threefry_partitionable=True``
(the default since jax 0.5).

The port must draw the same participation mask and fault plan as the
reference for the same seeds and round, so it cannot use
``torch.Generator``.  A key
is a pair ``(k0, k1)`` of 32-bit words, each a Python int (a key made from
a host seed) or a 0-d int64 tensor (a key derived from a device value such
as the round counter).  Words are held in int64 and masked to 32 bits after
every operation that can carry: an int32 would sign-extend on the right
shift and reorder the unsigned sort keys.  Every operation runs on the
device of its tensor operands, so folding in ``state["round"]`` and drawing
a mask never synchronises with the host.

This is plain tensor code, as the reference's is XLA outside any Pallas
kernel: ``fold_in`` and ``split`` are one threefry hash over one or two
counters, ``random_bits`` one over m counters, and ``permutation`` a few
rounds of a stable sort by such bits (``jax._src.random._shuffle``).
``uniform``, ``bernoulli`` and ``randint`` are ``jax._src.random``'s
``_uniform``, ``_bernoulli`` (``mode="low"``) and ``_randint`` for f32 and
int32 over one dim.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-schedule parity constant
# (jax._src.prng._threefry2x32_lowering)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of the counter words ``(x0, x1)``
    under the key ``(k0, k1)``; every argument a Python int or an int64
    tensor holding 32-bit values (tensors broadcast)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int):
    """``jax.random.key(seed)``: the 64-bit seed split into two words."""
    seed = int(seed)
    return (seed >> 32) & MASK, seed & MASK


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: the key hashed with the counter
    ``(0, data)``.  ``data`` is a Python int or an integer tensor (the
    device round counter); the result's words are then 0-d tensors on its
    device."""
    if torch.is_tensor(data):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    return threefry2x32(k[0], k[1], 0, data)


def _as_word(w, device):
    """A key word as an int64 tensor on ``device``, made without a host
    copy (a Python int becomes a fill, not a transfer)."""
    if torch.is_tensor(w):
        return w.to(device=device, dtype=torch.int64)
    return torch.full((), w, dtype=torch.int64, device=device)


def _device(k, device):
    for w in k:
        if torch.is_tensor(w):
            return w.device
    return torch.device(device)


def split(k, device="cpu", num: int = 2):
    """``jax.random.split(k, num)``: the partitionable split hashes the
    counters (0, i), i < num.  Returns ``num`` keys, their words 0-d tensors
    on the key's device (``device`` for a host key)."""
    dev = _device(k, device)
    b0, b1 = threefry2x32(_as_word(k[0], dev), _as_word(k[1], dev), 0,
                          torch.arange(num, dtype=torch.int64, device=dev))
    return tuple((b0[i], b1[i]) for i in range(num))


def random_bits(k, n: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.bits(k, (N,), uint32)`` at the flat indices start ..
    start + n - 1 of a draw of any N: word0 ^ word1 of the hash of the
    counters (i >> 32, i & (2^32 - 1)), the 64-bit index as two words
    (``iota_2x32_shape``), as int64 values in [0, 2^32).  A range of a draw
    is the same range of the whole draw's values, so a large draw can be
    made a range at a time."""
    dev = _device(k, device)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
    hi = (idx >> 32) if start + n > 2 ** 32 else 0
    b0, b1 = threefry2x32(_as_word(k[0], dev), _as_word(k[1], dev), hi, idx & MASK)
    return b0 ^ b1


def shuffle_rounds(n: int) -> int:
    """The number of sort rounds of ``jax.random.permutation`` over n
    items: ceil(3 ln n / ln(2^32 - 1)), so that 32-bit sort keys collide
    with small probability (1 round up to n = 1625, 2 up to about 2.6e6)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(k, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(k, n)``: arange(n) stably sorted by fresh
    32-bit random keys, once per round of ``shuffle_rounds(n)``.  An int64
    tensor on the key's device (``device`` for a host key)."""
    dev = _device(k, device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k, dev)
        order = torch.sort(random_bits(sub, n, dev), stable=True).indices
        x = x[order]
    return x


def uniform(k, n: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32)`` in [0, 1): the top 23 of
    32 random bits as the mantissa of a float in [1, 2), less 1.0 (exact).
    An f32 tensor on the key's device (``device`` for a host key); with
    ``start``, the flat indices start .. start + n - 1 of a larger draw."""
    bits = random_bits(k, n, device, start)
    one = 0x3F800000  # the bits of 1.0f
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform_range(k, n: int, minval: float, maxval: float, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32, minval, maxval)``:
    max(minval, u (maxval - minval) + minval), u the [0, 1) draw.  XLA
    contracts the product and the sum into one rounding (an FMA); both are
    exact in f64 for a 23-bit u and f32 bounds, so the f64 result rounded
    once to f32 is jax's value."""
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    u = uniform(k, n, device).to(torch.float64)
    return torch.clamp_min((u * span + lo).to(torch.float32), lo)


def normal(k, n: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.normal(k, (n,), float32)`` (any shape, flattened:
    the partitionable draw counts over the flat index): sqrt(2) erfinv(u)
    for u uniform in [nextafter(-1, 0), 1), u's bits exactly jax's.  torch's
    ``erfinv`` is not XLA's, so a value may differ from jax's by a few f32
    roundings (6e-6 relative at most in a 256,000-value draw, 2e-5 absolute
    in the tails)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, n, device, start)
    u = torch.clamp_min(u * (1.0 - lo) + lo, lo)
    return float(np.float32(np.sqrt(2.0))) * torch.erfinv(u)


def bernoulli(k, p: float, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, (n,))`` for a Python float p: an f32
    uniform draw below ``float32(p)``; (n,) bool."""
    return uniform(k, n, device) < float(np.float32(p))


def randint(k, n: int, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(k, (n,), minval, maxval, int32)``: two 32-bit
    words per value from the key's split, combined as jax does in uint32
    arithmetic, (hi % span) * ((2^16 % span)^2 % span) + lo % span, all mod
    span (int64 here, masked to 32 bits after every product and sum, so
    that it wraps where jax's uint32 does).  An (n,) int32 tensor."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(f"randint: [{minval}, {maxval}) is not an int32 range")
    span = max(maxval - minval, 1)  # maxval <= minval returns minval, as jax
    k1, k2 = split(k, device)
    hi, lo = random_bits(k1, n, device), random_bits(k2, n, device)
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


__all__ = ["bernoulli", "fold_in", "key", "normal", "permutation", "randint", "random_bits",
           "shuffle_rounds", "split", "threefry2x32", "uniform", "uniform_range"]
