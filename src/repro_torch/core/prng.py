"""The ``jax.random`` functions the reference's participation and fault
draws call (``key``, ``fold_in``, ``split``, 32-bit ``random_bits``,
``permutation``, ``uniform``, ``bernoulli`` and ``randint``), in torch, bit
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


def split(k, device="cpu"):
    """``jax.random.split(k)`` into two keys: the partitionable split hashes
    the counters (0, 0) and (0, 1).  Returns ``(k_a, k_b)``, their words
    0-d tensors on the key's device (``device`` for a host key)."""
    dev = _device(k, device)
    b0, b1 = threefry2x32(_as_word(k[0], dev), _as_word(k[1], dev), 0,
                          torch.arange(2, dtype=torch.int64, device=dev))
    return (b0[0], b1[0]), (b0[1], b1[1])


def random_bits(k, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)``: word0 ^ word1 of the hash of
    the counters (0, i), i < n, as int64 values in [0, 2^32)."""
    if n >= 2 ** 32:
        raise ValueError(f"random_bits: {n} counters need the high word, not ported")
    dev = _device(k, device)
    b0, b1 = threefry2x32(_as_word(k[0], dev), _as_word(k[1], dev), 0,
                          torch.arange(n, dtype=torch.int64, device=dev))
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


def uniform(k, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32)`` in [0, 1): the top 23 of
    32 random bits as the mantissa of a float in [1, 2), less 1.0 (exact).
    An f32 tensor on the key's device (``device`` for a host key)."""
    bits = random_bits(k, n, device)
    one = 0x3F800000  # the bits of 1.0f
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


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


__all__ = ["bernoulli", "fold_in", "key", "permutation", "randint", "random_bits",
           "shuffle_rounds", "split", "threefry2x32", "uniform"]
