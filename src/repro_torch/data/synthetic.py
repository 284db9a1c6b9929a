"""Deterministic synthetic data generators, ported from
``src/repro/data/synthetic.py``.

The paper's MNIST / Fashion-MNIST softmax regression is reproduced on a
deterministic 10-class Gaussian-mixture image problem with the same
geometry (28x28 inputs, 10 classes, one class per client -- the paper's
heterogeneous split).  The LM pipeline generates Zipf-distributed token
streams with per-client topic skew so federated heterogeneity is real.

Every generator takes a ``core.prng`` key, as the reference takes a
``jax.random`` key, and follows the reference's ``split`` / ``fold_in``
tree, so the same seed gives the reference's data: the tokens bit for bit
(``jax.random.choice`` with ``p=`` is the search of ``cumsum(p)[-1] (1 -
u)`` in ``cumsum(p)``, u jax's uniform draw and the cumsum in XLA's order on
the CPU, ``xla_cumsum``), the images within a few f32
roundings (``prng.normal``'s erfinv and the (n, 32) x (32, d) product round
differently from XLA's).  Tensors are built on ``device`` (the card unless
the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve


# ---------------------------------------------------------------------------
# 10-class image mixture (MNIST stand-in)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x_train: torch.Tensor  # (N, 784)
    y_train: torch.Tensor  # (N,)
    x_val: torch.Tensor
    y_val: torch.Tensor
    n_classes: int = 10


def _normal(key, shape, dev) -> torch.Tensor:
    return prng.normal(key, int(np.prod(shape)), dev).reshape(shape)


def gaussian_mixture_images(
    key, n_train_per_class: int = 1000, n_val_per_class: int = 200, d: int = 784,
    n_classes: int = 10, sep: float = 1.2, noise: float = 1.0, device="cuda",
) -> ImageDataset:
    dev = resolve(device)
    kc, kt, kv = prng.split(key, dev, 3)
    # class means: smooth random "digit templates"
    means = _normal(kc, (n_classes, d), dev) * sep
    # low-rank structure so classes overlap like real digits
    basis = _normal(prng.fold_in(kc, 1), (d, 32), dev) / np.sqrt(d)

    def sample(k, n_per):
        ks = prng.split(k, dev, n_classes)
        xs, ys = [], []
        for c in range(n_classes):
            z = _normal(ks[c], (n_per, 32), dev)
            eps = _normal(prng.fold_in(ks[c], 7), (n_per, d), dev)
            xs.append(means[c][None] + z @ basis.T * 2.0 + eps * noise)
            ys.append(torch.full((n_per,), c, dtype=torch.int32, device=dev))
        return torch.cat(xs), torch.cat(ys)

    xt, yt = sample(kt, n_train_per_class)
    xv, yv = sample(kv, n_val_per_class)
    return ImageDataset(xt, yt, xv, yv, n_classes)


# ---------------------------------------------------------------------------
# synthetic LM token streams
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def topic_permutation(topic: int, vocab: int, device="cpu") -> torch.Tensor:
    """Topic ``topic``'s token permutation: the reference's
    ``permutation(fold_in(key(1234), topic), vocab)``, bit for bit (cached:
    a pure function of its arguments)."""
    return prng.permutation(prng.fold_in(prng.key(1234), topic), vocab, device)


_SCAN_BLOCK = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The f32 cumsum of a 1-D tensor in ``jnp.cumsum``'s order on the CPU:
    XLA rewrites the cumulative reduce-window into blocks of 16, each summed
    in order, and adds to each block the scan (the same rewrite, recursively)
    of the blocks before it.  Bitwise that order, in f32 (``torch.cumsum``
    on the CPU accumulates in f64)."""
    n = x.shape[0]
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.zeros(nb * _SCAN_BLOCK, dtype=x.dtype)
    blocks[:n] = x
    blocks = blocks.reshape(nb, _SCAN_BLOCK)
    within = torch.empty_like(blocks)
    acc = torch.zeros(nb, dtype=x.dtype)
    for j in range(_SCAN_BLOCK):
        acc = acc + blocks[:, j]
        within[:, j] = acc
    if nb == 1:
        return within.reshape(-1)[:n]
    carry = torch.cat([torch.zeros(1, dtype=x.dtype), xla_cumsum(within[:, -1])[:-1]])
    return (carry[:, None] + within).reshape(-1)[:n]


@functools.lru_cache(maxsize=16)
def _zipf_cdf(vocab: int) -> torch.Tensor:
    """cumsum of the reference's f32 Zipf-ish unigram probabilities, in
    ``jnp.cumsum``'s order."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    return xla_cumsum(torch.as_tensor(probs, dtype=torch.float32))


def lm_token_stream(key, n_tokens: int, vocab: int, topic: int = 0, n_topics: int = 8):
    """Zipf-ish unigram stream with a topic-dependent permutation, so
    different clients (topics) have genuinely different distributions: the
    reference's ``choice(key, vocab, (n,), p=probs)`` through ``perm``.
    (n_tokens,) int32 on the CPU."""
    cdf = _zipf_cdf(vocab)
    u = prng.uniform(key, n_tokens, "cpu")
    toks = torch.searchsorted(cdf, cdf[-1] * (1.0 - u))
    return topic_permutation(topic, vocab)[toks].to(torch.int32)


def _lm_batch_for(key, step: int, clients, m_all: int, per_client_batch: int, seq_len: int,
                  vocab: int, dev):
    """One {tokens, targets} batch for the given client ids at round
    ``step``: the key always splits ``m_all`` ways and client i draws from
    split i / topic i, so any subset of clients sees exactly the data it
    would see in the full stacking (the cohort-stream ==
    gathered-full-stream contract)."""
    ks = prng.split(prng.fold_in(key, step), "cpu", m_all)
    toks = torch.stack([
        lm_token_stream(ks[i], per_client_batch * (seq_len + 1), vocab,
                        topic=i).reshape(per_client_batch, seq_len + 1)
        for i in (int(c) for c in clients)
    ]).to(dev)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


def lm_batches(key, n_steps: int, m: int, per_client_batch: int, seq_len: int, vocab: int,
               start: int = 0, device="cuda"):
    """Yields {tokens, targets} with leading client dim m (heterogeneous:
    client i draws from topic i).  ``start`` offsets the per-round key fold,
    so a resumed run sees exactly the batches the uninterrupted run would
    have seen from that round on (the checkpoint-resume contract)."""
    dev = resolve(device)
    for step in range(start, start + n_steps):
        yield _lm_batch_for(key, step, range(m), m, per_client_batch, seq_len, vocab, dev)


def cohort_lm_batches(key, n_steps: int, m: int, per_client_batch: int, seq_len: int,
                      vocab: int, *, participation: float, fed_seed: int, start: int = 0,
                      device="cuda"):
    """Cohort-sized LM batch stream: round r yields batches only for that
    round's active cohort -- ``cohort_count(m, participation)`` rows, sorted
    by client id -- drawn from the same mask contract the round engine uses
    (``fold_in(key(fed_seed), r)``, ``tree_util.cohort_indices``).  Each
    active row is identical to the corresponding row of ``lm_batches``, so
    ``core.api.cohort_batch``'s pass-through sees exactly the rows its own
    gather would have made."""
    from repro_torch.core.tree_util import cohort_indices

    dev = resolve(device)
    for step in range(start, start + n_steps):
        idx, _ = cohort_indices(prng.fold_in(prng.key(fed_seed), step), m, participation)
        yield _lm_batch_for(key, step, idx.tolist(), m, per_client_batch, seq_len, vocab, dev)
