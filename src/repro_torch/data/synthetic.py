"""Deterministic synthetic data generators, ported from
``src/repro/data/synthetic.py``.

The paper's MNIST / Fashion-MNIST softmax regression is reproduced on a
deterministic 10-class Gaussian-mixture image problem with the same
geometry (28x28 inputs, 10 classes, one class per client -- the paper's
heterogeneous split).  The LM pipeline generates Zipf-distributed token
streams with per-client topic skew so federated heterogeneity is real.

Every generator draws from a ``torch.Generator`` (on its device), as
``core.quadratic.generate`` does, and builds its tensors on ``device``
(the card unless the caller asks for the CPU); the values are not the
reference's.  Two pieces keep the reference's contracts bit for bit
through ``core.prng``: each topic's token permutation, and the cohort of
``cohort_lm_batches`` (the round engine's participation draw).
"""
from __future__ import annotations

import dataclasses

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


def gaussian_mixture_images(
    gen: torch.Generator, n_train_per_class: int = 1000, n_val_per_class: int = 200,
    d: int = 784, n_classes: int = 10, sep: float = 1.2, noise: float = 1.0, device="cuda",
) -> ImageDataset:
    dev = resolve(device)
    draw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    # class means: smooth random "digit templates"
    means = torch.randn((n_classes, d), **draw) * sep
    # low-rank structure so classes overlap like real digits
    basis = torch.randn((d, 32), **draw) / np.sqrt(d)

    def sample(n_per):
        xs, ys = [], []
        for c in range(n_classes):
            z = torch.randn((n_per, 32), **draw)
            eps = torch.randn((n_per, d), **draw)
            xs.append(means[c][None] + z @ basis.T * 2.0 + eps * noise)
            ys.append(torch.full((n_per,), c, dtype=torch.int32, device=gen.device))
        return torch.cat(xs).to(dev), torch.cat(ys).to(dev)

    xt, yt = sample(n_train_per_class)
    xv, yv = sample(n_val_per_class)
    return ImageDataset(xt, yt, xv, yv, n_classes)


# ---------------------------------------------------------------------------
# synthetic LM token streams
# ---------------------------------------------------------------------------

def topic_permutation(topic: int, vocab: int, device="cpu") -> torch.Tensor:
    """Topic ``topic``'s token permutation: the reference's
    ``permutation(fold_in(key(1234), topic), vocab)``, bit for bit."""
    return prng.permutation(prng.fold_in(prng.key(1234), topic), vocab, device)


def lm_token_stream(gen: torch.Generator, n_tokens: int, vocab: int, topic: int = 0,
                    n_topics: int = 8) -> torch.Tensor:
    """Zipf-ish unigram stream with a topic-dependent permutation, so
    different clients (topics) have genuinely different distributions.  On
    the generator's device, int32."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    p = torch.as_tensor(probs, dtype=torch.float32, device=gen.device)
    toks = torch.multinomial(p, n_tokens, replacement=True, generator=gen)
    return topic_permutation(topic, vocab, gen.device)[toks].to(torch.int32)


def _client_generator(base: int, step: int, client: int, device) -> torch.Generator:
    """The generator of one (round, client) pair: seeded by a threefry hash
    of the pair under the stream's base seed, so a client's data in a round
    does not depend on which other clients are drawn."""
    w0, w1 = prng.threefry2x32(base >> 32, base & prng.MASK, step & prng.MASK, int(client))
    return torch.Generator(device=device).manual_seed(((w0 << 32) | w1) & ((1 << 63) - 1))


def _base_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))


def _lm_batch_for(base: int, step: int, clients, per_client_batch: int, seq_len: int,
                  vocab: int, gen_device, dev):
    """One {tokens, targets} batch for the given client ids at round
    ``step``: client i draws from its own (step, i) generator and topic i,
    so any subset of clients sees exactly the data it would see in the full
    stacking (the cohort-stream == gathered-full-stream contract)."""
    toks = torch.stack([
        lm_token_stream(_client_generator(base, step, i, gen_device),
                        per_client_batch * (seq_len + 1), vocab,
                        topic=i).reshape(per_client_batch, seq_len + 1)
        for i in (int(c) for c in clients)
    ]).to(dev)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


def lm_batches(gen: torch.Generator, n_steps: int, m: int, per_client_batch: int,
               seq_len: int, vocab: int, start: int = 0, device="cuda"):
    """Yields {tokens, targets} with leading client dim m (heterogeneous:
    client i draws from topic i).  ``start`` offsets the round, so a resumed
    run (a generator in the same state) sees exactly the batches the
    uninterrupted run would have seen from that round on."""
    dev = resolve(device)
    base = _base_seed(gen)
    for step in range(start, start + n_steps):
        yield _lm_batch_for(base, step, range(m), per_client_batch, seq_len, vocab,
                            gen.device, dev)


def cohort_lm_batches(gen: torch.Generator, n_steps: int, m: int, per_client_batch: int,
                      seq_len: int, vocab: int, *, participation: float, fed_seed: int,
                      start: int = 0, device="cuda"):
    """Cohort-sized LM batch stream: round r yields batches only for that
    round's active cohort -- ``cohort_count(m, participation)`` rows, sorted
    by client id -- drawn from the same mask contract the round engine uses
    (``fold_in(key(fed_seed), r)``, ``tree_util.cohort_indices``).  Each
    active row is identical to the corresponding row of ``lm_batches`` from
    a generator in the same state, so ``core.api.cohort_batch``'s
    pass-through sees exactly the rows its own gather would have made."""
    from repro_torch.core.tree_util import cohort_indices

    dev = resolve(device)
    base = _base_seed(gen)
    for step in range(start, start + n_steps):
        idx, _ = cohort_indices(prng.fold_in(prng.key(fed_seed), step), m, participation)
        yield _lm_batch_for(base, step, idx.tolist(), per_client_batch, seq_len, vocab,
                            gen.device, dev)
