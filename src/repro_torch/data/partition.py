"""Client partitioning strategies for federated data, ported from
``src/repro/data/partition.py``.  ``iid`` and ``dirichlet`` take a
``core.prng`` key and draw through ``prng.permutation`` / ``prng.randint``,
bit for bit jax's, so the same key gives the reference's split."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng


def by_class(x, y, n_classes: int):
    """The paper's split: client i carries exactly class i (maximum
    heterogeneity).  Returns stacked (m, n_i, ...) with equal n_i (each
    class's first n_i samples in order, n_i the smallest class's count)."""
    counts = [int((y == c).sum()) for c in range(n_classes)]
    n = min(counts)
    xs, ys = [], []
    for c in range(n_classes):
        idx = torch.nonzero(y == c).flatten()[:n]
        xs.append(x[idx])
        ys.append(y[idx])
    return torch.stack(xs), torch.stack(ys)


def iid(key, x, y, m: int):
    """A uniform split into m equal shards (the remainder dropped), by
    ``prng.permutation(key, N)``."""
    n = (x.shape[0] // m) * m
    perm = prng.permutation(key, x.shape[0], x.device)[:n]
    return x[perm].reshape(m, n // m, *x.shape[1:]), y[perm].reshape(m, n // m)


def dirichlet(key, x, y, m: int, n_classes: int, alpha: float = 0.3):
    """Dirichlet(alpha) label-skew partition (standard FL benchmark recipe).
    Returns ragged lists (numpy int64 ids) -- callers batch per client.  The
    numpy generator's seed is the reference's ``randint(key, (), 0,
    2**31 - 1)``."""
    seed = int(prng.randint(key, 1, 0, 2**31 - 1)[0])
    rng = np.random.default_rng(seed)
    y_np = y.detach().cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
    client_idx = [[] for _ in range(m)]
    for c in range(n_classes):
        idx = np.nonzero(y_np == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * m)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    return [np.asarray(ci, dtype=np.int64) for ci in client_idx]


def minibatch_schedule(n_per_client: int, batch_size: int, n_steps: int):
    """The paper's deterministic mini-batch order (no randomness): step k
    takes samples [k*B, (k+1)*B) mod n."""
    starts = (np.arange(n_steps) * batch_size) % max(1, n_per_client - batch_size + 1)
    return starts.astype(np.int64)
