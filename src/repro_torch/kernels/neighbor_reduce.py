"""Kernels 14 and 15: graph-PDMM's passes over the (2E, W) edge-dual arena,
one CUDA kernel each (``csrc/neighbor_reduce.cu``); the port of
``src/repro/kernels/neighbor_reduce.py``:

  * ``neighbor_reduce``  s_i = sum_{j in N(i)} A_ij z_{i|j}: the signed sum
                         of each node's contiguous slot range, (n, W)
  * ``edge_flip``        z'[t] = z[rev[t]] - 2c sgn[t] x[nbr[t]], or z[t]
                         where ``mask[t] == 0``: the directed dual exchange,
                         as a new (2E, W) tensor

The slot tables (``core.topology``: ``seg = src``, ``first``, ``sgn``,
``rev``, ``nbr``) are static numpy arrays.  They are checked and moved to a
device once and kept (``reduce_tables``, ``flip_tables``), so a graph round
does not copy them on every phase; the kernel takes node ranges from an ``indptr`` built from
``seg`` at the same time.  The fire mask is a tensor on the device.  CUDA
operands are f32 or bf16 (z and x of one dtype), any width.  Both kernels
are bitwise their plain versions: the same f32 operations in the same
order, the sums in slot order.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, F, I, P, Kernel

NEIGHBOR_REDUCE = Kernel(
    "neighbor_reduce", "neighbor_reduce.cu", "launch_neighbor_reduce",
    # z indptr sgn n W dtype out dev stream
    [P, P, P, LL, LL, I, P, I, P],
    replaces="src/repro/kernels/neighbor_reduce.py:65",
)
EDGE_FLIP = Kernel(
    "edge_flip", "neighbor_reduce.cu", "launch_edge_flip",
    # z x rev nbr sgn mask c2 slots W dtype out dev stream
    [P, P, P, P, P, P, F, LL, LL, I, P, I, P],
    replaces="src/repro/kernels/neighbor_reduce.py:125",
)

_lock = threading.Lock()
_tables: dict = {}  # (kind, id of each array, n, device) -> (arrays, tables)
_MAX_TABLES = 256


def _cached(kind: str, arrays: tuple, n, device, build):
    """``build()`` once per (kind, arrays, n, device).  The entry holds the
    arrays themselves, so their ids stay theirs while it lives; the tables
    are static, so an array is not expected to change in place."""
    key = (kind, tuple(id(a) for a in arrays), n, str(device))
    with _lock:
        hit = _tables.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], arrays)):
            return hit[1]
    out = build()
    with _lock:
        if len(_tables) >= _MAX_TABLES:
            _tables.pop(next(iter(_tables)))
        _tables[key] = (arrays, out)
    return out


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.int64).reshape(-1)


def _dev(a: np.ndarray, device) -> torch.Tensor:
    """int32 for the kernel, int64 for the plain version's indexing."""
    dt = torch.int64 if device.type == "cpu" else torch.int32
    return torch.from_numpy(a.astype(np.int64)).to(device=device, dtype=dt)


def reduce_tables(seg, first, sgn, n: int, device):
    """(indptr (n+1,), sgn (2E,)) on ``device`` for ``neighbor_reduce``:
    node i's slots are indptr[i]:indptr[i+1].  Built once per (seg, sgn, n,
    device); raises unless ``seg`` is sorted into [0, n) and ``first``
    flags exactly each owned segment's first slot (``first`` follows from
    ``seg``, so it is checked when the tables are built and not a key)."""
    def build():
        s, f, g = _host(seg), _host(first), _host(sgn)
        if not (s.shape == f.shape == g.shape):
            raise ValueError(f"neighbor_reduce: seg, first, sgn have shapes {s.shape}, "
                             f"{f.shape}, {g.shape}")
        if s.size and (np.any(np.diff(s) < 0) or s[0] < 0 or s[-1] >= n):
            raise ValueError(f"neighbor_reduce: seg must be sorted node ids in [0, {n})")
        indptr = np.searchsorted(s, np.arange(n + 1), side="left")
        want = np.zeros(s.size, np.int64)
        want[indptr[:-1][np.diff(indptr) > 0]] = 1
        if not np.array_equal((f != 0).astype(np.int64), want):
            raise ValueError("neighbor_reduce: first must flag each node's first slot")
        return _dev(indptr, device), _dev(g, device)

    return _cached("reduce", (seg, sgn), n, device, build)


def flip_tables(rev, nbr, sgn, device):
    """(rev, nbr, sgn, rows needed in x) on ``device`` for ``edge_flip``.
    Raises unless ``rev`` is a permutation of the slots."""
    def build():
        r, b, g = _host(rev), _host(nbr), _host(sgn)
        if not (r.shape == b.shape == g.shape):
            raise ValueError(f"edge_flip: rev, nbr, sgn have shapes {r.shape}, {b.shape}, "
                             f"{g.shape}")
        if not np.array_equal(np.sort(r), np.arange(r.size)):
            raise ValueError("edge_flip: rev must be a permutation of the slots")
        if b.size and b.min() < 0:
            raise ValueError("edge_flip: nbr holds a negative node id")
        rows = int(b.max()) + 1 if b.size else 0
        return _dev(r, device), _dev(b, device), _dev(g, device), rows

    return _cached("flip", (rev, nbr, sgn), None, device, build)


def _dtype_code(name: str, t) -> int:
    if t.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported (f32 or bf16)")
    return _args.DTYPE_CODES[t.dtype]


def neighbor_reduce(z, *, seg, first, sgn, n: int):
    """The (n, W) per-node offsets s_i = sum_j A_ij z_{i|j} of the (2E, W)
    edge duals ``z``; ``seg`` (slot owner, sorted), ``first`` (segment
    starts) and ``sgn`` are (2E,) static slot tables."""
    k = NEIGHBOR_REDUCE
    cpu = _args.on_cpu(k.name, z)
    indptr, sgn_t = reduce_tables(seg, first, sgn, n, z.device)
    if cpu:
        return ref.neighbor_reduce_ref(z, indptr, sgn_t, n)
    if z.ndim != 2:
        raise ValueError(f"{k.name}: z must be (2E, W), got {tuple(z.shape)}")
    S, w = z.shape
    if sgn_t.shape[0] != S:
        raise ValueError(f"{k.name}: the slot tables have {sgn_t.shape[0]} slots, z has {S}")
    code = _dtype_code(k.name, z)
    _args.check(k.name, "z", z, (S, w), (z.dtype,), z.device)
    out = torch.empty((n, w), dtype=z.dtype, device=z.device)
    k.launch(_args.ptr(z), _args.ptr(indptr), _args.ptr(sgn_t), n, w, code, _args.ptr(out),
             *_args.stream_args(z.device))
    return out


def edge_flip(z, x, c, *, rev, nbr, sgn, mask=None):
    """The new (2E, W) edge duals after the nodes of ``x`` (n, W) sent:
    z'[t] = z[rev[t]] - 2c sgn[t] x[nbr[t]], and z[t] where ``mask`` (an
    optional (2E,) bool or int tensor) is 0.  ``rev``, ``nbr``, ``sgn``
    are (2E,) static slot tables."""
    k = EDGE_FLIP
    cpu = _args.on_cpu(k.name, z)
    rev_t, nbr_t, sgn_t, rows = flip_tables(rev, nbr, sgn, z.device)
    if mask is not None and not torch.is_tensor(mask):
        mask = torch.as_tensor(np.asarray(mask), device=z.device)
    if cpu:
        return ref.edge_flip_ref(z, x, c, rev_t, nbr_t, sgn_t, mask)
    if z.ndim != 2 or x.ndim != 2:
        raise ValueError(f"{k.name}: z and x must be 2-D, got {tuple(z.shape)}, "
                         f"{tuple(x.shape)}")
    S, w = z.shape
    if rev_t.shape[0] != S:
        raise ValueError(f"{k.name}: the slot tables have {rev_t.shape[0]} slots, z has {S}")
    if x.shape[0] < rows:
        raise ValueError(f"{k.name}: nbr reaches row {rows - 1} of x, which has {x.shape[0]}")
    code = _dtype_code(k.name, z)
    _args.check(k.name, "z", z, (S, w), (z.dtype,), z.device)
    _args.check(k.name, "x", x, (x.shape[0], w), (z.dtype,), z.device)
    if mask is not None:
        if mask.dtype != torch.int32:
            mask = mask.to(torch.int32)
        _args.check(k.name, "mask", mask, (S,), (torch.int32,), z.device)
    out = torch.empty_like(z)
    k.launch(_args.ptr(z), _args.ptr(x), _args.ptr(rev_t), _args.ptr(nbr_t), _args.ptr(sgn_t),
             _args.ptr(mask), float(2.0 * c), S, w, code, _args.ptr(out),
             *_args.stream_args(z.device))
    return out
