"""Static graph topologies for decentralized PDMM: the port's own copy of
``src/repro/core/topology.py`` (numpy only, so the port does not import the
reference).  The tables, the greedy colouring and the Erdos-Renyi draws
(``np.random.RandomState``) are the reference's, entry for entry.

A ``Topology`` describes an undirected connected graph of ``n`` nodes
compiled into static numpy tables:

  * a CSR-style neighbour table: directed slot ``t`` holds the directed dual
    ``z_{i|j}`` (owner ``src[t] = i``, neighbour ``nbr[t] = j``); node
    ``i``'s outgoing slots are the contiguous range ``indptr[i]:indptr[i+1]``
    (its slice of the edge-dual arena);
  * the consensus constraint signs ``sgn[t] = A_{ij}`` (+1 if i < j else -1,
    so every edge enforces x_i - x_j = 0);
  * the reverse permutation ``rev`` with ``rev[slot(i|j)] = slot(j|i)``, the
    route of PDMM's directed dual exchange;
  * a greedy proper colouring (``colors``), the sequential firing schedule:
    on a star it is {clients}, {server}, which is why star graph-PDMM
    reproduces the centralised ``pdmm``/``gpdmm`` round for round.

The edge-dual arena is the ``(2|E|, width)`` counterpart of the client
arena: row ``t`` holds ``z_{src[t]|nbr[t]}`` at the arena's 128-lane padded
width.  Star graphs carry one aux node (the centre, index ``n - 1``) with
f = 0; ``n_data`` counts the nodes that own an objective term.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Compiled static graph (all arrays numpy)."""

    name: str
    n: int  # total nodes (incl. aux)
    n_data: int  # nodes carrying an f_i / a batch row; aux nodes have f = 0
    src: np.ndarray  # (2E,) int32 owner i of directed slot z_{i|j}
    nbr: np.ndarray  # (2E,) int32 neighbor j
    sgn: np.ndarray  # (2E,) int32 A_{ij} in {+1, -1} (+1 iff i < j)
    indptr: np.ndarray  # (n+1,) int32: node i's slots = indptr[i]:indptr[i+1]
    rev: np.ndarray  # (2E,) int32: rev[slot(i|j)] = slot(j|i)
    colors: Tuple[np.ndarray, ...]  # proper coloring; class arrays of node ids

    # -- derived -----------------------------------------------------------
    @property
    def n_slots(self) -> int:
        """Directed dual count = rows of the edge-dual arena (2|E|)."""
        return int(self.src.shape[0])

    @property
    def n_edges(self) -> int:
        return self.n_slots // 2

    @property
    def deg(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.deg.max())

    @property
    def n_aux(self) -> int:
        return self.n - self.n_data

    def data_degree_constant(self) -> bool:
        """Do all data nodes share one degree?  Gates the scalar-rho fused
        arena kernels (per-node degrees need the vector XLA path)."""
        d = self.deg[: self.n_data]
        return bool((d == d[0]).all())

    def first_flags(self) -> np.ndarray:
        """(2E,) int32: 1 at each node's first slot -- the segment-start
        marker the fused neighbor-reduce kernel zero-initialises on."""
        f = np.zeros(self.n_slots, np.int32)
        starts = self.indptr[:-1][self.deg > 0]
        f[starts] = 1
        return f

    def slot(self, i: int, j: int) -> int:
        """Directed slot of z_{i|j} (python-side; tests/debug)."""
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        for t in range(lo, hi):
            if self.nbr[t] == j:
                return t
        raise KeyError(f"no edge {i} -- {j} in {self.name}")

    def edges(self) -> Tuple[Tuple[int, int], ...]:
        """Undirected edge list (i < j), sorted."""
        return tuple(
            (int(self.src[t]), int(self.nbr[t]))
            for t in range(self.n_slots)
            if self.src[t] < self.nbr[t]
        )


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def _check_connected(n: int, edges) -> None:
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in edges:
        parent[find(i)] = find(j)
    roots = {find(i) for i in range(n)}
    if len(roots) != 1:
        raise ValueError(f"graph is disconnected ({len(roots)} components)")


def _greedy_coloring(n: int, adj) -> Tuple[np.ndarray, ...]:
    """Greedy proper coloring by node index; at most max_degree + 1 classes.
    Clients-before-server node orderings (star) get the 2-class
    {clients}, {server} schedule that reproduces the centralised round."""
    color = np.full(n, -1, np.int32)
    for i in range(n):
        used = {int(color[j]) for j in adj[i] if color[j] >= 0}
        c = 0
        while c in used:
            c += 1
        color[i] = c
    k = int(color.max()) + 1
    return tuple(np.nonzero(color == c)[0].astype(np.int32) for c in range(k))


def compile_edges(name: str, n: int, edges: Iterable[Tuple[int, int]],
                  *, n_data: int | None = None) -> Topology:
    """Compile an undirected edge list into the static CSR tables."""
    uniq = sorted({(min(i, j), max(i, j)) for i, j in edges})
    if n < 2:
        raise ValueError(f"need at least 2 nodes, got {n}")
    for i, j in uniq:
        if i == j:
            raise ValueError(f"self-loop at node {i}")
        if not (0 <= i < n and 0 <= j < n):
            raise ValueError(f"edge ({i}, {j}) out of range for n={n}")
    _check_connected(n, uniq)

    adj = [[] for _ in range(n)]
    for i, j in uniq:
        adj[i].append(j)
        adj[j].append(i)
    for lst in adj:
        lst.sort()

    src, nbr, sgn, indptr = [], [], [], [0]
    slot_of = {}
    for i in range(n):
        for j in adj[i]:
            slot_of[(i, j)] = len(src)
            src.append(i)
            nbr.append(j)
            sgn.append(1 if i < j else -1)
        indptr.append(len(src))
    rev = np.array([slot_of[(j, i)] for i, j in zip(src, nbr)], np.int32)

    return Topology(
        name=name,
        n=n,
        n_data=n if n_data is None else n_data,
        src=np.array(src, np.int32),
        nbr=np.array(nbr, np.int32),
        sgn=np.array(sgn, np.int32),
        indptr=np.array(indptr, np.int32),
        rev=rev,
        colors=_greedy_coloring(n, adj),
    )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def star(m: int) -> Topology:
    """m data nodes + one AUX center (index m, f = 0): the decentralized
    picture of the paper's centralised network."""
    if m < 1:
        raise ValueError("star needs at least 1 client")
    return compile_edges("star", m + 1, [(i, m) for i in range(m)], n_data=m)


def ring(n: int) -> Topology:
    if n < 3:
        raise ValueError("ring needs at least 3 nodes")
    return compile_edges("ring", n, [(i, (i + 1) % n) for i in range(n)])


def complete(n: int) -> Topology:
    return compile_edges(
        "complete", n, [(i, j) for i in range(n) for j in range(i + 1, n)]
    )


def torus2d(rows: int, cols: int) -> Topology:
    """2D torus (wrap-around grid).  rows * cols nodes, degree 4 (degenerate
    2-wide sides dedupe to degree 3)."""
    if rows < 2 or cols < 2:
        raise ValueError("torus2d needs rows, cols >= 2")
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            edges.append((i, r * cols + (c + 1) % cols))
            edges.append((i, ((r + 1) % rows) * cols + c))
    return compile_edges("torus2d", rows * cols, edges)


def erdos_renyi(n: int, p: float = 0.4, seed: int = 0) -> Topology:
    """G(n, p) made connected: components are chained together by an extra
    edge between their smallest nodes (deterministic in the seed)."""
    rng = np.random.RandomState(seed)
    edges = [
        (i, j) for i in range(n) for j in range(i + 1, n) if rng.rand() < p
    ]
    # connect components deterministically
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in edges:
        parent[find(i)] = find(j)
    reps = sorted({find(i) for i in range(n)})
    for a, b in zip(reps, reps[1:]):
        edges.append((a, b))
        parent[find(a)] = find(b)
    return compile_edges("er", n, edges)


def _torus_shape(m: int) -> Tuple[int, int]:
    """Largest divisor pair (r, c) with r <= c, r maximal (nearest square)."""
    r = int(np.floor(np.sqrt(m)))
    while r >= 2 and m % r:
        r -= 1
    if r < 2:
        raise ValueError(f"torus needs a composite node count, got {m}")
    return r, m // r


def make(spec: str, m: int, *, seed: int = 0) -> Topology:
    """Parse a ``FederatedConfig.topology`` string for ``m`` data nodes.

    ``"star"`` | ``"ring"`` | ``"complete"`` | ``"torus"`` |
    ``"er"`` / ``"er:<p>"``.  Star adds the aux center (n = m + 1); every
    other family uses the m data nodes directly.
    """
    kind, _, arg = spec.partition(":")
    if arg and kind != "er":
        raise ValueError(
            f"topology {spec!r}: only 'er' takes a ':<arg>' suffix (er:<p>)")
    if kind == "star":
        return star(m)
    if kind == "ring":
        return ring(m)
    if kind == "complete":
        return complete(m)
    if kind == "torus":
        return torus2d(*_torus_shape(m))
    if kind == "er":
        return erdos_renyi(m, float(arg) if arg else 0.4, seed)
    raise ValueError(
        f"unknown topology {spec!r} (star | ring | complete | torus | er[:p])"
    )
