"""Flat client-state arena (the port of ``src/repro/core/arena.py``): one
contiguous ``(m, width)`` buffer per stacked client tree.

Layout (per client row, ``LANES = 128``), identical to the reference's::

    [ leaf0 ......  | 0-pad ][ leaf1 | 0-pad ] ... [ leafL | 0-pad ]

Every leaf starts at a multiple of LANES and its padding is zero; every op
of the round maps 0 -> 0, so the padding stays zero across rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as nnf

from repro_torch.core.tree_util import leaves as tree_leaves, paths as tree_paths, tmap, unflatten
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels.fused_update import LANES, ceil_to


@dataclasses.dataclass(frozen=True)
class LeafSlice:
    """Slice-table entry for one leaf inside the arena row."""

    path: str  # key path, as jax.tree_util.keystr writes it
    shape: Tuple[int, ...]  # per-client leaf shape (no client dim)
    dtype: torch.dtype
    offset: int  # start column; a multiple of LANES
    size: int  # prod(shape)
    padded: int  # size rounded up to a multiple of LANES

    @property
    def rows(self) -> int:
        return self.padded // LANES


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Pack/unpack metadata for one parameter tree (a tensor or any nesting
    of dicts, lists and tuples of tensors, flattened in ``jax.tree``
    order).  ``treedef`` is the tree with a 0 in place of each leaf."""

    treedef: Any
    leaves: Tuple[LeafSlice, ...]
    width: int
    dtype: torch.dtype

    @classmethod
    def from_tree(cls, tree, *, stacked: bool = False) -> "ArenaSpec":
        entries, off = [], 0
        for path, leaf in zip(tree_paths(tree), tree_leaves(tree)):
            shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
            size = math.prod(shape)
            padded = ceil_to(size, LANES)
            entries.append(LeafSlice(path, shape, leaf.dtype, off, size, padded))
            off += padded
        dtype = entries[0].dtype
        for e in entries[1:]:
            dtype = torch.promote_types(dtype, e.dtype)
        return cls(treedef=tmap(lambda _: 0, tree), leaves=tuple(entries), width=off,
                   dtype=dtype)

    @property
    def keys(self) -> Optional[Tuple[str, ...]]:
        """The top-level dict keys, sorted; None for a single tensor."""
        return tuple(sorted(self.treedef)) if isinstance(self.treedef, dict) else None

    @property
    def n_rows(self) -> int:
        return self.width // LANES

    def leaf_rows(self) -> Tuple[int, ...]:
        return tuple(e.rows for e in self.leaves)

    def _pack_leaves(self, leaves, lead: Tuple[int, ...]):
        parts = []
        for e, leaf in zip(self.leaves, leaves):
            flat = leaf.reshape(lead + (e.size,)).to(self.dtype)
            if e.padded != e.size:
                flat = nnf.pad(flat, (0, e.padded - e.size))
            parts.append(flat)
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return out.contiguous()

    def pack(self, tree):
        """Server tree -> ``(width,)`` arena row (zero padding)."""
        return self._pack_leaves(tree_leaves(tree), ())

    def pack_stacked(self, tree):
        """Stacked ``(m, ...)`` tree -> ``(m, width)`` arena buffer."""
        leaves = tree_leaves(tree)
        return self._pack_leaves(leaves, (leaves[0].shape[0],))

    def _unpack_row(self, arr, lead: Tuple[int, ...]):
        out = [arr[..., e.offset:e.offset + e.size].reshape(lead + e.shape).to(e.dtype)
               for e in self.leaves]
        return unflatten(self.treedef, out)

    def unpack(self, row):
        """``(width,)`` arena row -> server tree (original dtypes)."""
        if tuple(row.shape) != (self.width,):
            raise ValueError(f"row shape {tuple(row.shape)} != ({self.width},)")
        return self._unpack_row(row, ())

    def unpack_stacked(self, arr):
        """``(m, width)`` arena buffer -> stacked ``(m, ...)`` tree."""
        if arr.ndim != 2 or arr.shape[1] != self.width:
            raise ValueError(f"arena shape {tuple(arr.shape)} is not (m, {self.width})")
        return self._unpack_row(arr, (arr.shape[0],))


def zeros(spec: ArenaSpec, m: int | None = None, *, device="cuda") -> torch.Tensor:
    """Fresh zero arena: ``(width,)`` or ``(m, width)`` on ``device``."""
    shape = (spec.width,) if m is None else (m, spec.width)
    return torch.zeros(shape, dtype=spec.dtype, device=resolve_device(device))
