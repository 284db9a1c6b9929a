"""Public kernel surface of the port, with the reference's signatures
(``src/repro/kernels/ops.py``) minus its ``impl``/``block`` switches.

Dispatch goes by the device of the tensors: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel or
raises.  There is no switch that routes a CUDA tensor to the plain version.
``ef21_update`` and ``row_scatter`` are plain tensor code around their
kernels, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import inner_loop as _il
from repro_torch.kernels import round_tail as _rt
from repro_torch.kernels.fused_update import fused_update
from repro_torch.kernels.gather import row_gather
from repro_torch.kernels.inner_loop import inner_loop_affine
from repro_torch.kernels.round_tail import (
    dual_from_uplink, ef21_apply, ef21_rowmax, fused_update_arena, round_tail, scaffold_cv,
)

# every kernel of the port, for launch accounting (chip_smoke.py), in the
# order of the kernel table (ROADMAP.md)
KERNELS = (_il.KERNEL, _rt.ROUND_TAIL, _rt.DUAL_FROM_UPLINK, _rt.FUSED_UPDATE_ARENA,
           _rt.SCAFFOLD_CV, _fu.KERNEL, _rt.EF21_ROWMAX, _rt.EF21_APPLY, _ga.ROW_GATHER,
           _ga.ROW_SCATTER)


def affine_inner_fits(width: int) -> bool:
    """Width gate of ``inner_loop_affine`` (its shared-memory rule)."""
    return _il.fits(width)


def _ef21_row_scales(rowmax, leaf_rows, lo: float):
    """Per-(client, leaf) maxima over lo, expanded to per-128-lane-row
    scales (m, rows) and clamped at 1e-12.  The arena pads each leaf to whole
    rows, so this is a static segment reduction (``tree_util._qdq``'s
    per-(client, leaf) scale).  The division is by a tensor: on the card a
    division by a Python scalar is a multiply by its reciprocal."""
    m = rowmax.shape[0]
    lo_t = torch.full((), lo, dtype=rowmax.dtype, device=rowmax.device)
    parts, r0 = [], 0
    for rk in leaf_rows:
        s = torch.amax(rowmax[:, r0:r0 + rk], dim=1, keepdim=True) / lo_t
        parts.append(s.expand(m, rk))
        r0 += rk
    if r0 != rowmax.shape[1]:
        raise ValueError(f"leaf_rows {tuple(leaf_rows)} cover {r0} rows, not {rowmax.shape[1]}")
    return torch.clamp(torch.cat(parts, dim=1), min=1e-12)


def ef21_update(u, u_hat, bits: int, leaf_rows):
    """The fused EF21 quantise-delta over the arena: the integrated server
    view u_hat' = u_hat + qdq(u - u_hat), with one scale per (client, leaf)
    (``leaf_rows`` = ``ArenaSpec.leaf_rows()``).  Two kernels: the row
    max-abs reduction, then the apply pass."""
    lo = float(2 ** (bits - 1) - 1)
    scales = _ef21_row_scales(ef21_rowmax(u, u_hat), leaf_rows, lo)
    return ef21_apply(u, u_hat, scales, bits)


def row_scatter(dst, idx, rows):
    """``dst`` with row idx[t] replaced by rows[t] (idx distinct), as a new
    tensor: the inverse position table pos[idx[t]] = t and the active mask
    are built on the device, then one kernel writes every population row."""
    m, mc, dev = dst.shape[0], idx.shape[0], dst.device
    idx = idx.to(torch.int64)
    pos = torch.zeros(m, dtype=torch.int32, device=dev).index_copy_(
        0, idx, torch.arange(mc, dtype=torch.int32, device=dev))
    mask = torch.zeros(m, dtype=torch.int32, device=dev).index_fill_(0, idx, 1)
    return _ga.row_scatter(dst, pos, mask, rows)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "affine_inner_fits", "dual_from_uplink", "ef21_apply", "ef21_rowmax",
    "ef21_update", "fused_update", "fused_update_arena", "inner_loop_affine", "launches",
    "reset_launches", "round_tail", "row_gather", "row_scatter", "scaffold_cv",
]
