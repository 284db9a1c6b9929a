"""Kernels 9 and 10: the cohort engine's row movement over the population
arena, one CUDA pass each (``csrc/gather.cu``); the port of
``src/repro/kernels/gather.py``:

  * ``row_gather``   out[t] = arr[idx[t]]: the (mc, W) cohort buffer
  * ``row_scatter``  out[i] = rows[pos[i]] if mask[i] else dst[i]: the
                     population buffer with the cohort's rows put back,
                     as a new tensor (every row written once)

``ops.row_scatter`` builds the ``pos``/``mask`` tables from the cohort ids.
CUDA operands are f32 or bf16 with W a multiple of 8 (16-byte rows); ids
are int32 or int64 (``gather``) and int32 (``pos``/``mask``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, I, P, Kernel

ROW_GATHER = Kernel(
    "row_gather", "gather.cu", "launch_row_gather",
    # arr idx idx_is_64 mc row_bytes out dev stream
    [P, P, I, LL, LL, P, I, P],
    replaces="src/repro/kernels/gather.py:46",
)
ROW_SCATTER = Kernel(
    "row_scatter", "gather.cu", "launch_row_scatter",
    # dst pos mask rows m row_bytes out dev stream
    [P, P, P, P, LL, LL, P, I, P],
    replaces="src/repro/kernels/gather.py:76",
)


def _rows(name, arg, t):
    """Check an (n, W) row buffer of 16-byte rows; returns its row bytes."""
    if t.ndim != 2:
        raise ValueError(f"{name}: {arg} must be (rows, W), got {tuple(t.shape)}")
    if t.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported (f32 or bf16)")
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a row of {arg} is {row_bytes} bytes, not a multiple of 16")
    _args.check(name, arg, t, tuple(t.shape), (t.dtype,), t.device)
    return row_bytes


def row_gather(arr, idx):
    """The (mc, W) cohort buffer arr[idx]: ``arr`` (m, W), ``idx`` (mc,)
    row ids in range (int32 or int64)."""
    k = ROW_GATHER
    if _args.on_cpu(k.name, arr):
        return ref.row_gather_ref(arr, idx)
    row_bytes = _rows(k.name, "arr", arr)
    mc = idx.shape[0]
    _args.check(k.name, "idx", idx, (mc,), (torch.int32, torch.int64), arr.device)
    out = torch.empty((mc, arr.shape[1]), dtype=arr.dtype, device=arr.device)
    k.launch(_args.ptr(arr), _args.ptr(idx), int(idx.dtype == torch.int64), mc, row_bytes,
             _args.ptr(out), *_args.stream_args(arr.device))
    return out


def row_scatter(dst, pos, mask, rows):
    """The population buffer with row i = rows[pos[i]] where mask[i] != 0,
    else dst[i]: ``dst`` (m, W), ``rows`` (mc, W), ``pos``/``mask`` (m,)
    int32.  A new tensor; ``dst`` is not written."""
    k = ROW_SCATTER
    if _args.on_cpu(k.name, dst):
        return ref.row_scatter_ref(dst, pos, mask, rows)
    m = dst.shape[0]
    row_bytes = _rows(k.name, "dst", dst)
    _rows(k.name, "rows", rows)
    if rows.dtype != dst.dtype or rows.shape[1] != dst.shape[1] or rows.device != dst.device:
        raise ValueError(f"{k.name}: rows {tuple(rows.shape)} {rows.dtype} on {rows.device} "
                         f"do not match dst {tuple(dst.shape)} {dst.dtype} on {dst.device}")
    for arg, t in (("pos", pos), ("mask", mask)):
        _args.check(k.name, arg, t, (m,), (torch.int32,), dst.device)
    out = torch.empty_like(dst)
    k.launch(_args.ptr(dst), _args.ptr(pos), _args.ptr(mask), _args.ptr(rows), m, row_bytes,
             _args.ptr(out), *_args.stream_args(dst.device))
    return out
