"""Kernels 9 and 10: the cohort engine's row movement over the population
buffers, one CUDA launch each for every buffer of a round
(``csrc/gather.cu``); the port of ``src/repro/kernels/gather.py``:

  * ``row_gather``    out_b[t] = arrs_b[idx[t]]: the (mc, W_b) cohort rows
                      of each population buffer, new tensors
  * ``row_scatter_``  dsts_b[idx[t]] = rows_b[t]: the cohort's rows put back
                      into each population buffer in place; no other row is
                      read or written

The TPU kernel writes a new population buffer through an inverse position
table; here the scatter moves only the cohort's rows, and a caller that
must keep its buffer copies it first (``ops.row_scatter``).  Up to
``MAX_BUFFERS`` buffers a launch, each f32 or bf16 of its own width with
16-byte rows (W a multiple of 8 in bf16, 4 in f32); ids int32 or int64, as
``cohort_indices`` gives them (no cast).
"""
from __future__ import annotations

import array
import ctypes

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, I, P, Kernel

MAX_BUFFERS = 8  # csrc/gather.cu kMaxBufs
_IDS = (torch.int32, torch.int64)

# desc nbuf idx idx_is_64 mc dev stream
_ARGTYPES = [P, I, P, I, LL, I, P]
ROW_GATHER = Kernel("row_gather", "gather.cu", "launch_row_gather", _ARGTYPES,
                    replaces="src/repro/kernels/gather.py:46")
ROW_SCATTER = Kernel("row_scatter", "gather.cu", "launch_row_scatter", _ARGTYPES,
                     replaces="src/repro/kernels/gather.py:76")


def _rows(name, arg, t, dev):
    """Check an (n, W) row buffer of 16-byte rows on ``dev``; returns its
    row bytes."""
    if t.ndim != 2:
        raise ValueError(f"{name}: {arg} must be (rows, W), got {tuple(t.shape)}")
    if t.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} is not supported (f32 or bf16)")
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a row of {arg} is {row_bytes} bytes, not a multiple of 16")
    _args.check(name, arg, t, tuple(t.shape), (t.dtype,), dev)
    return row_bytes


def _launch(k, pops, cohorts, idx, *, ours=False) -> None:
    """Check the operands and enqueue ``k`` over the buffer table; the
    cohort buffers are not checked when ``ours`` (allocated by the
    wrapper).  The common case is tested inline; ``_rows`` and
    ``_args.check`` raise with the reason when a test fails."""
    dev, mc = pops[0].device, idx.numel()
    if not 1 <= len(pops) <= MAX_BUFFERS:
        raise ValueError(f"{k.name}: {len(pops)} buffers; a launch takes 1 to {MAX_BUFFERS}")
    if not (idx.ndim == 1 and idx.dtype in _IDS and idx.device == dev and idx.is_contiguous()):
        _args.check(k.name, "idx", idx, (mc,), _IDS, dev)
    words = []
    for b, (pop, coh) in enumerate(zip(pops, cohorts, strict=True)):
        p = pop.data_ptr()
        w = pop.shape[-1] if pop.ndim else 0
        row_bytes = w * pop.element_size()
        if not (pop.ndim == 2 and pop.dtype in _args.DTYPE_CODES and row_bytes % 16 == 0
                and pop.device == dev and pop.is_contiguous() and p % 16 == 0):
            _rows(k.name, f"buffer {b}", pop, dev)
        c = coh.data_ptr()
        if not ours and not (coh.dtype == pop.dtype and coh.shape == (mc, w)
                             and coh.device == dev and coh.is_contiguous() and c % 16 == 0):
            _rows(k.name, f"cohort rows {b}", coh, dev)
            raise ValueError(f"{k.name}: cohort rows {b} {tuple(coh.shape)} {coh.dtype} do not "
                             f"match ({mc}, {w}) {pop.dtype}")
        words += (p, c, row_bytes)
    if mc == 0:
        return
    desc = array.array("q", words)
    k.launch(ctypes.c_void_p(desc.buffer_info()[0]), len(pops), _args.ptr(idx),
             int(idx.dtype == torch.int64), mc, *_args.stream_args(dev))


def row_gather(arrs, idx) -> tuple:
    """The cohort rows ``arrs[b][idx]`` of each (m, W_b) population buffer,
    as new (mc, W_b) tensors, in one launch; ``idx`` (mc,) row ids in
    range."""
    k = ROW_GATHER
    if _args.on_cpu(k.name, arrs[0]):
        return tuple(ref.row_gather_ref(a, idx) for a in arrs)
    mc = idx.numel()
    outs = tuple(torch.empty((mc, a.shape[1]), dtype=a.dtype, device=a.device) for a in arrs)
    _launch(k, arrs, outs, idx, ours=True)
    return outs


def row_scatter_(dsts, idx, rows) -> tuple:
    """``dsts[b][idx[t]] = rows[b][t]`` for each (m, W_b) population buffer,
    in place and in one launch; returns ``dsts``.  ``idx`` (mc,) distinct
    row ids in range; ``rows[b]`` (mc, W_b), of ``dsts[b]``'s dtype and
    overlapping no population buffer.  Rows outside ``idx`` are not
    touched."""
    k = ROW_SCATTER
    if _args.on_cpu(k.name, dsts[0]):
        return tuple(ref.row_scatter_ref_(d, idx, r) for d, r in zip(dsts, rows, strict=True))
    if len(rows) != len(dsts):
        raise ValueError(f"{k.name}: {len(dsts)} buffers but {len(rows)} row blocks")
    if len({d.data_ptr() for d in dsts}) != len(dsts):
        raise ValueError(f"{k.name}: a population buffer appears twice")
    _launch(k, dsts, rows, idx)
    return tuple(dsts)
