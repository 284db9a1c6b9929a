"""Kernel 11: uplink screening, one CUDA reduction (``csrc/screen.cu``); the
port of ``src/repro/kernels/screen.py``:

  * ``screen_uplink``  per client row of the (m, W) uplink: a finite flag
                       (every entry finite) and the f32 sum over the finite
                       entries of (u - ref)^2, ref a (W,) row or (m, W)

``core.faults.screen_keep`` turns the two into the round's keep mask.  CUDA
operands are f32 or bf16 (u and ref of one dtype), any width.  Each row is
split into enough chunks to put about ``TARGET_BLOCKS`` blocks on the card
(one chunk per row at the Fig. 2 arena, 128 at an (8, 2^20) uplink); the
chunks' partial sums are added in a fixed order, so a result does not vary
from run to run.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, I, P, Kernel

SCREEN_UPLINK = Kernel(
    "screen_uplink", "screen.cu", "launch_screen_uplink",
    # u ref ref_per_row m W dtype chunks chunk sq_part fin_part sq_out fin_out dev stream
    [P, P, I, LL, LL, I, LL, LL, P, P, P, P, I, P],
    replaces="src/repro/kernels/screen.py:62",
)
THREADS = 256  # csrc/screen.cu kThreads
TARGET_BLOCKS = 8 * 132  # about eight blocks on each of the H100's SMs


def chunking(m: int, w: int, element_size: int) -> tuple[int, int]:
    """(chunks per row, elements per chunk): a chunk is a whole number of
    the block's 16-byte sweeps (THREADS vectors), and a row gets as many
    chunks as it takes to reach about TARGET_BLOCKS blocks over m rows,
    never more than it has sweeps."""
    sweep = THREADS * (16 // element_size)
    sweeps = max(1, math.ceil(w / sweep))
    per_row = min(sweeps, max(1, math.ceil(TARGET_BLOCKS / max(m, 1))))
    chunk = math.ceil(sweeps / per_row) * sweep
    return max(1, math.ceil(w / chunk)), chunk


def screen_uplink(u, ref_row):
    """(finite (m,) bool, sq (m,) f32) of the (m, W) uplink ``u`` against
    ``ref_row``, a (W,) row or an (m, W) per-row reference."""
    k = SCREEN_UPLINK
    if _args.on_cpu(k.name, u):
        return ref.screen_uplink_ref(u, ref_row)
    if u.ndim != 2:
        raise ValueError(f"{k.name}: u must be (m, W), got {tuple(u.shape)}")
    m, w = u.shape
    if u.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{k.name}: dtype {u.dtype} is not supported (f32 or bf16)")
    _args.check(k.name, "u", u, (m, w), (u.dtype,), u.device)
    per_row = ref_row.ndim == 2
    _args.check(k.name, "ref", ref_row, (m, w) if per_row else (w,), (u.dtype,), u.device)
    chunks, chunk = chunking(m, w, u.element_size())
    dev = u.device
    sq = torch.empty(m, dtype=torch.float32, device=dev)
    finite = torch.empty(m, dtype=torch.bool, device=dev)
    sq_part = fin_part = None
    if chunks > 1:
        sq_part = torch.empty(m * chunks, dtype=torch.float32, device=dev)
        fin_part = torch.empty(m * chunks, dtype=torch.int32, device=dev)
    k.launch(_args.ptr(u), _args.ptr(ref_row), int(per_row), m, w, _args.DTYPE_CODES[u.dtype],
             chunks, chunk, _args.ptr(sq_part), _args.ptr(fin_part), _args.ptr(sq),
             _args.ptr(finite), *_args.stream_args(dev))
    return finite, sq
