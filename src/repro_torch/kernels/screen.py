"""Kernel 11: uplink screening, CUDA (``csrc/screen.cu``); the port of
``src/repro/kernels/screen.py``:

  * ``screen_uplink``  per client row of the (m, W) uplink: a finite flag
                       (every entry finite) and the f32 sum over the finite
                       entries of (u - ref)^2, ref a (W,) row or (m, W)
  * ``screen_keep``    the round's keep mask from the same pass: finite, and
                       with ``screen_mult`` > 0 sq at most ``screen_mult``
                       times jnp.nanmedian of sq over the finite rows
                       (``core.faults._keep_from``), one launch

CUDA operands are f32 or bf16 (u and ref of one dtype), any width.  Each row
is split into enough chunks to put about ``TARGET_BLOCKS`` blocks on the card
(one chunk per row at the Fig. 2 arena, 128 at an (8, 2^20) uplink); the
chunks' partial sums are added in a fixed order, so a result does not vary
from run to run, and ``screen_keep``'s sq is bitwise ``screen_uplink``'s.
``screen_keep`` finds the median by a radix select over sq's bits in the
block that ends the pass last (``keep_route``: "last", and always without
the rule); with the rule over more than ``SELECT_ROWS`` rows the pass
writes sq alone and a second, cooperative launch selects across the card
("select").  Neither route runs a tensor op besides ``torch.empty``: the
ticket, the grid barrier and the histograms live in ``_args.workspace``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, F, I, P, Kernel

SCREEN_UPLINK = Kernel(
    "screen_uplink", "screen.cu", "launch_screen_uplink",
    # u ref ref_per_row m W dtype chunks chunk sq_part fin_part sq_out fin_out dev stream
    [P, P, I, LL, LL, I, LL, LL, P, P, P, P, I, P],
    replaces="src/repro/kernels/screen.py:62",
)
SCREEN_KEEP = Kernel(
    "screen_keep", "screen.cu", "launch_screen_keep",
    # u ref ref_per_row m W dtype chunks chunk mult rule sq_part fin_part sq fin keep med ws
    # stage dev stream
    [P, P, I, LL, LL, I, LL, LL, F, I, P, P, P, P, P, P, P, I, I, P],
    replaces="src/repro/kernels/screen.py:62",
)
THREADS = 256  # csrc/screen.cu kThreads
SELECT_ROWS = 8192  # csrc/screen.cu kSelectRows: keys the last block holds in shared memory
WS_INTS = 64 + 4 * 2 * 256  # csrc/screen.cu kWsInts: tickets, barrier, histograms
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
    per_row = _operands(k.name, u, ref_row)
    m, w = u.shape
    chunks, chunk = chunking(m, w, u.element_size())
    finite, sq, sq_part, fin_part = _outputs(m, chunks, u.device)
    k.launch(_args.ptr(u), _args.ptr(ref_row), int(per_row), m, w, _args.DTYPE_CODES[u.dtype],
             chunks, chunk, _args.ptr(sq_part), _args.ptr(fin_part), _args.ptr(sq),
             _args.ptr(finite), *_args.stream_args(u.device))
    return finite, sq


def _operands(name, u, ref_row) -> bool:
    """Check the (m, W) uplink and its reference; True for a per-row one."""
    if u.ndim != 2:
        raise ValueError(f"{name}: u must be (m, W), got {tuple(u.shape)}")
    m, w = u.shape
    if u.dtype not in _args.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {u.dtype} is not supported (f32 or bf16)")
    _args.check(name, "u", u, (m, w), (u.dtype,), u.device)
    per_row = ref_row.ndim == 2
    _args.check(name, "ref", ref_row, (m, w) if per_row else (w,), (u.dtype,), u.device)
    return per_row


def _outputs(m: int, chunks: int, dev):
    """(finite, sq) and, with more than one chunk a row, the chunks' scratch."""
    sq = torch.empty(m, dtype=torch.float32, device=dev)
    finite = torch.empty(m, dtype=torch.bool, device=dev)
    sq_part = fin_part = None
    if chunks > 1:
        sq_part = torch.empty(m * chunks, dtype=torch.float32, device=dev)
        fin_part = torch.empty(m * chunks, dtype=torch.int32, device=dev)
    return finite, sq, sq_part, fin_part


def keep_route(m: int, rule: bool) -> str:
    """The launches of ``screen_keep``: "select" (the per-row pass, then the
    cooperative select) with the outlier rule over more than
    ``SELECT_ROWS`` rows; else "last" (one launch, the block that ends last
    finishes the rows and writes the mask)."""
    return "select" if rule and m > SELECT_ROWS else "last"


def screen_keep(u, ref_row, screen_mult: float):
    """The (m,) bool keep mask of the (m, W) uplink ``u`` screened against
    ``ref_row`` ((W,) or (m, W)): finite, and with ``screen_mult`` > 0 not
    above ``screen_mult`` times the median sq of the finite rows.  On the
    CPU the plain composition (``screen_uplink_ref``, then
    ``keep_from_ref``)."""
    if _args.on_cpu(SCREEN_KEEP.name, u):
        return ref.screen_keep_ref(u, ref_row, screen_mult)
    return _keep(u, ref_row, screen_mult, None)[0]


def keep_parts(u, ref_row, screen_mult: float):
    """For checks: ``screen_keep``'s launches with what they form on the
    way, (keep, finite, sq, the median or None without the rule); on the
    CPU the plain composition's."""
    rule = screen_mult > 0.0
    if _args.on_cpu(SCREEN_KEEP.name, u):
        finite, sq = ref.screen_uplink_ref(u, ref_row)
        med = ref.nanmedian_ref(torch.where(finite, sq, math.nan)) if rule else None
        return ref.keep_from_ref(finite, sq, screen_mult), finite, sq, med
    med = torch.empty((), dtype=torch.float32, device=u.device) if rule else None
    return (*_keep(u, ref_row, screen_mult, med), med)


def _keep(u, ref_row, screen_mult: float, med):
    """Launch ``screen_keep`` on CUDA tensors: (keep, finite, sq), and the
    median into ``med`` where one is given."""
    k = SCREEN_KEEP
    per_row = _operands(k.name, u, ref_row)
    m, w = u.shape
    dev = u.device
    rule = screen_mult > 0.0
    chunks, chunk = chunking(m, w, u.element_size())
    finite, sq, sq_part, fin_part = _outputs(m, chunks, dev)
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    args = (_args.ptr(u), _args.ptr(ref_row), int(per_row), m, w, _args.DTYPE_CODES[u.dtype],
            chunks, chunk, float(screen_mult), int(rule), _args.ptr(sq_part),
            _args.ptr(fin_part), _args.ptr(sq), _args.ptr(finite), _args.ptr(keep),
            _args.ptr(med), _args.ptr(_args.workspace(dev, WS_INTS)))
    dev_args = _args.stream_args(dev)
    k.launch(*args, 0, *dev_args)
    if keep_route(m, rule) == "select":
        k.launch(*args, 1, *dev_args)
    return keep, finite, sq
