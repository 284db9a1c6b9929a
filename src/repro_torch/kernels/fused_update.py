"""Kernels 4 and 6: the eq. (20) client step, one CUDA pass over a list of
segments (``csrc/fused_update.cu``); the port of
``src/repro/kernels/fused_update.py::fused_update_pallas`` (one leaf) and
``src/repro/kernels/round_tail.py::fused_update_arena_pallas`` (the arena):

    x' = x - step * (g + rho * (x - xs) + lam)

A segment is one leaf of a step, or the whole ``(m, W)`` arena with the
server row broadcast.  One launch steps every leaf of a tree of one dtype
(``fused_update_leaves``), and keeps GPDMM's running sum for x_bar in the
same pass (``accs``, updated in place, see ``ACC_MODES``).  Unlike the
reference, which sends per-client steps to plain XLA (``ops.py:276``), the
kernel takes the per-client step as an operand, and it takes the server
leaf without the client dim and broadcasts it.

The launch counts stay per name: ``fused_update`` for the per-leaf calls,
``fused_update_arena`` for the arena's.

The module also keeps the arena lane width shared by the port
(``LANES``, ``ceil_to``).  The TPU sizing constants of the reference
(``BLOCK_ROWS``, ``VMEM_CAP_BYTES``, ``assert_vmem_budget``) do not carry
over: each Hopper kernel sizes itself.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import F, I, P, Kernel, load

# every arena leaf is padded to a multiple of LANES (core.arena); the port
# keeps the reference's slice table element for element
LANES = 128

SOURCE, SYMBOL = "fused_update.cu", "launch_eq20_segments"
# desc nseg step_arr step rho acc_scale acc_flags dtype dev stream
ARGTYPES = [P, I, P, F, F, F, I, I, I, P]
KERNEL = Kernel("fused_update", SOURCE, SYMBOL, ARGTYPES,
                replaces="src/repro/kernels/fused_update.py:71")
ARENA_KERNEL = Kernel("fused_update_arena", SOURCE, SYMBOL, ARGTYPES,
                      replaces="src/repro/kernels/round_tail.py:328")

# the running sum's update in the step's pass, as the plain passes it
# replaces (xsum = 0, then xsum = xsum + x' every step, then xsum * s):
#   "first"  acc = 0 + x'                step 0 of K
#   "add"    acc = acc + x'
#   "last"   acc = (acc + x') * s        step K-1, s = 1/K as acc's dtype
#   "only"   acc = (0 + x') * s          K = 1
ACC_MODES = {"add": 0, "first": 1, "last": 2, "only": 3}  # csrc AccFlags bits

THREADS = 256  # csrc kThreads
_DTYPES = {torch.float32: (_args.DTYPE_CODES[torch.float32], 4),  # (code, values a 16 B group)
           torch.bfloat16: (_args.DTYPE_CODES[torch.bfloat16], 8)}
# the grid's cap, in blocks of THREADS an SM: 64 (16 waves at the 4 blocks
# an SM that 56-80 registers a thread leave) steps lm_tree in 118 us, 8
# (one wave at full occupancy) in 127 us, on the H100 (chip_smoke's step
# rows); lm_flat's one segment takes 73 us either way
BLOCKS_PER_SM = 64
SMS = 132  # H100 SXM; ``plan`` reads the card's own count
DESC_WORDS = 10  # csrc kDescWords


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def acc_mode_at(k: int, steps: int) -> str:
    """The running sum's mode at step ``k`` of ``steps``."""
    if steps == 1:
        return "only"
    return "first" if k == 0 else ("last" if k == steps - 1 else "add")


def segment_blocks(numels, vec: int, sms: int = SMS) -> list[int]:
    """Blocks of one launch for each segment: one thread per 16-byte group
    of ``vec`` values, so ceil(groups / THREADS) blocks a segment; above
    the grid's cap (``sms`` x ``BLOCKS_PER_SM``) each share is scaled down
    (at least one block a segment), and the blocks stride."""
    per_block = vec * THREADS
    want = [max(1, -(-n // per_block)) for n in numels]
    cap = sms * BLOCKS_PER_SM
    total = sum(want)
    if total <= cap:
        return want
    return [max(1, w * cap // total) for w in want]


def plan(numels, vec: int, max_segments: int, sms: int = SMS) -> list[list[tuple[int, int]]]:
    """The launches for segments of ``numels`` elements (one dtype, empty
    segments already dropped): as few chunks of at most ``max_segments`` as
    the kernel's parameter limit allows, each a list of (segment index,
    blocks)."""
    out = []
    for c0 in range(0, len(numels), max_segments):
        part = numels[c0:c0 + max_segments]
        out.append(list(zip(range(c0, c0 + len(part)), segment_blocks(part, vec, sms))))
    return out


@functools.lru_cache(maxsize=None)
def max_segments() -> int:
    """The most segments one launch takes, from the built library (the
    parameter limit of the toolkit it was built with)."""
    fn = load(SOURCE).eq20_max_segments
    fn.restype = ctypes.c_int
    return int(fn())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kernel, rows, dt, step_arr, step_f: float, rho: float, flags: int,
            acc_scale: float, dev_args) -> None:
    """Enqueue ``rows`` of one dtype -- each the addresses of x, g, xs,
    lam, out and acc (0: none) and n, xs_n, per_client -- in as few
    launches as the table allows."""
    code, vec = _DTYPES[dt]
    scale = ref.scalar_as(acc_scale, dt)
    for chunk in plan([r[6] for r in rows], vec, max_segments(), _sms(dev_args[0].value)):
        words = array.array("q", [w for i, blocks in chunk for w in (*rows[i], blocks)])
        kernel.launch(ctypes.c_void_p(words.buffer_info()[0]), len(chunk),
                      _args.ptr(step_arr), step_f, float(rho), scale, flags, code, *dev_args)


def _operand(name, arg, t, shape, dt, dev) -> int:
    """The address of operand ``t`` (0 for None) after ``_args.check``'s
    checks, the common case tested inline (``_args.check`` raises with the
    reason when one fails)."""
    if t is None:
        return 0
    p = t.data_ptr()
    if not (t.dtype == dt and t.shape == shape and t.device == dev and p % 16 == 0
            and t.is_contiguous()):
        _args.check(name, arg, t, shape, (dt,), dev)
    return p


def _step(name, step, m: int, device):
    """(step array, scalar) for the launcher: a per-client step of shape
    (m,) or (m, 1, ...) as an (m,) f32 array."""
    if not torch.is_tensor(step):
        return None, float(step)
    if step.ndim > 0:
        if tuple(step.shape) != (m,) + (1,) * (step.ndim - 1):
            raise ValueError(f"{name}: step has shape {tuple(step.shape)}, expected "
                             f"({m},) or ({m}, 1, ...)")
        step = step.reshape(m)
    return _args.step_operand(name, step, m, device)


def _flags(name, mode: str) -> int:
    """The kernel's acc flags of ``mode``."""
    if mode not in ACC_MODES:
        raise ValueError(f"{name}: acc_mode {mode!r} is not one of {sorted(ACC_MODES)}")
    return ACC_MODES[mode]


def fused_update(x, g, xs, lam, step, rho):
    """x, g, lam: one leaf (leading client dim m); ``xs`` of x's shape or
    x's shape without the client dim; ``lam`` may be None; ``step`` a
    Python float or a per-client f32 tensor, ``(m,)`` or ``(m, 1, ...)``.
    CUDA operands are f32 or bf16, all of x's dtype, contiguous."""
    if _args.on_cpu(KERNEL.name, x):
        return ref.fused_update_ref(x, g, xs, lam, step, rho)
    return _segment(KERNEL, x, g, xs, lam, step, rho, None, "add", 1.0)


def fused_update_arena(x, g, x_s, lam, step, rho, acc=None, acc_mode: str = "add",
                       acc_scale: float = 1.0):
    """x - step (g + rho (x - x_s) + lam) over the ``(m, W)`` arena, the
    ``(W,)`` server row broadcast; ``lam`` may be None, ``step`` a Python
    float or an (m,) f32 tensor.  With ``acc`` (an (m, W) buffer of x's
    dtype) the running sum is updated in place in ``acc_mode``
    (``ACC_MODES``; ``acc_scale`` = 1/K for "last" and "only")."""
    k = ARENA_KERNEL
    if _args.on_cpu(k.name, x):
        return ref.fused_update_arena_ref(x, g, x_s, lam, step, rho, acc=acc,
                                          acc_mode=acc_mode, acc_scale=acc_scale)
    if x.ndim != 2:
        raise ValueError(f"{k.name}: expected (m, W) client operands, got {tuple(x.shape)}")
    return _segment(k, x, g, x_s, lam, step, rho, acc, acc_mode, acc_scale)


def fused_update_leaves(xs, gs, x_ss, lams, step, rho, *, accs=None, acc_mode: str = "add",
                        acc_scale: float = 1.0):
    """The eq. (20) step of every leaf of a tree: lists of leaves x, g, the
    server leaf (full, or without the client dim), lam (entries may be
    None) and, optionally, the running sums ``accs`` (updated in place in
    ``acc_mode``, ``acc_scale`` = 1/K for "last" and "only").  Every leaf
    has the client dim m first; ``step`` a Python float or an (m,) f32
    tensor.  Returns the new leaves.  On the card one launch per dtype."""
    if not xs:
        return []
    if _args.on_cpu(KERNEL.name, xs[0]):
        return ref.fused_update_leaves_ref(xs, gs, x_ss, lams, step, rho, accs=accs,
                                           acc_mode=acc_mode, acc_scale=acc_scale)
    if len(xs) == 1:
        return [_segment(KERNEL, xs[0], gs[0], x_ss[0], lams[0], step, rho,
                         accs[0] if accs else None, acc_mode, acc_scale)]
    return _leaves(xs, gs, x_ss, lams, step, rho, accs, acc_mode, acc_scale)


def _segment(k, x, g, xs, lam, step, rho, acc, acc_mode, acc_scale):
    """One segment -- a leaf, or the arena with its server row -- in one
    launch, without ``_leaves``'s grouping and chunking: the host path of
    the one-leaf and arena steps, host-paced in their rounds."""
    flags = _flags(k.name, acc_mode)
    shape, dev, dt = x.shape, x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"{k.name}: dtype {dt} is not supported (f32 or bf16)")
    m = shape[0] if shape else 1
    step_arr, step_f = _step(k.name, step, m, dev)
    words = array.array("q", (
        _operand(k.name, "x", x, shape, dt, dev), _operand(k.name, "g", g, shape, dt, dev),
        _operand(k.name, "xs", xs, shape if xs.shape == shape else shape[1:], dt, dev),
        _operand(k.name, "lam", lam, shape, dt, dev), 0,
        _operand(k.name, "acc", acc, shape, dt, dev)))
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        code, vec = _DTYPES[dt]
        dev_args = _args.stream_args(dev)
        words[4] = out.data_ptr()
        words.extend((n, xs.numel(), n // m, segment_blocks([n], vec, _sms(dev_args[0].value))[0]))
        k.launch(ctypes.c_void_p(words.buffer_info()[0]), 1, _args.ptr(step_arr), step_f,
                 float(rho), ref.scalar_as(acc_scale, dt), flags, code, *dev_args)
    return out


def _leaves(xs, gs, x_ss, lams, step, rho, accs, acc_mode, acc_scale):
    """``fused_update_leaves`` on the card: check each operand once, group
    the non-empty leaves by dtype, then one launch per dtype (per chunk of
    the table)."""
    name = KERNEL.name
    flags = _flags(name, acc_mode)
    x0 = xs[0]
    dev = x0.device
    m = x0.shape[0] if x0.ndim else 1
    step_arr, step_f = _step(name, step, m, dev)
    outs, groups = [], {}
    for x, g, s, lam, acc in zip(xs, gs, x_ss, lams, accs or (None,) * len(xs), strict=True):
        shape, dt = x.shape, x.dtype
        if dt not in _DTYPES:
            raise TypeError(f"{name}: dtype {dt} is not supported (f32 or bf16)")
        if (shape[0] if shape else 1) != m:
            raise ValueError(f"{name}: leaf of shape {tuple(shape)} has another client count "
                             f"than {m}")
        row = (_operand(name, "x", x, shape, dt, dev), _operand(name, "g", g, shape, dt, dev),
               _operand(name, "xs", s, shape if s.shape == shape else shape[1:], dt, dev),
               _operand(name, "lam", lam, shape, dt, dev))
        acc_ptr = _operand(name, "acc", acc, shape, dt, dev)
        out = torch.empty_like(x)
        outs.append(out)
        n = x.numel()
        if n:
            groups.setdefault(dt, []).append(
                row + (out.data_ptr(), acc_ptr, n, s.numel(), n // m))
    if groups:
        dev_args = _args.stream_args(dev)
        for dt, rows in groups.items():
            _launch(KERNEL, rows, dt, step_arr, step_f, rho, flags, acc_scale, dev_args)
    return outs
