"""The round-tail kernels over the flat client arena (``csrc/round_tail.cu``,
EF21's in ``csrc/ef21.cu``); the port of five kernels of
``src/repro/kernels/round_tail.py`` (its sixth, the eq. (20) step over the
arena, is ``fused_update.fused_update_arena``, one kernel with the per-leaf
step):

  * ``round_tail``         lam_is = rho (x_s - x_ref) - lam_s and the uplink
                           u = x_ref - lam_is / rho; lam_is only when asked
  * ``round_tail_mean``    the same, with the client mean of u in its pass
  * ``client_mean``        x_s' = mean_i u_i: the server step's first pass
  * ``server_dual``        lam' = rho (u - x_s') with lam's column sum in
                           its pass (f32, lam as stored); ``dual_from_uplink``
                           is its lam, ``server_step`` the two passes
  * ``scaffold_cv``        SCAFFOLD's c_i' = c_i - c + alpha (x_s - x_K)
  * ``scaffold_step``      SCAFFOLD's full-arena server step in two column
                           walks: c_i' (c_i kept on masked-out rows) with the
                           sums of x_up and c_i' - c_i, whose last block
                           forms x_s' and c', then c_i' - c''s column sum
  * ``ef21_rowmax``        max |u - u_hat| per (client, 128-lane row), f32
  * ``ef21_apply``         u_hat + clip(round((u - u_hat) / s), +-lo) s with
                           a per-row scale s
  * ``ef21_update``        the two with the per-(client, leaf) scale
                           between them, in one launch where a warp or a
                           block holds a (client, leaf) in registers
                           (``ef21_route``), else a max pass and an apply
                           pass that forms each scale itself

Client buffers are (m, W), the server rows (W,) are broadcast inside the
kernel.  CUDA operands are f32 or bf16 (all of one dtype), with f32 math.

The round tail, the client mean and the dual walk the arena's columns in
tiles of 32 16-byte groups a warp and its rows in S slices (``plan``: from
(m, W) and the card's SM count alone).  A pass that reduces adds each
column in an order that (m, W) and the SM count fix -- rows in order
within a warp, the warps of a column group in order, the slices' partials
in order by the block that
finishes a tile last (an integer ticket in ``_args.workspace``, reset by
that block) -- so its result is the same bits from run to run; it is not
``torch.mean``'s or ``torch.sum``'s order, and ``depth`` bounds the
difference (a sum of n terms in a fixed order of depth d is within d
roundings of |x| summed).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import IP, LL, F, I, P, Kernel
from repro_torch.kernels.ref import LANES

DTYPES = tuple(_args.DTYPE_CODES)

ROUND_TAIL = Kernel(
    "round_tail", "round_tail.cu", "launch_round_tail",
    # xr lam xs rho m W dtype lam_is_out up_out mean_out partials tickets rows S rw dev
    # stream
    [P, P, P, F, LL, I, I, P, P, P, P, P, LL, I, I, I, P],
    replaces="src/repro/kernels/round_tail.py:89",
)
# the same launcher with the client mean in its pass: a full round's tail
ROUND_TAIL_MEAN = Kernel(
    "round_tail_mean", "round_tail.cu", "launch_round_tail", ROUND_TAIL.argtypes,
    replaces="src/repro/kernels/round_tail.py:89",
)
DUAL_FROM_UPLINK = Kernel(
    "dual_from_uplink", "round_tail.cu", "launch_dual_from_uplink",
    # u xs rho m W dtype out colsum_out partials tickets rows S rw dev stream
    [P, P, F, LL, I, I, P, P, P, P, LL, I, I, I, P],
    replaces="src/repro/kernels/round_tail.py:202",
)
# the server step's first pass, before kernel 3's dual
CLIENT_MEAN = Kernel(
    "client_mean", "round_tail.cu", "launch_client_mean",
    # u m W dtype mean_out partials tickets rows S rw dev stream
    [P, LL, I, I, P, P, P, LL, I, I, I, P],
    replaces="src/repro/kernels/round_tail.py:202",
)
SCAFFOLD_CV = Kernel(
    "scaffold_cv", "round_tail.cu", "launch_scaffold_cv",
    # ci xk c xs alpha_arr alpha m W dtype out dev stream
    [P, P, P, P, P, F, LL, I, I, P, I, P],
    replaces="src/repro/kernels/round_tail.py:152",
)
# kernel 5 redesigned as SCAFFOLD's full-arena server step: two launches a
# call (its passes), both counted here
SCAFFOLD_STEP = Kernel(
    "scaffold_step", "round_tail.cu", "launch_scaffold_step",
    # ci xt c xs alpha_arr alpha mask eta_g m W dtype pass ci_out xs_out c_out colsum_out
    # partials tickets rows S rw dev stream
    [P, P, P, P, P, F, P, F, LL, I, I, I, P, P, P, P, P, P, LL, I, I, I, P],
    replaces="src/repro/kernels/round_tail.py:152",
)

# kernels 7-8 and the EF21 uplink they make up, one launcher in csrc/ef21.cu
# u uh out table lo given m W dtype mode threads chunks chunk0 span0 nleaf spans L reverse
# dev stream
EF21_ARGTYPES = [P, P, P, P, F, I, LL, I, I, I, I, I, IP, IP, I, I, I, I, I, P]
EF21_ROWMAX = Kernel("ef21_rowmax", "ef21.cu", "launch_ef21", EF21_ARGTYPES,
                     replaces="src/repro/kernels/round_tail.py:232")
EF21_APPLY = Kernel("ef21_apply", "ef21.cu", "launch_ef21", EF21_ARGTYPES,
                    replaces="src/repro/kernels/round_tail.py:263")
# the two with the per-(client, leaf) scales between them: one launch on the
# resident routes, two (its max pass, then its apply pass) on the wide one
EF21_UPDATE = Kernel("ef21_update", "ef21.cu", "launch_ef21", EF21_ARGTYPES,
                     replaces="src/repro/kernels/round_tail.py:232, :263")


# the column walks' grid (csrc/round_tail.cu): 8 warps a block, a warp across
# 32 16-byte column groups, rw warps walking a group's rows (8 rows or more
# a warp before a group takes a second warp), slices sized for 4 blocks an
# SM (the launch bounds hold a thread to 64 registers, which the reducing
# passes use) and at least 4 rows a warp where the pass reduces (1 where it
# does not)
WARPS = 8
GROUPS = 32
BLOCKS_PER_SM = 4
ROWS_PER_WARP = 8
MIN_ROWS_PER_WARP = 4
SMS = 132  # H100 SXM; the wrappers read the card's own count


def vec(w: int, element_size: int) -> int:
    """Values a lane moves at once: 16 bytes of the dtype, or 1 when ``w``
    is not a multiple of that (rows would not be 16-byte aligned)."""
    v = 16 // element_size
    return v if w % v == 0 else 1


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _warp_cols(w: int, element_size: int) -> int:
    """Warps' worth of column groups across the width (32 groups a warp)."""
    return -(-(w // vec(w, element_size)) // GROUPS)


def plan(m: int, w: int, element_size: int, sms: int = SMS, reduce: bool = True
         ) -> tuple[int, int, int]:
    """(S, rows, rw): the arena's rows in S slices of ``rows`` each (the
    last may be shorter, none is empty), and rw warps walking a column
    group's rows (the block's other 8 / rw warps take other groups).  S = 1
    once the column tiles alone fill ``BLOCKS_PER_SM`` blocks an SM."""
    rw = _pow2_floor(min(WARPS, -(-m // ROWS_PER_WARP)))
    rw = WARPS // min(WARPS // rw, _pow2_floor(min(WARPS, _warp_cols(w, element_size))))
    tiles = column_tiles(w, element_size, rw)
    min_rows = MIN_ROWS_PER_WARP if reduce else 1
    s = max(1, min(-(-sms * BLOCKS_PER_SM // tiles), -(-m // (rw * min_rows))))
    rows = max(1, -(-m // s))
    return max(1, -(-m // rows)), rows, rw


def column_tiles(w: int, element_size: int, rw: int) -> int:
    """Blocks across the width: 8 / rw warps of 32 16-byte column groups."""
    return -(-_warp_cols(w, element_size) // (WARPS // rw))


def depth(m: int, w: int, element_size: int, sms: int = SMS) -> int:
    """The longest chain of f32 additions in a column's sum: a warp's rows
    of a slice, the rw warps of its column group, then the S partials in
    P runs."""
    s, rows, rw = plan(m, w, element_size, sms)
    tile = (WARPS // rw) * GROUPS * vec(w, element_size)
    runs = max(1, WARPS * 32 // tile)
    return -(-rows // rw) + rw + (0 if s == 1 else -(-s // runs) + runs)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def depth_on(u) -> int:
    """``depth`` of a reducing pass over the CUDA tensor ``u`` as the
    wrappers plan it on its card."""
    m, w = u.shape
    return depth(m, w, u.element_size(), _sms(_args.stream_args(u.device)[0].value))


def _walk(k: Kernel, first, reduce: bool, *args, sums: int = 1) -> None:
    """Launch column walk ``k`` over ``first``'s (m, W) with the trailing
    (partials, tickets, rows, S, rw, device, stream) arguments it needs: the
    (sums, S, W) workspace and the tickets only when it reduces over S > 1."""
    m, w = first.shape
    dev = first.device
    dev_args = _args.stream_args(dev)
    s, rows, rw = plan(m, w, first.element_size(), _sms(dev_args[0].value), reduce)
    parts = tickets = None
    if reduce and s > 1:
        parts = torch.empty((sums, s, w), dtype=torch.float32, device=dev)
        tickets = _args.workspace(dev, column_tiles(w, first.element_size(), rw))
    k.launch(*args, _args.ptr(parts), _args.ptr(tickets), rows, s, rw, *dev_args)


def _clients(name, client: dict):
    """Check the (m, W) client operands, all of the first one's dtype and
    device; returns (m, W, dtype code)."""
    first = next(iter(client.values()))
    if first.ndim != 2:
        raise ValueError(f"{name}: expected (m, W) client operands, got {tuple(first.shape)}")
    m, w = first.shape
    dev, dt = first.device, first.dtype
    if dt not in DTYPES:
        raise TypeError(f"{name}: dtype {dt} is not supported (f32 or bf16)")
    for arg, t in client.items():
        _args.check(name, arg, t, (m, w), (dt,), dev)
    return m, w, _args.DTYPE_CODES[dt]


def _client_and_server(name, client: dict, x_s, *server):
    """Check the (m, W) client operands and the (W,) server rows; returns
    (m, W, dtype code)."""
    m, w, code = _clients(name, client)
    first = next(iter(client.values()))
    for arg, t in (("x_s", x_s),) + server:
        _args.check(name, arg, t, (w,), (first.dtype,), first.device)
    return m, w, code


def round_tail(x_ref, lam_s, x_s, rho, *, with_lam_is: bool = True):
    """Returns (lam_is, uplink); lam_is is None when ``with_lam_is=False``."""
    k = ROUND_TAIL
    if _args.on_cpu(k.name, x_ref):
        return ref.round_tail_ref(x_ref, lam_s, x_s, rho, with_lam_is=with_lam_is)
    lam_is, uplink, _ = _round_tail(k, x_ref, lam_s, x_s, rho, with_lam_is, None)
    return lam_is, uplink


def round_tail_mean(x_ref, lam_s, x_s, rho, *, with_lam_is: bool = True):
    """``round_tail`` with the client mean of the uplink it writes, taken in
    the same pass: (lam_is, uplink, x_s' (W,) in the uplink's dtype)."""
    k = ROUND_TAIL_MEAN
    if _args.on_cpu(k.name, x_ref):
        return ref.round_tail_mean_ref(x_ref, lam_s, x_s, rho, with_lam_is=with_lam_is)
    return _round_tail(k, x_ref, lam_s, x_s, rho, with_lam_is,
                       torch.empty(x_ref.shape[1], dtype=x_ref.dtype, device=x_ref.device))


def _round_tail(k, x_ref, lam_s, x_s, rho, with_lam_is, mean):
    m, w, code = _client_and_server(k.name, {"x_ref": x_ref, "lam_s": lam_s}, x_s)
    uplink = torch.empty_like(x_ref)
    lam_is = torch.empty_like(x_ref) if with_lam_is else None
    if w:
        _walk(k, x_ref, mean is not None, _args.ptr(x_ref), _args.ptr(lam_s), _args.ptr(x_s),
              float(rho), m, w, code, _args.ptr(lam_is), _args.ptr(uplink), _args.ptr(mean))
    return lam_is, uplink, mean


def client_mean(u):
    """x_s' = mean_i u_i of the (m, W) uplink, (W,) in its dtype (the f32
    sum rounded once): the server step's first pass."""
    k = CLIENT_MEAN
    if _args.on_cpu(k.name, u):
        return ref.client_mean_ref(u)
    m, w, code = _clients(k.name, {"u": u})
    out = torch.empty(w, dtype=u.dtype, device=u.device)
    if w:
        _walk(k, u, True, _args.ptr(u), m, w, code, _args.ptr(out))
    return out


def dual_from_uplink(uplink, x_s, rho):
    """lam_s' = rho (u - x_s'), (m, W): ``server_dual``'s lam."""
    if _args.on_cpu(DUAL_FROM_UPLINK.name, uplink):
        return ref.dual_from_uplink_ref(uplink, x_s, rho)
    return server_dual(uplink, x_s, rho)[0]


def server_dual(uplink, x_s, rho):
    """The server step's second pass: (lam_s' = rho (u - x_s'), lam_s''s
    column sum (W,) f32 of lam_s' as stored), one launch."""
    k = DUAL_FROM_UPLINK
    if _args.on_cpu(k.name, uplink):
        return ref.server_dual_ref(uplink, x_s, rho)
    m, w, code = _client_and_server(k.name, {"uplink": uplink}, x_s)
    out = torch.empty_like(uplink)
    colsum = torch.empty(w, dtype=torch.float32, device=uplink.device)
    if w:
        _walk(k, uplink, True, _args.ptr(uplink), _args.ptr(x_s), float(rho), m, w, code,
              _args.ptr(out), _args.ptr(colsum))
    return out, colsum


def server_step(uplink, rho):
    """The server step over the (m, W) uplink (or its cache): (x_s', lam_s',
    lam_s''s f32 column sum), two passes -- the client mean, then the dual
    with the column sum."""
    if _args.on_cpu(CLIENT_MEAN.name, uplink):
        return ref.server_step_ref(uplink, rho)
    x_s = client_mean(uplink)
    return (x_s,) + server_dual(uplink, x_s, rho)


def scaffold_cv(c_i, x_K, c_s, x_s, alpha):
    """SCAFFOLD's eq. (30) control-variate refresh, (c_i - c) + alpha
    (x_s - x_K): c_i, x_K (m, W); c_s, x_s (W,); ``alpha`` = 1/(K eta), a
    Python float or an (m,) f32 tensor."""
    k = SCAFFOLD_CV
    if _args.on_cpu(k.name, c_i):
        return ref.scaffold_cv_ref(c_i, x_K, c_s, x_s, alpha)
    m, w, code = _client_and_server(k.name, {"c_i": c_i, "x_K": x_K}, x_s, ("c_s", c_s))
    alpha_arr, alpha_f = _args.step_operand(k.name, alpha, m, c_i.device)
    out = torch.empty_like(c_i)
    k.launch(_args.ptr(c_i), _args.ptr(x_K), _args.ptr(c_s), _args.ptr(x_s),
             _args.ptr(alpha_arr), alpha_f, m, w, code, _args.ptr(out),
             *_args.stream_args(c_i.device))
    return out


def scaffold_step(c_i, x_t, c_s, x_s, alpha, eta_g: float, mask=None):
    """SCAFFOLD's full-arena round tail and server step: (c_i', x_s', c',
    the f32 column sum of c_i' - c').  c_i' = (c_i - c) + alpha (x_s - x_t)
    as ``scaffold_cv`` (c_i where ``mask``, an (m,) bool, is false);
    x_s' = x_s + eta_g (mean_i x_up - x_s) with x_up = x_t where ``mask``,
    else x_s; c' = c + mean_i (c_i' - c_i).  On the CPU the plain
    composition (``ref.scaffold_step_ref``); on the card two column walks,
    c_i' with the two column sums (the tile's last block forms x_s' and c'),
    then the column sum of c_i' - c', with nothing but ``torch.empty``
    around them."""
    k = SCAFFOLD_STEP
    if _args.on_cpu(k.name, c_i):
        return ref.scaffold_step_ref(c_i, x_t, c_s, x_s, alpha, eta_g, mask)
    m, w, code = _client_and_server(k.name, {"c_i": c_i, "x_t": x_t}, x_s, ("c_s", c_s))
    dev = c_i.device
    alpha_arr, alpha_f = _args.step_operand(k.name, alpha, m, dev)
    if mask is not None:
        _args.check(k.name, "mask", mask, (m,), (torch.bool,), dev)
    c_new_i = torch.empty_like(c_i)
    x_s_new = torch.empty_like(x_s)
    c_new = torch.empty_like(c_s)
    colsum = torch.empty(w, dtype=torch.float32, device=dev)
    if w:
        head = (_args.ptr(c_i), _args.ptr(x_t), _args.ptr(c_s), _args.ptr(x_s),
                _args.ptr(alpha_arr), alpha_f, _args.ptr(mask),
                ref.scalar_as(eta_g, c_i.dtype), m, w, code)
        outs = (_args.ptr(c_new_i), _args.ptr(x_s_new), _args.ptr(c_new), _args.ptr(colsum))
        _walk(k, c_i, True, *head, 1, *outs, sums=2)
        _walk(k, c_i, True, *head, 2, *outs)
    return c_new_i, x_s_new, c_new, colsum


def _ef21_operands(name, u, u_hat):
    """Check the (m, W) uplink and server view, W a multiple of the 128
    lanes a row scale covers; returns (m, W, dtype code)."""
    m, w, code = _clients(name, {"u": u, "u_hat": u_hat})
    if w % LANES:
        raise ValueError(f"{name}: width {w} is not a multiple of {LANES} (the arena's rows)")
    return m, w, code


# csrc/ef21.cu's modes and spans: a group of 32 or 256 threads, each holding
# up to RESIDENT_CHUNKS 16-byte chunks of u and of u_hat; the wide route's
# spans are 256 threads x WIDE_CHUNKS chunks
EF21_MAX, EF21_APPLY_MODE, EF21_FUSED = 0, 1, 2
RESIDENT_CHUNKS = 8
WIDE_CHUNKS = 4
EF21_THREADS = {"warp": 32, "block": 256, "wide": 256}


class Ef21Plan(NamedTuple):
    """One EF21 update's launches: the route, a group's threads and chunks a
    thread, and the leaf table -- leaf k's 16-byte chunks of a client row are
    [chunk0[k], chunk0[k + 1]) and its spans [span0[k], span0[k + 1])."""

    route: str
    threads: int
    chunks: int
    chunk0: tuple
    span0: tuple


def chunks_per_row(dtype) -> int:
    """16-byte chunks of a 128-lane row: 32 in f32, 16 in bf16."""
    return LANES * dtype.itemsize // 16


def ef21_route(leaf_rows, dtype) -> str:
    """The route of ``ef21_update`` for leaves of ``leaf_rows`` 128-lane
    rows in ``dtype``: "warp" (one launch, a warp a (client, leaf)) while
    the longest leaf fits a warp's registers, "block" (one launch, a block
    a (client, leaf)) while it fits a block's, else "wide" (two launches)."""
    longest = max(leaf_rows, default=0) * chunks_per_row(dtype)
    for route in ("warp", "block"):
        if longest <= EF21_THREADS[route] * RESIDENT_CHUNKS:
            return route
    return "wide"


def ef21_plan(leaf_rows, width: int, dtype, route=None) -> Ef21Plan:
    """The launch plan of ``ef21_update`` over a (m, ``width``) arena of
    ``dtype`` whose leaves have ``leaf_rows`` rows: on ``route`` (default
    ``ef21_route``), a resident route giving each leaf one span of a group,
    the wide route ceil(chunks / (256 x WIDE_CHUNKS)) spans.  Raises for
    leaves that do not cover the width and for a resident route too small
    for the longest leaf."""
    leaf_rows = tuple(int(r) for r in leaf_rows)
    if any(r < 0 for r in leaf_rows) or sum(leaf_rows) * LANES != width:
        raise ValueError(f"ef21_update: leaf_rows {leaf_rows} cover {sum(leaf_rows)} rows, "
                         f"not the {width // LANES} of width {width}")
    route = route or ef21_route(leaf_rows, dtype)
    if route not in EF21_THREADS:
        raise ValueError(f"ef21_update: route {route!r} is none of {tuple(EF21_THREADS)}")
    cpr, threads = chunks_per_row(dtype), EF21_THREADS[route]
    lens = [r * cpr for r in leaf_rows]
    longest = max(lens, default=0)
    if route == "wide":
        chunks = WIDE_CHUNKS
        spans = [-(-n // (threads * chunks)) for n in lens]
    else:
        need = max(1, -(-longest // threads))
        if need > RESIDENT_CHUNKS:
            raise ValueError(f"ef21_update: a leaf of {longest // cpr} rows does not fit the "
                             f"{route} route ({threads * RESIDENT_CHUNKS // cpr} rows at most)")
        chunks = 1 << (need - 1).bit_length()
        spans = [1] * len(lens)
    return Ef21Plan(route, threads, chunks, tuple(itertools.accumulate(lens, initial=0)),
                    tuple(itertools.accumulate(spans, initial=0)))


@functools.lru_cache(maxsize=256)
def _ef21_launch_plan(leaf_rows: tuple, width: int, dtype, route):
    """``ef21_plan`` with its tables as C arrays, cached per layout: a round
    builds nothing on the host."""
    plan = ef21_plan(leaf_rows, width, dtype, route)
    arr = ctypes.c_int * len(plan.chunk0)
    return plan, arr(*plan.chunk0), arr(*plan.span0)


def _ef21_launch(k: Kernel, u, u_hat, out, table, lo: float, given: int, mode: int, threads: int,
                 chunks: int, tabs, spans: int, cols: int, reverse: int = 0) -> None:
    m, w = u.shape
    c0, s0 = tabs
    k.launch(_args.ptr(u), _args.ptr(u_hat), _args.ptr(out), _args.ptr(table), lo, given, m, w,
             _args.DTYPE_CODES[u.dtype], mode, threads, chunks, c0, s0,
             0 if c0 is None else len(c0) - 1, spans, cols, reverse, *_args.stream_args(u.device))


def ef21_rowmax(u, u_hat):
    """Per-(client, 128-lane row) max-abs of u - u_hat: (m, W / 128) f32.
    A NaN in a row gives NaN, as ``jnp.max``."""
    k = EF21_ROWMAX
    if _args.on_cpu(k.name, u):
        return ref.ef21_rowmax_ref(u, u_hat)
    m, w, _ = _ef21_operands(k.name, u, u_hat)
    out = torch.empty((m, w // LANES), dtype=torch.float32, device=u.device)
    if m and w:
        _ef21_launch(k, u, u_hat, None, out, 0.0, 0, EF21_MAX, 32, 1, (None, None),
                     w // LANES, w // LANES)
    return out


def ef21_apply(u, u_hat, row_scales, bits: int):
    """The integrated EF21 view u_hat' = u_hat + clip(round((u - u_hat) / s),
    +-(2^(bits-1) - 1)) s, s the (m, W / 128) f32 per-row scale."""
    k = EF21_APPLY
    if _args.on_cpu(k.name, u):
        return ref.ef21_apply_ref(u, u_hat, row_scales, bits)
    m, w, _ = _ef21_operands(k.name, u, u_hat)
    _args.check(k.name, "row_scales", row_scales, (m, w // LANES), (torch.float32,), u.device)
    out = torch.empty((m, w), dtype=u.dtype, device=u.device)
    if m and w:
        _ef21_launch(k, u, u_hat, out, row_scales, float(2 ** (bits - 1) - 1), 1,
                     EF21_APPLY_MODE, 32, 1, (None, None), w // LANES, w // LANES)
    return out


def ef21_update(u, u_hat, bits: int, leaf_rows, route=None, *, reverse: bool = True):
    """The EF21 uplink over the arena: u_hat' = u_hat + qdq(u - u_hat) with
    one scale per (client, leaf) (``leaf_rows`` = ``ArenaSpec.leaf_rows()``).
    On the CPU the plain composition (row max, per-leaf scales, apply); on
    the card one launch on the resident routes, the max pass then the apply
    pass (walking the arena backwards unless ``reverse=False``) on the wide
    one, with nothing but ``torch.empty`` around them.  ``route`` forces a
    route of ``ef21_plan``."""
    k = EF21_UPDATE
    if _args.on_cpu(k.name, u):
        return ref.ef21_update_ref(u, u_hat, bits, leaf_rows)
    m, w, _ = _ef21_operands(k.name, u, u_hat)
    plan, c0, s0 = _ef21_launch_plan(tuple(leaf_rows), w, u.dtype, route)
    lo = float(2 ** (bits - 1) - 1)
    out = torch.empty((m, w), dtype=u.dtype, device=u.device)
    if not (m and w):
        return out
    nleaf, spans = len(plan.chunk0) - 1, plan.span0[-1]
    if plan.route != "wide":
        _ef21_launch(k, u, u_hat, out, None, lo, 0, EF21_FUSED, plan.threads, plan.chunks,
                     (c0, s0), spans, nleaf)
        return out
    table = torch.empty((m, nleaf), dtype=torch.float32, device=u.device)
    for mode, rev in ((EF21_MAX, 0), (EF21_APPLY_MODE, int(reverse))):
        _ef21_launch(k, u, u_hat, out, table, lo, 0, mode, plan.threads, plan.chunks, (c0, s0),
                     spans, nleaf, rev)
    return out
