"""The round-tail kernels over the flat client arena (``csrc/round_tail.cu``);
the port of five kernels of ``src/repro/kernels/round_tail.py`` (its sixth,
the eq. (20) step over the arena, is ``fused_update.fused_update_arena``,
one kernel with the per-leaf step):

  * ``round_tail``         lam_is = rho (x_s - x_ref) - lam_s and the uplink
                           u = x_ref - lam_is / rho; lam_is only when asked
  * ``round_tail_mean``    the same, with the client mean of u in its pass
  * ``client_mean``        x_s' = mean_i u_i: the server step's first pass
  * ``server_dual``        lam' = rho (u - x_s') with lam's column sum in
                           its pass (f32, lam as stored); ``dual_from_uplink``
                           is its lam, ``server_step`` the two passes
  * ``scaffold_cv``        SCAFFOLD's c_i' = c_i - c + alpha (x_s - x_K)
  * ``ef21_rowmax``        max |u - u_hat| per (client, 128-lane row), f32
  * ``ef21_apply``         u_hat + clip(round((u - u_hat) / s), +-lo) s with
                           a per-row scale s (``ops.ef21_update`` runs the
                           two around the per-leaf scale reduction)

Client buffers are (m, W), the server rows (W,) are broadcast inside the
kernel.  CUDA operands are f32 or bf16 (all of one dtype), with f32 math.

The round tail, the client mean and the dual walk the arena's columns in
tiles of 32 16-byte groups a warp and its rows in S slices (``plan``: from
(m, W) and the card's SM count alone).  A pass that reduces adds each
column in an order that (m, W) and the SM count fix -- rows in order
within a warp, the warps of a column group in order, the slices' partials
in order by the block that
finishes a tile last (an integer ticket in ``_tickets``, reset by that
block) -- so its result is the same bits from run to run; it is not
``torch.mean``'s or ``torch.sum``'s order, and ``depth`` bounds the
difference (a sum of n terms in a fixed order of depth d is within d
roundings of |x| summed).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, F, I, P, Kernel
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

EF21_ROWMAX = Kernel(
    "ef21_rowmax", "round_tail.cu", "launch_ef21_rowmax",
    # u uh m W dtype out dev stream
    [P, P, LL, I, I, P, I, P],
    replaces="src/repro/kernels/round_tail.py:232",
)
EF21_APPLY = Kernel(
    "ef21_apply", "round_tail.cu", "launch_ef21_apply",
    # u uh scales lo m W dtype out dev stream
    [P, P, P, F, LL, I, I, P, I, P],
    replaces="src/repro/kernels/round_tail.py:263",
)


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


_ticket_bufs: dict = {}


def _tickets(device: torch.device, n: int):
    """A tile's counter each, zero between launches (the block that takes a
    tile's last ticket sets it back), one buffer per device and stream:
    launches on one stream run in order, so they can share it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    buf = _ticket_bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ticket_bufs[key] = buf
    return buf


def _walk(k: Kernel, first, reduce: bool, *args) -> None:
    """Launch column walk ``k`` over ``first``'s (m, W) with the trailing
    (partials, tickets, rows, S, rw, device, stream) arguments it needs: the
    (S, W) workspace and the tickets only when it reduces over S > 1."""
    m, w = first.shape
    dev = first.device
    dev_args = _args.stream_args(dev)
    s, rows, rw = plan(m, w, first.element_size(), _sms(dev_args[0].value), reduce)
    parts = tickets = None
    if reduce and s > 1:
        parts = torch.empty((s, w), dtype=torch.float32, device=dev)
        tickets = _tickets(dev, column_tiles(w, first.element_size(), rw))
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


def _ef21_operands(name, u, u_hat):
    """Check the (m, W) uplink and server view, W a multiple of the 128
    lanes a row scale covers; returns (m, W, dtype code)."""
    m, w, code = _clients(name, {"u": u, "u_hat": u_hat})
    if w % LANES:
        raise ValueError(f"{name}: width {w} is not a multiple of {LANES} (the arena's rows)")
    return m, w, code


def ef21_rowmax(u, u_hat):
    """Per-(client, 128-lane row) max-abs of u - u_hat: (m, W / 128) f32.
    A NaN in a row gives NaN, as ``jnp.max``."""
    k = EF21_ROWMAX
    if _args.on_cpu(k.name, u):
        return ref.ef21_rowmax_ref(u, u_hat)
    m, w, code = _ef21_operands(k.name, u, u_hat)
    out = torch.empty((m, w // LANES), dtype=torch.float32, device=u.device)
    k.launch(_args.ptr(u), _args.ptr(u_hat), m, w, code, _args.ptr(out),
             *_args.stream_args(u.device))
    return out


def ef21_apply(u, u_hat, row_scales, bits: int):
    """The integrated EF21 view u_hat' = u_hat + clip(round((u - u_hat) / s),
    +-(2^(bits-1) - 1)) s, s the (m, W / 128) f32 per-row scale."""
    k = EF21_APPLY
    if _args.on_cpu(k.name, u):
        return ref.ef21_apply_ref(u, u_hat, row_scales, bits)
    m, w, code = _ef21_operands(k.name, u, u_hat)
    _args.check(k.name, "row_scales", row_scales, (m, w // LANES), (torch.float32,), u.device)
    out = torch.empty_like(u)
    k.launch(_args.ptr(u), _args.ptr(u_hat), _args.ptr(row_scales),
             float(2 ** (bits - 1) - 1), m, w, code, _args.ptr(out),
             *_args.stream_args(u.device))
    return out
