"""The round-tail kernels over the flat client arena, each one CUDA pass
(``csrc/round_tail.cu``); the port of five kernels of
``src/repro/kernels/round_tail.py`` (its sixth, the eq. (20) step over the
arena, is ``fused_update.fused_update_arena``, one kernel with the
per-leaf step):

  * ``round_tail``         lam_is = rho (x_s - x_ref) - lam_s and the uplink
                           u = x_ref - lam_is / rho; lam_is only when asked
  * ``dual_from_uplink``   lam' = rho (u - x_s')
  * ``scaffold_cv``        SCAFFOLD's c_i' = c_i - c + alpha (x_s - x_K)
  * ``ef21_rowmax``        max |u - u_hat| per (client, 128-lane row), f32
  * ``ef21_apply``         u_hat + clip(round((u - u_hat) / s), +-lo) s with
                           a per-row scale s (``ops.ef21_update`` runs the
                           two around the per-leaf scale reduction)

Client buffers are (m, W), the server rows (W,) are broadcast inside the
kernel.  CUDA operands are f32 or bf16 (all of one dtype), with f32 math.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, ref
from repro_torch.kernels._build import LL, F, I, P, Kernel
from repro_torch.kernels.ref import LANES

DTYPES = tuple(_args.DTYPE_CODES)

ROUND_TAIL = Kernel(
    "round_tail", "round_tail.cu", "launch_round_tail",
    # xr lam xs rho m W dtype lam_is_out up_out dev stream
    [P, P, P, F, LL, I, I, P, P, I, P],
    replaces="src/repro/kernels/round_tail.py:89",
)
DUAL_FROM_UPLINK = Kernel(
    "dual_from_uplink", "round_tail.cu", "launch_dual_from_uplink",
    # u xs rho m W dtype out dev stream
    [P, P, F, LL, I, I, P, I, P],
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
    m, w, code = _client_and_server(k.name, {"x_ref": x_ref, "lam_s": lam_s}, x_s)
    uplink = torch.empty_like(x_ref)
    lam_is = torch.empty_like(x_ref) if with_lam_is else None
    k.launch(_args.ptr(x_ref), _args.ptr(lam_s), _args.ptr(x_s), float(rho), m, w,
             code, _args.ptr(lam_is), _args.ptr(uplink), *_args.stream_args(x_ref.device))
    return lam_is, uplink


def dual_from_uplink(uplink, x_s, rho):
    """lam_s' = rho (u - x_s'), (m, W)."""
    k = DUAL_FROM_UPLINK
    if _args.on_cpu(k.name, uplink):
        return ref.dual_from_uplink_ref(uplink, x_s, rho)
    m, w, code = _client_and_server(k.name, {"uplink": uplink}, x_s)
    out = torch.empty_like(uplink)
    k.launch(_args.ptr(uplink), _args.ptr(x_s), float(rho), m, w, code,
             _args.ptr(out), *_args.stream_args(uplink.device))
    return out


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
