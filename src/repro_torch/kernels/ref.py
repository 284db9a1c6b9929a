"""Plain PyTorch versions of the ten ported kernels.

Each upcasts to f32 and casts back at exactly the points where the
``"xla"`` branches of ``src/repro/kernels/ops.py`` do (lines 276-278,
291-313, 316-362, 380-386, 401-439, 546-615), so on the CPU they agree with the
reference bitwise wherever both sides run the same f32 operations in the
same order.  The wrappers in ``fused_update``, ``inner_loop`` and
``round_tail``, ``gather`` run these for CPU tensors only; ``chip_smoke.py`` holds each
CUDA kernel against them on the card.

``step`` (and SCAFFOLD's ``alpha``) is a Python float or a tensor of
per-client values: ``(m,)``, or ``(m, 1, ...)`` as the per-leaf rounds
shape it.
"""
from __future__ import annotations

import torch

LANES = 128  # the arena's lane width (``fused_update.LANES``)


def eq20(x, g, xs, lam, step, rho: float):
    """x - step * (g + rho * (x - xs) + lam) on f32 tensors, in the
    reference's operation order (``src/repro/kernels/fused_update.py:46``);
    ``lam=None`` drops the dual term.  ``step`` is a Python float or a
    tensor broadcastable against ``x``."""
    acc = g + rho * (x - xs)
    if lam is not None:
        acc = acc + lam
    return x - step * acc


def _per_client(step, ndim: int = 2):
    """A per-client step as ``(m, 1, ...)`` against an ``ndim`` operand."""
    if torch.is_tensor(step) and step.ndim > 0:
        return step.reshape((-1,) + (1,) * (ndim - 1))
    return step


def fused_update_ref(x, g, xs, lam, step, rho):
    """Eq. (20) step over one leaf of any shape: x, g, lam of one shape;
    ``xs`` of that shape or without the client dim (broadcast); ``lam`` may
    be None."""
    f32 = torch.float32
    out = eq20(x.to(f32), g.to(f32), xs.to(f32), None if lam is None else lam.to(f32),
               _per_client(step, x.ndim), rho)
    return out.to(x.dtype)


def scaffold_cv_ref(c_i, x_K, c_s, x_s, alpha):
    """SCAFFOLD's eq. (30): c_i' = (c_i - c) + alpha (x_s - x_K); c_i, x_K
    (m, W); c_s, x_s (W,) rows."""
    f32 = torch.float32
    out = (c_i.to(f32) - c_s.to(f32)[None]
           + _per_client(alpha) * (x_s.to(f32)[None] - x_K.to(f32)))
    return out.to(c_i.dtype)


def fused_update_arena_ref(x, g, x_s, lam, step, rho):
    """Eq. (20) step over the arena: x, g, lam (m, W); x_s (W,)."""
    f32 = torch.float32
    out = eq20(x.to(f32), g.to(f32), x_s.to(f32)[None],
               None if lam is None else lam.to(f32), _per_client(step), rho)
    return out.to(x.dtype)


def inner_loop_affine_ref(x0, H, c, x_s, lam, step, rho, K: int, *, off=None):
    """K eq. (20) steps with g = H x - (c + off); returns (x_K, mean_k x_k)."""
    f32 = torch.float32
    step_b = _per_client(step)
    xs = x_s.to(f32)[None]
    lam_f = None if lam is None else lam.to(f32)
    Hf, cf = H.to(f32), c.to(f32)
    if off is not None:
        cf = cf + off.to(f32)
    x = x0.to(f32)
    xsum = torch.zeros_like(x)
    for _ in range(K):
        g = torch.einsum("mij,mj->mi", Hf, x) - cf
        x = eq20(x, g, xs, lam_f, step_b, rho)
        xsum = xsum + x
    return x.to(x0.dtype), (xsum * (1.0 / K)).to(x0.dtype)


def round_tail_ref(x_ref, lam_s, x_s, rho, *, with_lam_is: bool = True):
    """lam_is = rho (x_s - x_ref) - lam_s;  uplink = x_ref - lam_is / rho."""
    f32 = torch.float32
    xr = x_ref.to(f32)
    lam_is = rho * (x_s.to(f32)[None] - xr) - lam_s.to(f32)
    uplink = (xr - lam_is / rho).to(x_ref.dtype)
    return (lam_is.to(x_ref.dtype) if with_lam_is else None), uplink


def dual_from_uplink_ref(uplink, x_s, rho):
    """lam_s' = rho (u - x_s')."""
    f32 = torch.float32
    return (rho * (uplink.to(f32) - x_s.to(f32)[None])).to(uplink.dtype)


def ef21_rowmax_ref(u, u_hat):
    """max |u - u_hat| over each client's 128-lane rows: (m, W / 128) f32.
    ``torch.amax`` propagates a NaN, as ``jnp.max`` does."""
    m, w = u.shape
    d = u.to(torch.float32) - u_hat.to(torch.float32)
    return torch.amax(torch.abs(d.reshape(m, w // LANES, LANES)), dim=-1)


def ef21_apply_ref(u, u_hat, row_scales, bits: int):
    """The integrated EF21 server view u_hat + clip(round((u - u_hat) / s),
    +-lo) s with lo = 2^(bits-1) - 1 and s the (m, W / 128) f32 per-row
    scale; ``torch.round`` rounds half to even, as ``jnp.round``."""
    f32 = torch.float32
    lo = float(2 ** (bits - 1) - 1)
    m, w = u.shape
    rows = w // LANES
    d = (u.to(f32) - u_hat.to(f32)).reshape(m, rows, LANES)
    s = row_scales[..., None]
    q = torch.clamp(torch.round(d / s), -lo, lo)
    out = u_hat.to(f32).reshape(m, rows, LANES) + q * s
    return out.reshape(m, w).to(u.dtype)


def row_gather_ref(arr, idx):
    """The cohort gather out[t] = arr[idx[t]]; ``index_select`` checks that
    every id is in range."""
    return torch.index_select(arr, 0, idx)


def row_scatter_ref(dst, pos, mask, rows):
    """The cohort scatter as a gather over the population: out[i] =
    rows[pos[i]] where mask[i] != 0, else dst[i]."""
    return torch.where((mask != 0)[:, None], torch.index_select(rows, 0, pos), dst)
