"""Plain PyTorch versions of the seventeen ported kernels and the server
step's passes.

Each upcasts to f32 and casts back at exactly the points where the
``"xla"`` branches of ``src/repro/kernels/ops.py`` do (lines 276-278,
291-313, 316-362, 380-386, 401-439, 458-465, 514-521, 546-615), so on the
CPU they agree with the reference bitwise wherever both sides run the same
f32 operations in the same order.  The wrappers in ``fused_update``,
``inner_loop``, ``round_tail``, ``gather``, ``screen``, ``stale_mix``,
``residual``, ``neighbor_reduce``, ``flash_attention`` and ``wkv6`` run these for CPU tensors
only; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
The two model kernels' plain versions follow ``_flash_xla`` (one key chunk)
and ``_wkv6_chunked_xla`` (``ops.py:56-123, 187-234``).

``step`` (and SCAFFOLD's ``alpha``) is a Python float or a tensor of
per-client values: ``(m,)``, or ``(m, 1, ...)`` as the per-leaf rounds
shape it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
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


def scaffold_step_ref(c_i, x_t, c_s, x_s, alpha, eta_g: float, mask=None):
    """SCAFFOLD's full-arena round tail and server step, the plain code of
    ``core/scaffold.py``: c_i' = ``scaffold_cv_ref`` (c_i kept where
    ``mask`` is false), x_s' = x_s + eta_g (mean x_up - x_s) with x_up the
    transmitted x_t (x_s where masked out), c' = c + mean (c_i' - c_i), and
    the f32 column sum of c_i' - c'.  Returns (c_i', x_s', c', colsum)."""
    c_i_new = scaffold_cv_ref(c_i, x_t, c_s, x_s, alpha)
    x_up = x_t
    if mask is not None:
        c_i_new = torch.where(mask[:, None], c_i_new, c_i)
        x_up = torch.where(mask[:, None], x_t, x_s[None])
    x_s_new = x_s + scalar_as(eta_g, x_s.dtype) * (torch.mean(x_up, dim=0) - x_s)
    c_new = c_s + torch.mean(c_i_new - c_i, dim=0)
    colsum = torch.sum((c_i_new - c_new[None]).to(torch.float32), dim=0)
    return c_i_new, x_s_new, c_new, colsum


def fused_update_arena_ref(x, g, x_s, lam, step, rho, *, acc=None, acc_mode="add",
                           acc_scale=1.0):
    """Eq. (20) step over the arena: x, g, lam (m, W); x_s (W,); the
    running sum ``acc`` updated in place (``accumulate_ref``)."""
    f32 = torch.float32
    out = eq20(x.to(f32), g.to(f32), x_s.to(f32)[None],
               None if lam is None else lam.to(f32), _per_client(step), rho).to(x.dtype)
    if acc is not None:
        accumulate_ref(acc, out, acc_mode, acc_scale)
    return out


@functools.lru_cache(maxsize=256)
def scalar_as(s: float, dtype) -> float:
    """A Python scalar as JAX's weak type meets a tensor of ``dtype``:
    rounded to it where it is narrower than f32 (``core.tree_util.weak``
    for the plain tensor code, the step kernel's 1/K on the host)."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(float(s), dtype=dtype).item()
    return float(s)


def accumulate_ref(acc, x, mode: str, scale: float) -> None:
    """The running sum x_bar's plain passes, in place: ``first`` acc = 0 +
    x, ``add`` acc = acc + x, ``last`` acc = (acc + x) * s, ``only`` acc =
    (0 + x) * s, with s = ``scale`` (1/K) as JAX's weak type meets acc's
    dtype -- the bits of ``xsum = zeros_like(x)``, ``xsum = xsum + x`` per
    step and ``xsum * (1/K)``."""
    if mode not in ("first", "add", "last", "only"):
        raise ValueError(f"acc_mode {mode!r}")
    s = (torch.zeros_like(x) if mode in ("first", "only") else acc) + x
    if mode in ("last", "only"):
        s = s * scalar_as(scale, s.dtype)
    acc.copy_(s)


def fused_update_leaves_ref(xs, gs, x_ss, lams, step, rho, *, accs=None, acc_mode="add",
                            acc_scale=1.0):
    """``fused_update_ref`` over lists of leaves, then the running sums of
    ``accs`` (if given) updated in place, leaf by leaf: the per-leaf step
    and the ``tree_add``/``tree_scale`` passes it replaces."""
    outs = [fused_update_ref(x, g, s, lam, step, rho)
            for x, g, s, lam in zip(xs, gs, x_ss, lams, strict=True)]
    if accs is not None:
        for acc, out in zip(accs, outs, strict=True):
            accumulate_ref(acc, out, acc_mode, acc_scale)
    return outs


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


def round_tail_mean_ref(x_ref, lam_s, x_s, rho, *, with_lam_is: bool = True):
    """``round_tail_ref``, then the client mean of the uplink:
    (lam_is, uplink, x_s')."""
    lam_is, uplink = round_tail_ref(x_ref, lam_s, x_s, rho, with_lam_is=with_lam_is)
    return lam_is, uplink, client_mean_ref(uplink)


def client_mean_ref(uplink):
    """x_s' = mean_i u_i, in the uplink's dtype."""
    return torch.mean(uplink, dim=0)


def server_dual_ref(uplink, x_s, rho):
    """(lam_s' = rho (u - x_s'), the f32 column sum of lam_s' as stored)."""
    lam = dual_from_uplink_ref(uplink, x_s, rho)
    return lam, torch.sum(lam.to(torch.float32), dim=0)


def server_step_ref(uplink, rho):
    """The server step: the client mean, the dual refresh and lam's column
    sum, (x_s', lam_s', colsum)."""
    x_s = client_mean_ref(uplink)
    return (x_s,) + server_dual_ref(uplink, x_s, rho)


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


def ef21_row_scales_ref(rowmax, leaf_rows, lo: float):
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


def ef21_update_ref(u, u_hat, bits: int, leaf_rows):
    """The EF21 uplink as the reference composes it: the row max, the
    per-(client, leaf) scales, the apply pass."""
    lo = float(2 ** (bits - 1) - 1)
    return ef21_apply_ref(u, u_hat, ef21_row_scales_ref(ef21_rowmax_ref(u, u_hat), leaf_rows, lo),
                          bits)


def row_gather_ref(arr, idx):
    """The cohort gather out[t] = arr[idx[t]]; ``index_select`` checks that
    every id is in range."""
    return torch.index_select(arr, 0, idx)


def row_scatter_ref_(dst, idx, rows):
    """The cohort scatter in place: dst[idx[t]] = rows[t]; ``index_copy_``
    (which takes int64 ids) checks that every id is in range.  Returns
    ``dst``."""
    return dst.index_copy_(0, idx.long(), rows)


def screen_uplink_ref(u, ref):
    """Per client row: every entry finite, and the f32 sum over the finite
    entries of (u - ref)^2.  ``ref`` is a (W,) row or (m, W) per row.
    Returns (finite (m,) bool, sq (m,) f32)."""
    f32 = torch.float32
    uf = u.to(f32)
    rf = ref.to(f32)
    if rf.ndim == 1:
        rf = rf[None]
    fin_e = torch.isfinite(uf)
    d = torch.where(fin_e, uf - rf, 0.0)
    return torch.all(fin_e, dim=1), torch.sum(d * d, dim=1)


def nanmedian_ref(x):
    """``jnp.nanmedian`` of a 1-D f32 tensor: the median of the non-NaN
    values, interpolated as jax's linear quantile does (for an even count
    low * 0.5 + high * 0.5 in f32; ``torch.nanmedian`` takes the lower
    middle value instead), NaN when every value is NaN.  Indexing by the
    0-dim rank tensors reads each rank on the host: on the card two
    synchronisations a call."""
    f32 = torch.float32
    xs = torch.sort(x).values  # NaNs sort last
    count = torch.sum(~torch.isnan(xs), dtype=f32)
    q = 0.5 * (count - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    top = count - 1.0
    lo_i = torch.clamp(torch.minimum(lo, top), min=0.0).to(torch.int64)
    hi_i = torch.clamp(torch.minimum(hi, top), min=0.0).to(torch.int64)
    return xs[lo_i] * lw + xs[hi_i] * hw


def keep_from_ref(finite, sq, screen_mult: float):
    """The screen's rule (``core.faults._keep_from``): keep = finite, and,
    with ``screen_mult`` > 0, sq at most ``screen_mult`` times the median sq
    over the rows that screened finite (in f32).  With no finite row the
    median is NaN and every row is already demoted."""
    keep = finite
    if screen_mult > 0.0:
        med = nanmedian_ref(torch.where(finite, sq, math.nan))
        bound = float(np.float32(screen_mult)) * torch.clamp(med, min=float(np.float32(1e-12)))
        keep = keep & (sq <= bound)
    return keep


def screen_keep_ref(u, ref, screen_mult: float):
    """The round's keep mask of the (m, W) uplink: ``screen_uplink_ref``,
    then ``keep_from_ref``."""
    return keep_from_ref(*screen_uplink_ref(u, ref), screen_mult)


def stale_mix_ref(uplink, cache, buf, fresh, store, w):
    """base = fresh ? uplink : cache; mixed = base + w (buf - base) in f32
    where w > 0, else base bitwise; buf' = store ? uplink : buf.  ``cache``
    (W,) or (m, W); fresh, store (m,) bool; w (m,) f32."""
    f32 = torch.float32
    cache2 = cache if cache.ndim == 2 else cache[None]
    base = torch.where(fresh[:, None], uplink, cache2)
    bf = base.to(f32)
    mixf = bf + w[:, None].to(f32) * (buf.to(f32) - bf)
    mixed = torch.where((w > 0)[:, None], mixf.to(base.dtype), base)
    return mixed, torch.where(store[:, None], uplink, buf)


def residual_norm_ref(x, x_prev):
    """Per row of the (m, W) state: ||x - x_prev||^2 and ||x||^2, in f32.
    Returns (dx2 (m,) f32, x2 (m,) f32)."""
    xf = x.to(torch.float32)
    d = xf - x_prev.to(torch.float32)
    return torch.sum(d * d, dim=1), torch.sum(xf * xf, dim=1)


def neighbor_reduce_ref(z, indptr, sgn, n: int):
    """The per-node signed dual sums s_i = sum_j A_ij z_{i|j} over node i's
    contiguous slots ``indptr[i]:indptr[i+1]`` (int64 tensors ``indptr``
    (n+1,) and ``sgn`` (2E,) on z's device), added in slot order from the
    node's first slot, in f32, and cast back once.  A node without a slot
    gets zeros.  Slot k of every node is added in one masked step, so the
    order of the additions is the kernel's, not that of an atomic
    scatter."""
    zf = z.to(torch.float32)
    signed = torch.where((sgn >= 0)[:, None], zf, -zf)
    lo, deg = indptr[:-1], indptr[1:] - indptr[:-1]
    out = torch.zeros((n, z.shape[1]), dtype=torch.float32, device=z.device)
    for k in range(int(deg.max())):
        rows = signed[torch.clamp(lo + k, max=signed.shape[0] - 1)]
        if k == 0:
            out = torch.where((deg > 0)[:, None], rows, out)
        else:
            out = torch.where((deg > k)[:, None], out + rows, out)
    return out.to(z.dtype)


def edge_flip_ref(z, x, c: float, rev, nbr, sgn, mask=None):
    """PDMM's directed dual exchange at the receiving slot t:
    z'[t] = z[rev[t]] - 2c sgn[t] x[nbr[t]] in f32, and z[t] where
    ``mask[t] == 0``; cast back once.  ``rev``, ``nbr``, ``sgn`` (2E,) int64
    and ``mask`` (2E,) tensors on z's device."""
    zf = z.to(torch.float32)
    flip = (zf[rev] - ((2.0 * c) * sgn.to(torch.float32))[:, None]
            * x.to(torch.float32)[nbr])
    if mask is not None:
        flip = torch.where((mask != 0)[:, None], flip, zf)
    return flip.to(z.dtype)


# ---------------------------------------------------------------------------
# the model kernels: attention and the RWKV-6 recurrence
# ---------------------------------------------------------------------------

NEG = -1e30  # the masked score of the reference's online softmax


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True, window=None):
    """Causal (optionally sliding-window) GQA attention, the online softmax
    of ``_flash_xla`` over one key chunk, in f32: scores q k^T / sqrt(hd),
    masked to -1e30 where k_pos > q_pos (causal), k_pos <= q_pos - window or
    k_pos < 0; p = exp(s - max s); out = (p v) / max(sum p, 1e-30), in q's
    dtype.  A row with no valid key averages v over its keys, as the
    reference's kernel and ``"xla"`` branch do.

    q (B, Sq, H, hd); k (B, Sk, Hkv, hd); v (B, Sk, Hkv, vd); q_pos (Sq,)
    and k_pos (Sk,) integer positions.  Query head h reads kv head
    h // (H / Hkv)."""
    B, Sq, H, hd = q.shape
    Hkv, vd = k.shape[2], v.shape[-1]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32)) * (1.0 / math.sqrt(hd))
    kp, qp = k_pos[None, :], q_pos[:, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    s = torch.where(valid, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhv->bhgqv", p, v.to(f32)) / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vd).to(q.dtype)


def wkv6_ref(r, k, v, w, u, s0, *, chunk: int = 64):
    """The RWKV-6 recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T, y_t =
    r_t^T (S_{t-1} + diag(u) k_t v_t^T), in the chunked form of
    ``_wkv6_chunked_xla`` (f32): per chunk of ``chunk`` steps (the last one
    may be shorter), with la = cumsum log max(w, 1e-38),

        y_t = (r_t exp(la_{t-1})) S_0
            + sum_{tau<t} [r_t . k_tau . exp(min(la_{t-1} - la_tau, 0))] v_tau
            + (r_t . u . k_t) v_t
        S  <- exp(la_C) S_0 + (k exp(la_C - la))^T v

    r, k, w (B, S, H, K); v (B, S, H, V); u (H, K); s0 (B, H, K, V).
    Returns y (B, S, H, V) in r's dtype and the final state (B, H, K, V)
    in f32.  Any S: the reference asserts S % min(chunk, S) == 0, and where
    it does the chunks are its own."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf = (a.to(f32) for a in (r, k, v))
    lw = torch.log(torch.clamp(w.to(f32), min=1e-38))
    uf = u.to(f32)
    s = s0.to(f32)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lwc = (a[:, c0:c0 + chunk] for a in (rf, kf, vf, lw))
        C = rc.shape[1]
        strict = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), diagonal=-1)
        la = torch.cumsum(lwc, dim=1)
        la_prev = la - lwc
        y_inter = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(la_prev), s)
        diff = la_prev[:, :, None] - la[:, None, :]  # (B, t, tau, H, K)
        dec = torch.exp(torch.clamp(diff, max=0.0))
        att = torch.einsum("bthk,bchk,btchk->bhtc", rc, kc, dec)
        att = torch.where(strict, att, 0.0)
        bonus = torch.einsum("bthk,bthk->bth", rc * uf[None, None], kc)
        ys.append(y_inter + torch.einsum("bhtc,bchv->bthv", att, vc) + bonus[..., None] * vc)
        la_end = la[:, -1:]
        s = (torch.exp(la_end[:, 0])[..., None] * s
             + torch.einsum("bchk,bchv->bhkv", kc * torch.exp(la_end - la), vc))
    return torch.cat(ys, dim=1).to(r.dtype), s
