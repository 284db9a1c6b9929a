"""Plain PyTorch versions of the seventeen ported kernels, the server
step's passes and the port's own ``lru_scan``, and the reference's naive
attention oracle (``attention_ref``).

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


def attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True, window=None):
    """Naive masked softmax attention, the reference's oracle
    (``src/repro/kernels/ref.py:16-40``): scores in f32 over sqrt(hd),
    masked to -inf, a fully masked row 0.

    q (B, Sq, H, hd); k (B, Sk, Hkv, hd); v (B, Sk, Hkv, vd); q_pos (Sq,);
    k_pos (Sk,), -1 an empty slot.  Query group g reads kv head g // (H /
    Hkv)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32)) / math.sqrt(hd)
    kp, qp = k_pos[None, :], q_pos[:, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    scores = torch.where(valid, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bhgqk,bkhv->bqhgv", probs, v.to(f32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def lru_ref(a, b, h0):
    """The linear recurrence h_t = a_t h_{t-1} + b_t, step by step in f32
    (``src/repro/kernels/ref.py:95-106``): a, b (B, S, D), h0 (B, D) ->
    (the states (B, S, D) in a's dtype, the last state (B, D) f32).  Each
    step is one product and one sum, each rounded, as the CUDA kernel
    rounds them."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    ys = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else af.new_zeros(af.shape)
    return y.to(a.dtype), h


def lru_bwd_ref(a, y, h0, dy, dh_last):
    """(da, db, dh0) of ``lru_ref`` from its states ``y`` and the incoming
    gradients ``dy`` (B, S, D) and ``dh_last`` (B, D), walking back in f32:
    g_t = dy_t + a_{t+1} g_{t+1} from g_{S-1} = dy_{S-1} + dh_last, da_t =
    g_t h_{t-1} (h_{-1} = h0), db_t = g_t, dh0 = a_0 g_0.  Each product and
    sum is rounded on its own, as autograd of ``lru_ref`` rounds them (bit
    for bit) and as the CUDA kernel does."""
    f32 = torch.float32
    af, yf, dyf = a.to(f32), y.to(f32), dy.to(f32)
    c = dh_last.to(f32)
    S = a.shape[1]
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in range(S - 1, -1, -1):
        g = dyf[:, t] + c
        da[:, t] = g * (yf[:, t - 1] if t else h0.to(f32))
        db[:, t] = g
        c = g * af[:, t]
    return da.to(a.dtype), db.to(a.dtype), c


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


def flash_attention_lse_ref(q, k, q_pos, k_pos, *, causal: bool = True, window=None):
    """Each query row's logsumexp of the scaled, masked scores (f32, masked
    to -1e30 as in ``flash_attention_ref``), (B, H, Sq): the forward's
    second output for the backward."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32)) * (1.0 / math.sqrt(hd))
    kp, qp = k_pos[None, :], q_pos[:, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    return torch.logsumexp(torch.where(valid, s, NEG), dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, do, q_pos, k_pos, *, causal: bool = True, window=None):
    """(dq, dk, dv) of ``flash_attention_ref`` for the incoming gradient
    ``do``: autograd of the plain forward (the backward kernel's plain
    version)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_ref(qq, kk, vv, q_pos, k_pos, causal=causal, window=window)
        return torch.autograd.grad(o, (qq, kk, vv), do)


def _flash_probs(q, k, lse, q_pos, k_pos, causal, window, qt=None, kt=None):
    """The grouped operands of the tangent refs, in f32: q (B, Sq, Hkv, G,
    hd), P = exp(q k^T / sqrt(hd) - lse) over the visible keys (0 elsewhere)
    (B, Hkv, G, Sq, Sk) and, given the tangents q', k', the scores' tangent
    S' = (q' k^T + q k'^T) / sqrt(hd)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    qf, kf = q.to(f32).reshape(B, Sq, Hkv, H // Hkv, hd), k.to(f32)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    kp, qp = k_pos[None, :], q_pos[:, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    lse_g = lse.to(f32).reshape(B, Hkv, H // Hkv, Sq)[..., None]
    p = torch.where(valid, torch.exp(s - lse_g), 0.0)
    if qt is None:
        return qf, p, None
    qtf = qt.to(f32).reshape(B, Sq, Hkv, H // Hkv, hd)
    st = (torch.einsum("bqhgd,bkhd->bhgqk", qtf, kf)
          + torch.einsum("bqhgd,bkhd->bhgqk", qf, kt.to(f32))) * scale
    return qf, p, st


def _heads_out(x, dtype):
    """(B, Hkv, G, Sq, d) -> (B, Sq, H, d) in ``dtype``."""
    B, Hkv, G, Sq, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G, d).to(dtype)


def flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, q_pos, k_pos, *, causal: bool = True,
                            window=None):
    """The tangent of ``flash_attention`` (kernel 16j's plain version): from
    the primals q, k, v, the forward's row logsumexp ``lse`` (B, H, Sq) and
    the tangents q', k', v', in f32 with P = exp(S - lse) over the visible
    keys (0 elsewhere) and S' = (q' k^T + q k'^T) / sqrt(hd):

        lse' = sum_j P_j S'_j,    o' = sum_j P_j (S'_j v_j + v'_j) - lse' o

    with o = sum_j P_j v_j.  Returns (o' (B, Sq, H, vd) in q's dtype, lse'
    (B, H, Sq) f32).  Equal to ``torch.func.jvp`` of ``flash_attention_ref``
    up to rounding (tests/test_torch_jvp.py)."""
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    _, p, st = _flash_probs(q, k, lse, q_pos, k_pos, causal, window, qt, kt)
    vf, vtf = v.to(f32), vt.to(f32)
    lse_t = torch.sum(p * st, dim=-1)
    o = torch.einsum("bhgqk,bkhv->bhgqv", p, vf)
    o_t = (torch.einsum("bhgqk,bkhv->bhgqv", p * st, vf)
           + torch.einsum("bhgqk,bkhv->bhgqv", p, vtf) - lse_t[..., None] * o)
    return _heads_out(o_t, q.dtype), lse_t.reshape(B, H, Sq)


def flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_pos, k_pos, *,
                                causal: bool = True, window=None):
    """The tangent of ``flash_attention_bwd`` (kernel 16bj's plain version):
    of (dq, dk, dv) as 16b forms them from q, k, v, o, lse and do, for the
    tangents q', k', v', o', do'.  lse' is formed here (lse' = sum P S',
    ``flash_attention_jvp_ref``), not read: the Function marks lse
    non-differentiable, so no tangent of it arrives.  With D = rowsum(do o),
    dP = do v^T, dS = P (dP - D), in f32:

        P'  = P (S' - lse'),        dP' = do' v^T + do v'^T
        D'  = rowsum(do' o + do o'),  dS' = P' (dP - D) + P (dP' - D')
        dq' = (dS' k + dS k') / sqrt(hd)
        dk' = (dS'^T q + dS^T q') / sqrt(hd),  dv' = P'^T do + P^T do'

    dk' and dv' summed over each kv head's query heads.  Returns (dq', dk',
    dv') in q's dtype.  Equal to ``torch.func.jvp`` of
    ``flash_attention_bwd_ref`` up to rounding (tests/test_torch_jvp.py)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qf, p, st = _flash_probs(q, k, lse, q_pos, k_pos, causal, window, qt, kt)
    qtf = qt.to(f32).reshape(B, Sq, Hkv, G, hd)
    kf, vf, ktf, vtf = (t.to(f32) for t in (k, v, kt, vt))
    of, dof, otf, dotf = (t.to(f32).reshape(B, Sq, Hkv, G, t.shape[-1])
                          for t in (o, do, ot, dot))
    lse_t = torch.sum(p * st, dim=-1, keepdim=True)
    p_t = p * (st - lse_t)
    dp = torch.einsum("bqhgv,bkhv->bhgqk", dof, vf)
    dp_t = (torch.einsum("bqhgv,bkhv->bhgqk", dotf, vf)
            + torch.einsum("bqhgv,bkhv->bhgqk", dof, vtf))
    D = torch.einsum("bqhgv,bqhgv->bhgq", dof, of)[..., None]
    D_t = (torch.einsum("bqhgv,bqhgv->bhgq", dotf, of)
           + torch.einsum("bqhgv,bqhgv->bhgq", dof, otf))[..., None]
    ds = p * (dp - D)
    ds_t = p_t * (dp - D) + p * (dp_t - D_t)
    dq_t = (torch.einsum("bhgqk,bkhd->bhgqd", ds_t, kf)
            + torch.einsum("bhgqk,bkhd->bhgqd", ds, ktf)) * scale
    dk_t = (torch.einsum("bhgqk,bqhgd->bkhd", ds_t, qf)
            + torch.einsum("bhgqk,bqhgd->bkhd", ds, qtf)) * scale
    dv_t = (torch.einsum("bhgqk,bqhgv->bkhv", p_t, dof)
            + torch.einsum("bhgqk,bqhgv->bkhv", p, dotf))
    return _heads_out(dq_t, q.dtype), dk_t.to(q.dtype), dv_t.to(q.dtype)


def lru_jvp_ref(a, y, h0, at, bt, h0t):
    """The tangent of ``lru_ref`` (``lru_scan_jvp``'s plain version): from
    a, the states y and h0 and the tangents a', b', h0', in f32,
    h'_t = a_t h'_{t-1} + a'_t h_{t-1} + b'_t (h_{-1} = h0), each product
    and sum rounded on its own in the order of torch's forward-mode rules
    for ``a * h + b`` ((h' a + a' h) + b'), so it equals ``torch.func.jvp``
    of ``lru_ref`` bit for bit.  Returns (y' (B, S, D), h_last' (B, D))."""
    f32 = torch.float32
    af, yf, atf, btf = (t.to(f32) for t in (a, y, at, bt))
    ht = h0t.to(f32)
    ys = []
    for t in range(a.shape[1]):
        hp = yf[:, t - 1] if t else h0.to(f32)
        ht = (ht * af[:, t] + atf[:, t] * hp) + btf[:, t]
        ys.append(ht)
    y_t = torch.stack(ys, dim=1) if ys else atf.new_zeros(atf.shape)
    return y_t.to(a.dtype), ht


def lru_bwd_jvp_ref(a, y, h0, dy, dh_last, at, yt, h0t, dyt, dh_last_t):
    """The tangent of ``lru_bwd_ref`` (``lru_scan_bwd_jvp``'s plain version)
    for the tangents of its inputs, walking back in f32 with the primal
    carry beside the tangent's: g_t = dy_t + c_t, g'_t = dy'_t + c'_t,
    da'_t = h'_{t-1} g_t + g'_t h_{t-1} (h_{-1} = h0, h'_{-1} = h0'), db'_t
    = g'_t, c_{t-1} = g_t a_t, c'_{t-1} = a'_t g_t + g'_t a_t, from c =
    dh_last; dh0' = c'_{-1}.  Each product and sum rounded on its own in the
    order of torch's forward-mode rules, so it equals ``torch.func.jvp`` of
    ``lru_bwd_ref`` bit for bit.  Returns (da', db', dh0')."""
    f32 = torch.float32
    af, yf, dyf, atf, ytf, dytf = (t.to(f32) for t in (a, y, dy, at, yt, dyt))
    c, ct = dh_last.to(f32), dh_last_t.to(f32)
    da_t, db_t = torch.empty_like(af), torch.empty_like(af)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dyf[:, t] + c
        g_t = dytf[:, t] + ct
        hp = yf[:, t - 1] if t else h0.to(f32)
        hp_t = ytf[:, t - 1] if t else h0t.to(f32)
        da_t[:, t] = hp_t * g + g_t * hp
        db_t[:, t] = g_t
        ct = atf[:, t] * g + g_t * af[:, t]
        c = g * af[:, t]
    return da_t.to(a.dtype), db_t.to(a.dtype), ct


def wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds_final=None, *, chunk: int = 64):
    """(dr, dk, dv, dw, du, ds0) of ``wkv6_ref`` for the incoming gradients
    ``dy`` and ``ds_final`` (None: zero): autograd of the plain forward (the
    backward kernel's plain version)."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True) for t in (r, k, v, w, u, s0))
        y, s = wkv6_ref(*ins, chunk=chunk)
        outs, grads = (y,), (dy,)
        if ds_final is not None:
            outs, grads = (y, s), (dy, ds_final)
        return torch.autograd.grad(outs, ins, grads, allow_unused=True)


def _wkv6_u_rows(u, B: int):
    """u (H, K) or (n, H, K) in f32 as it meets the batch rows: (1, 1, H, K)
    or one row a batch row (B, 1, H, K)."""
    u = u.to(torch.float32)
    return u[None, None] if u.ndim == 2 else u.repeat_interleave(B // u.shape[0], dim=0)[:, None]


def _wkv6_operands(r, k, v, w, u, rt, kt, vt, wt, ut):
    """The f32 operands of the tangent refs: r, k, v and their tangents, lw
    = log max(w, 1e-38) and lw' = w' / w where w >= 1e-38 (0 elsewhere, the
    clamp's), u and u' as they meet the batch rows (``_wkv6_u_rows``)."""
    B = r.shape[0]
    f32 = torch.float32
    rf, kf, vf, rtf, ktf, vtf = (a.to(f32) for a in (r, k, v, rt, kt, vt))
    wf = w.to(f32)
    lw = torch.log(torch.clamp(wf, min=1e-38))
    lwt = torch.where(wf >= 1e-38, wt.to(f32) / wf, 0.0)
    return rf, kf, vf, rtf, ktf, vtf, lw, lwt, _wkv6_u_rows(u, B), _wkv6_u_rows(ut, B)


def _wkv6_chunk_decays(lwc, lwtc):
    """Within a chunk: la = cumsum lw, la_prev = la - lw, their tangents, the
    pairwise decay E[t, tau] = exp(min(la_prev_t - la_tau, 0)) (B, t, tau, H,
    K) and its tangent E (la'_prev_t - la'_tau) where the clamp passes."""
    la, lat = torch.cumsum(lwc, dim=1), torch.cumsum(lwtc, dim=1)
    lp, lpt = la - lwc, lat - lwtc
    diff = lp[:, :, None] - la[:, None, :]
    dec = torch.exp(torch.clamp(diff, max=0.0))
    dect = torch.where(diff <= 0.0, lpt[:, :, None] - lat[:, None, :], 0.0) * dec
    return la, lat, lp, lpt, dec, dect


def _wkv6_next_state(s, st, kc, ktc, vc, vtc, la, lat):
    """The state leaving a chunk and its tangent, from those entering it and
    the chunk's la, la' (cumsums down the chunk): S <- exp(la_C) S + (k
    exp(la_C - la))^T v, and the line's tangent."""
    ec = torch.exp(la[:, -1:] - la)
    e_end = torch.exp(la[:, -1])[..., None]
    kd, kdt = kc * ec, (ktc + kc * (lat[:, -1:] - lat)) * ec
    st = (e_end * (st + lat[:, -1][..., None] * s)
          + torch.einsum("bchk,bchv->bhkv", kdt, vc) + torch.einsum("bchk,bchv->bhkv", kd, vtc))
    return e_end * s + torch.einsum("bchk,bchv->bhkv", kd, vc), st


def wkv6_jvp_ref(r, k, v, w, u, s0, rt, kt, vt, wt, ut, s0t, *, chunk: int = 64):
    """The tangent of ``wkv6_ref`` (kernel 17j's plain version): from the
    primals and the tangents r', k', v', w', u', s0', the chunk form with
    the tangent carried through each line (la' = cumsum lw', lw' = w' / w
    where w >= 1e-38, else 0; ' marks a tangent):

        y'_t = ((r'_t + r_t la'_prev_t) exp(la_prev_t)) S + (r_t exp(la_prev_t)) S'
             + sum_{tau<t} (att'_{t,tau} v_tau + att_{t,tau} v'_tau) + bonus'_t v_t + bonus_t v'_t
        att'_{t,tau} = sum_k (r'_tk k_tau,k + r_tk k'_tau,k
                              + r_tk k_tau,k (la'_prev_tk - la'_tau,k)) E_{t,tau,k}
        bonus'_t = sum_k r'_tk u_k k_tk + r_tk u'_k k_tk + r_tk u_k k'_tk
        S'  <- exp(la_C) (S' + la'_C S) + sum_tau [(k'_tau + k_tau (la'_C - la'_tau))
                                                   exp(la_C - la_tau)]^T v_tau
                                                + (k_tau exp(la_C - la_tau))^T v'_tau

    with E, att, bonus and S the forward's (``wkv6_ref``).  u' has u's
    shape.  Returns (y' (B, S, H, V) in r's dtype, S_final' (B, H, K, V)
    f32); equal to ``torch.func.jvp`` of ``wkv6_ref`` up to rounding
    (tests/test_torch_jvp.py)."""
    C_ = chunk
    B, S, H, K = r.shape
    f32 = torch.float32
    rf, kf, vf, rtf, ktf, vtf, lw, lwt, uf, utf = _wkv6_operands(r, k, v, w, u, rt, kt, vt, wt, ut)
    s, st = s0.to(f32), s0t.to(f32)
    ys = []
    for c0 in range(0, S, C_):
        sl = slice(c0, c0 + C_)
        rc, kc, vc, rtc, ktc, vtc = (a[:, sl] for a in (rf, kf, vf, rtf, ktf, vtf))
        C = rc.shape[1]
        strict = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), diagonal=-1)
        la, lat, lp, lpt, dec, dect = _wkv6_chunk_decays(lw[:, sl], lwt[:, sl])
        ep = torch.exp(lp)
        y_t = (torch.einsum("bchk,bhkv->bchv", (rtc + rc * lpt) * ep, s)
               + torch.einsum("bchk,bhkv->bchv", rc * ep, st))
        att = torch.where(strict, torch.einsum("bthk,bchk,btchk->bhtc", rc, kc, dec), 0.0)
        att_t = torch.where(strict, torch.einsum("bthk,bchk,btchk->bhtc", rtc, kc, dec)
                            + torch.einsum("bthk,bchk,btchk->bhtc", rc, ktc, dec)
                            + torch.einsum("bthk,bchk,btchk->bhtc", rc, kc, dect), 0.0)
        bonus = torch.einsum("bthk,bthk->bth", rc * uf, kc)
        bonus_t = (torch.einsum("bthk,bthk->bth", rtc * uf, kc)
                   + torch.einsum("bthk,bthk->bth", rc * utf, kc)
                   + torch.einsum("bthk,bthk->bth", rc * uf, ktc))
        ys.append(y_t + torch.einsum("bhtc,bchv->bthv", att_t, vc)
                  + torch.einsum("bhtc,bchv->bthv", att, vtc)
                  + bonus_t[..., None] * vc + bonus[..., None] * vtc)
        s, st = _wkv6_next_state(s, st, kc, ktc, vc, vtc, la, lat)
    y_t = torch.cat(ys, dim=1) if ys else vf.new_zeros(vf.shape)
    return y_t.to(r.dtype), st


def _u_rows_sum(x, u):
    """(B, H, K) per batch row -> u's shape: each row of u summed over the
    batch rows that read it."""
    if u.ndim == 2:
        return x.sum(0)
    n = u.shape[0]
    return x.reshape(n, x.shape[0] // n, *x.shape[1:]).sum(1)


def wkv6_bwd_jvp_ref(r, k, v, w, u, s0, dy, ds_final, rt, kt, vt, wt, ut, s0t, dyt,
                     ds_final_t=None, *, chunk: int = 64):
    """The tangent of ``wkv6_bwd_ref`` (kernel 17bj's plain version): (dr',
    dk', dv', dw', du', ds0') for the tangents r', k', v', w', u', s0', dy',
    ds_final' (None: zero, as ds_final None is).  The backward in the chunk
    form, each line with its tangent beside it.  A forward pass keeps the
    state entering each chunk, S, and its tangent S' (``wkv6_jvp_ref``'s
    recurrence); then the chunks in reverse carry the pair (dS, dS'), the
    gradient at the state leaving the chunk, from (ds_final, ds_final'):

        g_t = dy_t . v_t, b_t = r_t . u . k_t, datt[t, tau] = dy_t . v_tau (tau < t)
        X_t = exp(la_prev_t) (S dy_t) + sum_{tau<t} datt[t, tau] k_tau E     dr = X + g u k
        Y_tau = exp(la_C - la_tau) (dS v_tau) + sum_{t>tau} datt[t, tau] r_t E  dk = Y + g u r
        dv_tau = sum_{t>tau} att[t, tau] dy_t + b_tau dy_tau + dS^T (k_tau exp(la_C - la_tau))
        du = sum_t g_t r_t k_t
        dla_prev = r X, dla = -k Y, plus sum_v dS S_C at la_C (the chunk's last row);
        dlw_s = sum_{t>=s} (dla_t + dla_prev_t) - dla_prev_s;  dw = dlw / w (w >= 1e-38)
        dS <- exp(la_C) dS + sum_t (r_t exp(la_prev_t))^T dy_t

    and the tangent of each (E' = E (la'_prev_t - la'_tau) where the clamp
    passes; dw' = (dlw' - dlw w' / w) / w).  Returns dr', dk', dv' in r's
    dtype, dw' and du' f32 (du' in u's shape) and ds0' f32; equal to
    ``torch.func.jvp`` of ``wkv6_bwd_ref`` up to rounding
    (tests/test_torch_jvp.py)."""
    C_ = chunk
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf, rtf, ktf, vtf, lw, lwt, uf, utf = _wkv6_operands(r, k, v, w, u, rt, kt, vt, wt, ut)
    dyf, dytf = dy.to(f32), dyt.to(f32)
    wf = w.to(f32)
    # the forward: the state entering each chunk and its tangent
    starts = list(range(0, S, C_))
    s, st = s0.to(f32), s0t.to(f32)
    states = []
    for c0 in starts:
        sl = slice(c0, c0 + C_)
        states.append((s, st))
        s, st = _wkv6_next_state(s, st, kf[:, sl], ktf[:, sl], vf[:, sl], vtf[:, sl],
                                 torch.cumsum(lw[:, sl], dim=1), torch.cumsum(lwt[:, sl], dim=1))
    zeros = torch.zeros(B, H, K, V, dtype=f32, device=r.device)
    ds = zeros if ds_final is None else ds_final.to(f32)
    dst = zeros if ds_final_t is None else ds_final_t.to(f32)
    s_end, st_end = s, st
    outs = {n: [] for n in ("dr", "dk", "dv", "dw")}
    du_t = torch.zeros(B, H, K, dtype=f32, device=r.device)
    for i in range(len(starts) - 1, -1, -1):
        sl = slice(starts[i], starts[i] + C_)
        s_in, st_in = states[i]
        s_c, st_c = (states[i + 1] if i + 1 < len(starts) else (s_end, st_end))
        rc, kc, vc, rtc, ktc, vtc, dyc, dytc = (
            a[:, sl] for a in (rf, kf, vf, rtf, ktf, vtf, dyf, dytf))
        C = rc.shape[1]
        strict = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), diagonal=-1)
        la, lat, lp, lpt, dec, dect = _wkv6_chunk_decays(lw[:, sl], lwt[:, sl])
        g = torch.einsum("bthv,bthv->bth", dyc, vc)[..., None]
        gt = (torch.einsum("bthv,bthv->bth", dytc, vc)
              + torch.einsum("bthv,bthv->bth", dyc, vtc))[..., None]
        b_ = torch.einsum("bthk,bthk->bth", rc * uf, kc)
        bt = (torch.einsum("bthk,bthk->bth", rtc * uf, kc)
              + torch.einsum("bthk,bthk->bth", rc * utf, kc)
              + torch.einsum("bthk,bthk->bth", rc * uf, ktc))
        att = torch.where(strict, torch.einsum("bthk,bchk,btchk->bhtc", rc, kc, dec), 0.0)
        att_t = torch.where(strict, torch.einsum("bthk,bchk,btchk->bhtc", rtc, kc, dec)
                            + torch.einsum("bthk,bchk,btchk->bhtc", rc, ktc, dec)
                            + torch.einsum("bthk,bchk,btchk->bhtc", rc, kc, dect), 0.0)
        datt = torch.where(strict, torch.einsum("bthv,bchv->bhtc", dyc, vc), 0.0)
        datt_t = torch.where(strict, torch.einsum("bthv,bchv->bhtc", dytc, vc)
                             + torch.einsum("bthv,bchv->bhtc", dyc, vtc), 0.0)
        ep = torch.exp(lp)
        ept = lpt * ep
        la_c, lat_c = la[:, -1:], lat[:, -1:]
        ec = torch.exp(la_c - la)
        ect = (lat_c - lat) * ec
        # dr: X = ep (S dy) + pairs
        A = torch.einsum("bhkv,bthv->bthk", s_in, dyc)
        At = (torch.einsum("bhkv,bthv->bthk", st_in, dyc)
              + torch.einsum("bhkv,bthv->bthk", s_in, dytc))
        X = ep * A + torch.einsum("bhtc,bchk,btchk->bthk", datt, kc, dec)
        Xt = (ept * A + ep * At + torch.einsum("bhtc,bchk,btchk->bthk", datt_t, kc, dec)
              + torch.einsum("bhtc,bchk,btchk->bthk", datt, ktc, dec)
              + torch.einsum("bhtc,bchk,btchk->bthk", datt, kc, dect))
        outs["dr"].append(Xt + gt * uf * kc + g * utf * kc + g * uf * ktc)
        # dk: Y = ec (dS v) + pairs
        Bm = torch.einsum("bhkv,bchv->bchk", ds, vc)
        Bmt = torch.einsum("bhkv,bchv->bchk", dst, vc) + torch.einsum("bhkv,bchv->bchk", ds, vtc)
        Y = ec * Bm + torch.einsum("bhtc,bthk,btchk->bchk", datt, rc, dec)
        Yt = (ect * Bm + ec * Bmt + torch.einsum("bhtc,bthk,btchk->bchk", datt_t, rc, dec)
              + torch.einsum("bhtc,bthk,btchk->bchk", datt, rtc, dec)
              + torch.einsum("bhtc,bthk,btchk->bchk", datt, rc, dect))
        outs["dk"].append(Yt + gt * uf * rc + g * utf * rc + g * uf * rtc)
        # dv
        kd, kdt = kc * ec, ktc * ec + kc * ect
        dvt = (torch.einsum("bhtc,bthv->bchv", att_t, dyc) + torch.einsum("bhtc,bthv->bchv", att, dytc)
               + bt[..., None] * dyc + b_[..., None] * dytc
               + torch.einsum("bhkv,bchk->bchv", dst, kd) + torch.einsum("bhkv,bchk->bchv", ds, kdt))
        outs["dv"].append(dvt)
        # du
        du_t = du_t + (gt * rc * kc + g * rtc * kc + g * rc * ktc).sum(1)
        # dw: the gradients at la_prev and la, la_C's on the last row
        dlp, dlpt = rc * X, rtc * X + rc * Xt
        dla, dlat = -kc * Y, -(ktc * Y + kc * Yt)
        dlc = (ds * s_c).sum(-1)
        dlct = (dst * s_c + ds * st_c).sum(-1)
        dla = torch.cat([dla[:, :-1], dla[:, -1:] + dlc[:, None]], dim=1)
        dlat = torch.cat([dlat[:, :-1], dlat[:, -1:] + dlct[:, None]], dim=1)
        dlw = torch.flip(torch.cumsum(torch.flip(dla + dlp, [1]), 1), [1]) - dlp
        dlwt = torch.flip(torch.cumsum(torch.flip(dlat + dlpt, [1]), 1), [1]) - dlpt
        wc, lwtc = wf[:, sl], lwt[:, sl]
        outs["dw"].append(torch.where(wc >= 1e-38, (dlwt - dlw * lwtc) / wc, 0.0))
        # the state gradient entering the chunk, and its tangent
        e_c = torch.exp(la_c[:, 0])[..., None]
        rd, rdt = rc * ep, rtc * ep + rc * ept
        dst = (e_c * (dst + lat_c[:, 0][..., None] * ds)
               + torch.einsum("bthk,bthv->bhkv", rdt, dyc) + torch.einsum("bthk,bthv->bhkv", rd, dytc))
        ds = e_c * ds + torch.einsum("bthk,bthv->bhkv", rd, dyc)

    def cat(name, like):
        parts = outs[name][::-1]
        return torch.cat(parts, dim=1) if parts else torch.zeros(like.shape, dtype=f32,
                                                                  device=like.device)
    return (cat("dr", r).to(r.dtype), cat("dk", k).to(k.dtype), cat("dv", v).to(v.dtype),
            cat("dw", w), _u_rows_sum(du_t, u), dst)


def wkv6_ref(r, k, v, w, u, s0, *, chunk: int = 64):
    """The RWKV-6 recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T, y_t =
    r_t^T (S_{t-1} + diag(u) k_t v_t^T), in the chunked form of
    ``_wkv6_chunked_xla`` (f32): per chunk of ``chunk`` steps (the last one
    may be shorter), with la = cumsum log max(w, 1e-38),

        y_t = (r_t exp(la_{t-1})) S_0
            + sum_{tau<t} [r_t . k_tau . exp(min(la_{t-1} - la_tau, 0))] v_tau
            + (r_t . u . k_t) v_t
        S  <- exp(la_C) S_0 + (k exp(la_C - la))^T v

    r, k, w (B, S, H, K); v (B, S, H, V); u (H, K), or (n, H, K) with row i
    for batch rows i B / n .. (i + 1) B / n - 1 (one u a client under the
    rounds' vmap, folded into the batch); s0 (B, H, K, V).
    Returns y (B, S, H, V) in r's dtype and the final state (B, H, K, V)
    in f32.  Any S: the reference asserts S % min(chunk, S) == 0, and where
    it does the chunks are its own."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    rf, kf, vf = (a.to(f32) for a in (r, k, v))
    lw = torch.log(torch.clamp(w.to(f32), min=1e-38))
    uf = _wkv6_u_rows(u, B)
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
        bonus = torch.einsum("bthk,bthk->bth", rc * uf, kc)
        ys.append(y_inter + torch.einsum("bhtc,bchv->bthv", att, vc) + bonus[..., None] * vc)
        la_end = la[:, -1:]
        s = (torch.exp(la_end[:, 0])[..., None] * s
             + torch.einsum("bchk,bchv->bhkv", kc * torch.exp(la_end - la), vc))
    return torch.cat(ys, dim=1).to(r.dtype), s
