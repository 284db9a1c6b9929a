"""The arithmetic of the redesigned kernels, modelled in plain PyTorch on
the CPU and held against the plain versions (``kernels/ref.py``), so that a
wrong decomposition shows before any kernel runs on a card:

* kernel 1, ``inner_loop_affine``'s resident route
  (``csrc/inner_loop.cu``): C blocks per client, each owning W / C rows of
  H and the x sum of those rows, with its own two copies of x that every
  block writes its new rows into; each row's dot product on one warp
  (float4 partial sums per lane, then a shuffle tree) -- within the
  kernel's 1e-4 of the plain version, and the same bits whatever C, so the
  streaming route (one block holding every row) gives the same g; and the
  resident route's shuffle tree, which halves the rows a lane holds at each
  of its first levels, leaves on each lane the butterfly's sum bit for bit;

* kernel 16, ``flash_attention``'s tensor-core route
  (``csrc/flash_attention.cu``, ``tc``): blocks of 128 query rows, each
  warpgroup's 64 rows walking 128-key tiles from the block's first visible
  tile to its causal limit and skipping tiles wholly masked for its rows,
  scores in log2 units, p rounded to bf16 before p v while l sums the
  unrounded p, f32 accumulators -- within 2^-7 of the largest output, the
  tolerance of the kernel against its plain version on the card;
* kernel 17, ``wkv6`` (``csrc/wkv6.cu``): each chunk's own contribution
  to the state at its 16-step pivots, the state passed from chunk to chunk,
  and the outputs by sub-chunks that take direct pairwise exps only on the
  16 x 17 blocks at the diagonal -- in f32 within 1e-5 of the largest
  value, y and the final state.

* kernels 4 and 6, the eq. (20) step over a table of segments
  (``csrc/fused_update.cu``): the host's constants against the kernel's,
  the blocks of each segment, the chunks at the parameter limit and the
  grouping by dtype, and the kernel's walk over the table (a block's
  segment by binary search, its groups strided) stepping every 16-byte
  group once; the one-segment host route's row; and the per-client step
  index, which no lane of a ragged tail reads past the last client.

* kernels 16b and 17b, the backward passes (``csrc/flash_attention_bwd.cu``,
  ``csrc/wkv6_bwd.cu``): flash's tensor-core walks (the dq grid's 128-row
  blocks against 64-key tiles, forming D and the log2 lse rows; the dk/dv
  grid's 128-key blocks against 64-row query tiles of every head of the
  group, the transposed scores, P and dS rounded to bf16 where the kernel
  rounds them), every visible pair visited exactly once by each grid; and
  wkv6's chunk-parallel reverse scan (reverse chunk-major tickets, the
  pivot split with the forward's state and the state gradient at each
  pivot, the pairs across a sub-chunk's middle split once more, direct
  exps only on the 8 x 8 diagonal blocks, dlw by sub-chunks) -- within
  1e-5 of the largest gradient of autograd of the plain versions, and
  wkv6's within 1e-9 of autograd of the recurrence in f64.

* kernels 16j and 16bj, the tangents' warp tensor-core route
  (``csrc/flash_attention_jvp.cu``, ``jm``): 16j's 64-row blocks and
  32-key steps with P and E carried as bf16 hi + lo pairs; 16bj's row grid
  (one sweep forming dq' = s (X - lse' Y) at hd <= 128, two beyond) and key
  grid (64-key blocks, 32-row query steps, the kv head's query heads split
  across blocks and their partials added in split order), P, P', dS, dS'
  rounded to bf16 -- exact in f64 unrounded (1e-5 of the plain versions),
  and within the card's 2^-7 / 2^-6 rounded; every visible pair visited
  once by each grid; and the tangents' route by dtype and head dims.

* kernels 17j and 17bj, the RWKV-6 recurrence's tangents
  (``csrc/wkv6_jvp.cu``): 17j's chunk-major tickets, each chunk's pairs
  with the direct clamped exp and its tangent, the state's tangent passed
  from chunk to chunk; 17bj's four launches (that state pass, the reverse
  walk carrying the state gradient and its tangent together, the outputs
  from the states at each chunk's two ends, du' over the chunks in order)
  -- within 1e-9 of forward-mode AD of the recurrence and of its gradient
  in f64, extreme decays included; the kernel's constants and shared
  memory.

Also: the route the flash wrapper picks, that every launcher's C signature
(and the inner loop's occupancy query) has as many parameters as its
ctypes binding declares, and that
``chip_smoke.py`` reads the compiler's register report and tells whether a
plain op wrote x_bar.
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_update as FU
from repro_torch.kernels import inner_loop as IL
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as WK
from repro_torch.kernels._build import CSRC

LOG2E = 1.4426950408889634
LM_TREE = [(512, 384), (768, 512), (512, 768), (768, 512), (512, 768), (768,)]
NEG = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# kernel 1: the inner loop's resident route
# ---------------------------------------------------------------------------

def warp_dot(Hs, x):
    """sum_e Hs[:, j, e] x[:, e] in the kernel's order: lane l sums columns
    128 q + 4 l + (0..3) over q with FMAs (exact product, one rounding, in
    f64), then the lanes' partials add by the xor-shuffle tree.  Hs (m, R,
    W), x (m, W), f32 -> (m, R)."""
    m, R, W = Hs.shape
    h = Hs.double().reshape(m, R, W // 128, 32, 4)
    xx = x.double().reshape(m, 1, W // 128, 32, 4)
    acc = torch.zeros(m, R, 32, dtype=torch.float64)
    for q in range(W // 128):
        for e in range(4):
            acc = (h[:, :, q, :, e] * xx[:, :, q, :, e] + acc).float().double()
    acc = acc.float()
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    return acc[..., 0]


def inner_loop_resident_model(x0, H, c, xs, lam, step, rho, K, C, off=None):
    """The resident route with clusters of C blocks: (x_K, x_bar) in x0's
    dtype."""
    m, W = x0.shape
    rows = W // C
    cc = c.float() + (off.float() if off is not None else 0.0)
    st = step[:, None] if torch.is_tensor(step) else step
    xbuf = [[x0.float().clone(), torch.full((m, W), float("nan"))] for _ in range(C)]
    xsum = [torch.zeros(m, rows) for _ in range(C)]
    for k in range(K):
        cur, nxt = k & 1, (k + 1) & 1
        new = []
        for b in range(C):
            sl = slice(b * rows, (b + 1) * rows)
            x = xbuf[b][cur]
            g = warp_dot(H[:, sl], x) - cc[:, sl]
            v = ref.eq20(x[:, sl], g, xs.float()[sl], None if lam is None else lam.float()[:, sl],
                         st, rho)
            xsum[b] = xsum[b] + v
            new.append(v)
        for b in range(C):  # every block's slice into every block's next copy
            for p in range(C):
                xbuf[b][nxt][:, p * rows:(p + 1) * rows] = new[p]
    x_K = torch.cat([xbuf[b][K & 1][:, b * rows:(b + 1) * rows] for b in range(C)], dim=1)
    x_bar = torch.cat(xsum, dim=1) * (1.0 / K)
    return x_K.to(x0.dtype), x_bar.to(x0.dtype)


def transposed_tree(acc):
    """The resident route's shuffle tree over a warp's rows: ``acc`` (R2,
    32) partial sums (R2 a power of two), each of the first log2(R2) levels
    halving the rows a lane holds (lanes whose bit 4 - s is set keep the
    upper half, and add the partner's partial of each kept row), then the
    plain xor tree on the one row left.  Returns (32,): lane l's sum, of row
    l >> (5 - log2 R2)."""
    R2 = acc.shape[0]
    L = R2.bit_length() - 1
    lane = torch.arange(32)
    held = [acc[t].clone() for t in range(R2)]  # held[u][l]: lane l's u-th kept row
    for s in range(L):
        half = R2 >> (s + 1)
        upper = ((lane >> (4 - s)) & 1).bool()
        partner = lane ^ (16 >> s)
        new = []
        for u in range(half):
            keep = torch.where(upper, held[u + half], held[u])
            give = torch.where(upper, held[u], held[u + half])
            new.append(keep + give[partner])
        held = new
    out = held[0]
    o = 16 >> L
    while o:
        out = out + out[lane ^ o]
        o >>= 1
    return out


@pytest.mark.parametrize("rpw", [1, 2, 3, 4, 8])
def test_inner_loop_transposed_tree_gives_the_butterfly_sums(rpw):
    """Lane l's sum after the transposed tree is, bit for bit, what the
    plain xor butterfly over all 32 lanes gives for its row (the streaming
    route's tree): every level adds the same two partials."""
    g = torch.Generator().manual_seed(rpw)
    R2 = 1 << (rpw - 1).bit_length()
    acc = torch.randn(R2, 32, generator=g) * torch.logspace(-3, 3, 32)
    acc[rpw:] = 0.0
    lane = torch.arange(32)
    full = acc.clone()
    o = 16
    while o:
        full = full + full[:, lane ^ o]
        o >>= 1
    got = transposed_tree(acc)
    row = lane >> (5 - (R2.bit_length() - 1))
    assert torch.equal(got, full[row, lane])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [256, 384])
def test_inner_loop_resident_model_matches_plain(w, dtype):
    """Per-client step, lam and off, f32 or bf16 rows: every cluster size
    gives the same bits, and those agree with the plain version within the
    kernel's 1e-4 (one bf16 ulp, 2^-7, once rounded)."""
    g = torch.Generator().manual_seed(w)
    m, K, rho = 3, 4, 0.9
    A = torch.randn(m, w, w, generator=g) / w ** 0.5
    H = A @ A.transpose(1, 2) / 4.0
    x0, c, lam, off = (torch.randn(m, w, generator=g) for _ in range(4))
    xs = torch.randn(w, generator=g)
    x0, xs, lam, off = (t.to(dtype) for t in (x0, xs, lam, off))
    step = 0.05 + 0.1 * torch.rand(m, generator=g)
    want = ref.inner_loop_affine_ref(x0, H, c, xs, lam, step, rho, K, off=off)
    got = {C: inner_loop_resident_model(x0, H, c, xs, lam, step, rho, K, C, off=off)
           for C in (1, 4, IL.cluster_size(w))}
    assert IL.cluster_size(w) == (8 if w == 384 else 2)
    for out in got.values():
        for a, b in zip(out, got[1]):
            assert torch.equal(a, b)
        for a, b in zip(out, want):
            assert a.dtype == dtype
            rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4)


# ---------------------------------------------------------------------------
# kernel 16: the tensor-core flash
# ---------------------------------------------------------------------------

def key_tile(hd, vd):
    """The tensor-core route's keys a tile (``csrc/flash_attention.cu``
    ``tc::key_tile``): 128 while hd and vd fit two 64-column boxes, else 64."""
    return 128 if -(-hd // 64) <= 2 and -(-vd // 64) <= 2 else 64


def flash_tc_model(q, k, v, *, causal=True, window=None, q_offset=0, bq=128, bk=None):
    """The tensor-core route's numerics: q (B, Sq, H, hd), v (B, Sk, Hkv,
    vd) bf16 in, (B, Sq, H, vd) bf16 out; key tiles of ``key_tile(hd, vd)``
    keys unless ``bk`` is given."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    bk = key_tile(hd, vd) if bk is None else bk
    g = H // Hkv
    win = 0 if window is None else window
    scale_log2 = float(np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E))
    qf = q.float().reshape(B, Sq, Hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B, Hkv, g, Sq, hd)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))          # (B, Hkv, Sk, hd)
    nk = -(-Sk // bk) * bk
    kf = torch.nn.functional.pad(kf, (0, 0, 0, nk - Sk))  # TMA's zero fill past Sk
    vf = torch.nn.functional.pad(vf, (0, 0, 0, nk - Sk))
    out = torch.zeros(B, Hkv, g, Sq, vd, dtype=F32)
    last = q_offset + Sq - 1
    for q0 in range(0, Sq, bq):
        lo, hi = q_offset + q0, q_offset + min(q0 + bq, Sq) - 1
        k_end = min(Sk, hi + 1) if causal else Sk
        k_begin = (max(0, lo - win + 1) if win > 0 else 0) // bk * bk
        for w0 in (q0, q0 + 64):  # the block's two warpgroups
            if w0 >= Sq:
                continue
            rows = slice(w0, min(w0 + 64, Sq))
            wq_lo, wq_hi = q_offset + w0, min(q_offset + w0 + 63, last)
            pos = torch.arange(wq_lo, wq_lo + rows.stop - rows.start)[:, None]
            m = torch.full((B, Hkv, g, pos.shape[0], 1), NEG)
            l = torch.zeros_like(m)
            acc = torch.zeros(B, Hkv, g, pos.shape[0], vd)
            for kt in range(k_begin, k_end, bk):
                if causal and kt > wq_hi or win > 0 and kt + bk - 1 <= wq_lo - win:
                    continue  # wholly masked for these rows
                x = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, rows], kf[:, :, None, kt:kt + bk]
                                 .squeeze(2)) * scale_log2
                col = torch.arange(kt, kt + bk)[None, :]
                valid = col < Sk
                if causal:
                    valid = valid & (col <= pos)
                if win > 0:
                    valid = valid & (col > pos - win)
                x = torch.where(valid, x, NEG)
                mn = torch.maximum(m, x.amax(-1, keepdim=True))
                al = torch.exp2(m - mn)
                p = torch.exp2(x - mn)
                l = l * al + p.sum(-1, keepdim=True)
                acc = acc * al + torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(),
                                              vf[:, :, kt:kt + bk])
                m = mn
            out[:, :, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vd).bfloat16()


# (B, Sq, Sk, H, Hkv, hd, window[, vd]): causal, window of 256 and below one
# tile, GQA 4:1 and 2:1, suffix queries at an offset that is not
# tile-aligned, ragged Sq and Sk, hd 16 to 128 (one and two 64-column boxes);
# then the 64-key tiles of wider heads: MLA's hd 192 with vd 128,
# recurrentgemma's hd 256 on one kv head with a window, stablelm's 160, and
# vd above and below hd
FLASH_CASES = [
    (1, 256, 256, 2, 2, 128, None),
    (1, 256, 256, 2, 2, 64, 40),
    (1, 200, 200, 4, 1, 128, None),
    (1, 128, 384, 4, 2, 64, None),
    (2, 72, 200, 2, 2, 80, None),
    (1, 200, 1000, 2, 2, 128, 256),
    (1, 130, 130, 2, 1, 48, 100),
    (2, 64, 64, 2, 2, 16, None),
    (1, 200, 200, 2, 2, 192, None, 128),
    (1, 77, 333, 4, 1, 256, 40, 256),
    (1, 130, 130, 2, 2, 160, 100, 160),
    (1, 100, 100, 2, 2, 64, None, 256),
    (1, 100, 100, 2, 2, 256, None, 64),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_tensor_core_model_matches_plain(case):
    B, Sq, Sk, H, Hkv, hd, window = case[:7]
    vd = case[7] if len(case) > 7 else hd
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).bfloat16()
               for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, vd)))
    off = Sk - Sq
    got = flash_tc_model(q, k, v, window=window, q_offset=off)
    want = ref.flash_attention_ref(q, k, v, torch.arange(off, Sk), torch.arange(Sk),
                                   causal=True, window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert rel <= 2.0 ** -7, rel


def test_flash_model_rounds_p_where_the_kernel_does():
    """p rounded to bf16 before p v moves the output (the model is not the
    plain version under another name), by less than the tolerance."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64), dtype=np.float32))
               .bfloat16() for _ in range(3))
    got = flash_tc_model(q, k, v).float()
    plain = ref.flash_attention_ref(q, k, v, torch.arange(128), torch.arange(128)).float()
    assert 0 < float((got - plain).abs().max()) <= 2.0 ** -7 * float(plain.abs().max())


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 72, "cuda_cores"), (torch.bfloat16, 100, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"), (torch.float32, 64, "cuda_cores"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 160, "wgmma"),
    (torch.float32, 256, "cuda_cores"), (torch.bfloat16, 200, "cuda_cores"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, hd, want):
    assert FA.route(dtype, hd) == want


@pytest.mark.parametrize("hd,vd,want", [(192, 128, "wgmma"), (64, 256, "wgmma"),
                                        (128, 136, "cuda_cores"), (200, 136, "cuda_cores")])
def test_flash_route_by_both_head_dims(hd, vd, want):
    """MLA's hd 192 / vd 128 on the tensor cores; a vd off the 16-column
    step on the CUDA cores."""
    assert FA.route(torch.bfloat16, hd, vd) == want


def test_flash_key_tiles_and_shared_memory_fit():
    """The key tile the launcher picks, and the tensor-core route's shared
    memory (q, two stages of k and v, the barriers, 1 KB of alignment
    slack) within the H100's 227 KB at every pair of box counts."""
    text = (CSRC / "flash_attention.cu").read_text()
    assert "return hdb <= 2 && vdb <= 2 ? 128 : 64;" in text
    for hdb in range(1, 5):
        for vdb in range(1, 5):
            bk = key_tile(64 * hdb, 64 * vdb)
            smem = 1024 + hdb * 128 * 128 + 2 * (hdb + vdb) * bk * 128 + 5 * 8
            assert smem <= 227 * 1024, (hdb, vdb, smem)
    assert (key_tile(128, 128), key_tile(192, 128), key_tile(256, 256)) == (128, 64, 64)


# ---------------------------------------------------------------------------
# kernel 17: wkv6 as a chunk-parallel scan
# ---------------------------------------------------------------------------

def wkv6_scan_model(r, k, v, w, u, s0, chunk=64, sub=16):
    """The kernel's arithmetic in f32: (y, final state)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    rf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
    lw = torch.nn.functional.pad(torch.log(torch.clamp(w.float(), min=1e-38)),
                                 (0, 0, 0, 0, 0, pad))  # lw = 0 past S: la stays put
    shape = (B, nc, chunk, H)
    rf, kf, lw = (t.reshape(*shape, K) for t in (rf, kf, lw))
    vf = vf.reshape(*shape, V)
    la = torch.cumsum(lw, dim=2)
    lap = la - lw
    nsub = chunk // sub
    # pivots: lb_0 = 0, lb_i = la after step 16 i - 2, lb_nsub = la at the chunk's end
    lb = ([torch.zeros_like(la[:, :, 0])] + [la[:, :, i * sub - 2] for i in range(1, nsub)]
          + [la[:, :, -1]])
    # the chunk's own state at each pivot, groups of steps 16 i - 1 .. 16 i + 14
    W = [torch.zeros(B, nc, H, K, V)]
    for i in range(nsub):
        grp = slice(i * sub - 1 if i else 0, chunk if i == nsub - 1 else (i + 1) * sub - 1)
        k_hat = kf[:, :, grp] * torch.exp(lb[i + 1][:, :, None] - la[:, :, grp])
        W.append(torch.exp(lb[i + 1] - lb[i])[..., None] * W[i]
                 + torch.einsum("bcthk,bcthv->bchkv", k_hat, vf[:, :, grp]))
    # the state entering each chunk, passed in chunk order
    st, s_in = s0.float(), []
    for c in range(nc):
        s_in.append(st)
        st = torch.exp(lb[nsub][:, c])[..., None] * st + W[nsub][:, c]
    s_in = torch.stack(s_in, dim=1)  # (B, nc, H, K, V)
    # outputs by sub-chunks of rows 16 i .. 16 i + 15: the state at pivot i,
    # and the steps from 16 i - 1 on directly
    ys = []
    uf = u.float()
    for i in range(nsub):
        rows = slice(i * sub, (i + 1) * sub)
        si = torch.exp(lb[i])[..., None] * s_in + W[i]
        r_i, v_i = rf[:, :, rows], vf[:, :, rows]
        # clamped at 0 as the reference's pairwise exp is
        r_hat = r_i * torch.exp(torch.clamp(lap[:, :, rows] - lb[i][:, :, None], max=0.0))
        y = torch.einsum("bcthk,bchkv->bcthv", r_hat, si)
        t0 = i * sub - 1 if i else 0
        taus = slice(t0, (i + 1) * sub)
        diff = lap[:, :, rows, None] - la[:, :, None, taus]  # (b, c, t, tau, h, k)
        att = torch.einsum("bcthk,bcshk,bctshk->bchts", r_i, kf[:, :, taus],
                           torch.exp(torch.clamp(diff, max=0.0)))
        before = (torch.arange(t0, (i + 1) * sub)[None, :]
                  < torch.arange(i * sub, (i + 1) * sub)[:, None])
        att = torch.where(before, att, 0.0)
        bonus = torch.einsum("bcthk,bcthk->bcth", r_i * uf, kf[:, :, rows])
        ys.append(y + torch.einsum("bchts,bcshv->bcthv", att, vf[:, :, taus])
                  + bonus[..., None] * v_i)
    y = torch.cat(ys, dim=2).reshape(B, nc * chunk, H, V)[:, :S]
    return y.to(r.dtype), st


def _wkv6_inputs(B, S, H, K, V, seed, decay="model", s0_zero=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))  # noqa: E731
    r, k = f(B, S, H, K), f(B, S, H, K)
    v = f(B, S, H, V)
    if decay == "model":
        w = torch.exp(-torch.exp(0.5 * f(B, S, H, K) - 1.0))
    else:  # decay 1e-30 mixed with 0.9
        w = torch.full((B, S, H, K), 1e-30)
        w[:, ::3] = 0.9
    u = 0.1 * f(H, K)
    s0 = torch.zeros(B, H, K, V) if s0_zero else f(B, H, K, V)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S", [1, 63, 64, 65, 100, 200])
@pytest.mark.parametrize("s0_zero", [False, True])
def test_wkv6_scan_model_matches_plain(S, s0_zero):
    args = _wkv6_inputs(2, S, 2, 64, 64, seed=S, s0_zero=s0_zero)
    for got, want in zip(wkv6_scan_model(*args), ref.wkv6_ref(*args)):
        rel = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
        assert rel <= 1e-5, rel


@pytest.mark.parametrize("S,K,V", [(100, 64, 64), (130, 32, 48), (64, 64, 16)])
def test_wkv6_scan_model_extreme_decay_is_finite_and_matches(S, K, V):
    """Decay 1e-30 (la falls by 69 a step) mixed with 0.9: every factor of
    the sub-chunk split stays <= 1, so the result is finite and the same."""
    args = _wkv6_inputs(2, S, 3, K, V, seed=11, decay="extreme")
    y, s = wkv6_scan_model(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for got, want in zip((y, s), ref.wkv6_ref(*args)):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= 1e-5, rel


# ---------------------------------------------------------------------------
# kernels 4 and 6: the eq. (20) step over a table of segments
# ---------------------------------------------------------------------------

EQ20 = (CSRC / FU.SOURCE).read_text()


def _const(name):
    m = re.search(r"constexpr (?:int|size_t) " + name + r" = ([^;]+);", EQ20)
    assert m, name
    return m.group(1)


def test_segment_table_constants_match_the_kernel():
    """The host's threads a block, descriptor words a segment, small table
    and acc flags are the kernel's; the largest table fits the parameter
    limit of its toolkit (32,764 bytes from CUDA 12.1, else 4 KB): a
    32-byte header and 80 bytes a segment."""
    assert int(_const("kThreads")) == FU.THREADS == 256
    assert int(_const("kDescWords")) == FU.DESC_WORDS == 10
    assert int(_const("kSmallSegs")) == 8
    assert "kAccFirst = 1, kAccLast = 2" in EQ20
    assert FU.ACC_MODES == {"add": 0, "first": 1, "last": 2, "only": 1 | 2}
    assert _const("kMaxSegs") == "(int)((kParamLimit - 32) / 80)"
    assert "constexpr size_t kParamLimit = 32764;" in EQ20
    assert "constexpr size_t kParamLimit = 4096;" in EQ20
    assert [(lim - 32) // 80 for lim in (32764, 4096)] == [409, 50]


def test_segment_blocks_cover_each_segment_up_to_the_cap():
    """One thread a 16-byte group: ceil(groups / 256) blocks a segment up to
    the grid's cap (132 SMs x 64 blocks), then each share scaled down, at
    least one block each."""
    cap = 132 * FU.BLOCKS_PER_SM
    small = [5 * 7, 5 * 150, 5 * 130, 5]
    assert FU.segment_blocks(small, 4) == [1, 1, 1, 1]
    assert FU.segment_blocks([4 * 256 * 3, 4 * 256 * 3 + 1], 4) == [3, 4]
    assert FU.segment_blocks([8 * 256 * 3], 8) == [3]
    assert FU.segment_blocks([8 << 20], 4) == [8192]  # lm_flat's arena, under the cap
    lm_tree = [8 * math.prod(s) for s in LM_TREE]
    want = [-(-n // (4 * 256)) for n in lm_tree]
    got = FU.segment_blocks(lm_tree, 4)
    assert sum(want) > cap >= sum(got)
    assert all(g >= 1 for g in got) and got[-1] == want[-1] * cap // sum(want)  # the bias
    assert got[0] / got[1] == pytest.approx(want[0] / want[1], rel=0.01)
    assert FU.segment_blocks([32 << 20], 4) == [cap]


def test_plan_chunks_at_the_parameter_limit():
    """As few launches as the table allows, segments in order."""
    sizes = list(range(1, 121))
    for cap, lens in ((409, [120]), (50, [50, 50, 20]), (8, [8] * 15)):
        chunks = FU.plan(sizes, 4, cap)
        assert [len(c) for c in chunks] == lens
        assert [i for c in chunks for i, _ in c] == list(range(120))
    assert FU.plan([10, 20], 8, 409) == [[(0, 1), (1, 1)]]


def test_leaves_table_rows_group_by_dtype(monkeypatch):
    """The card path's table: one launch list per dtype in order of first
    appearance, each leaf's row its addresses (0 for no lam or acc), its
    element count, the server period (the leaf without its client dim, or
    all of it) and its elements per client; an empty leaf gets an output
    and no row.  Run on CPU tensors with the launch recorded."""
    calls = []
    monkeypatch.setattr(FU, "_launch", lambda k, rows, dt, *a: calls.append((k.name, dt, rows)))
    monkeypatch.setattr(FU._args, "stream_args", lambda dev: (None, None))
    f32, bf16 = torch.float32, torch.bfloat16
    xs = [torch.zeros(4, 3, dtype=bf16), torch.zeros(4, 5), torch.zeros(4, 0),
          torch.zeros(4, 2, 2, dtype=bf16), torch.zeros(4)]
    srv = [x[0].clone() for x in xs[:4]] + [xs[4].clone()]
    lams = [None, xs[1].clone(), None, xs[3].clone(), None]
    accs = [torch.zeros_like(x) for x in xs]
    outs = FU._leaves(xs, xs, srv, lams, 0.1, 2.0, accs, "last", 0.25)
    assert [tuple(o.shape) for o in outs] == [tuple(x.shape) for x in xs]
    assert [(name, dt, len(rows)) for name, dt, rows in calls] == [
        ("fused_update", bf16, 2), ("fused_update", f32, 2)]
    p = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    want = {bf16: (0, 3), f32: (1, 4)}
    for _, dt, rows in calls:
        for row, i in zip(rows, want[dt]):
            x, n = xs[i], xs[i].numel()
            assert row == (p(x), p(x), p(srv[i]), p(lams[i]), p(outs[i]), p(accs[i]), n,
                           srv[i].numel(), n // 4)



@pytest.mark.parametrize("arena", [False, True])
def test_one_segment_route_launches_the_tables_row(monkeypatch, arena):
    """The one-leaf and arena wrappers' lean host route enqueues the same
    one-row table as ``_leaves`` would build for that leaf: the addresses,
    n, the server period, the elements per client and ``segment_blocks``'s
    blocks; step, rho, the acc flags and the scale as the launcher takes
    them.  Run on CPU tensors with the launch recorded."""
    import ctypes

    class Rec:
        name = "rec"

        def __init__(self):
            self.calls = []

        def launch(self, desc, nseg, step_arr, step, rho, scale, flags, code, dev, stream):
            words = (ctypes.c_longlong * (FU.DESC_WORDS * nseg)).from_address(desc.value)
            self.calls.append((list(words), nseg, step, rho, scale, flags, code))

    monkeypatch.setattr(FU._args, "stream_args", lambda dev: (ctypes.c_int(0), None))
    monkeypatch.setattr(FU, "_sms", lambda index: 132)
    x, g, lam, acc = (torch.randn(6, 1000) for _ in range(4))
    srv = torch.randn(1000)
    k = Rec()
    out = FU._segment(k, x, g, srv, None if arena else lam, 0.25, 3.0, acc, "last", 0.5)
    p = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    (words, nseg, step, rho, scale, flags, code), = k.calls
    assert nseg == 1 and (step, rho, scale, flags) == (0.25, 3.0, 0.5, FU.ACC_MODES["last"])
    assert code == FU._DTYPES[torch.float32][0]
    assert words == [p(x), p(g), p(srv), 0 if arena else p(lam), p(out), p(acc), 6000, 1000,
                     1000, FU.segment_blocks([6000], 4)[0]]


def walk(numels, vec, blocks):
    """Which block and thread each (segment, group) falls to, as the kernel
    walks the table: a block's segment by binary search over the segments'
    first blocks, then the segment's groups strided by its blocks."""
    first = np.cumsum([0] + blocks[:-1])
    hits = [np.zeros(-(-n // vec), dtype=np.int64) for n in numels]
    for b in range(sum(blocks)):
        lo, hi = 0, len(blocks) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if first[mid] <= b else (lo, mid - 1)
        q0 = (b - first[lo]) * FU.THREADS + np.arange(FU.THREADS)
        for q in range(0, len(hits[lo]), blocks[lo] * FU.THREADS):
            idx = q0 + q
            np.add.at(hits[lo], idx[idx < len(hits[lo])], 1)
    return hits


@pytest.mark.parametrize("numels,vec,sms", [
    ([5 * 7, 5 * 150, 5 * 130, 5], 4, 132),  # a ragged tree: one block each
    ([8 * 13, 8 * 130, 8 * 7], 8, 132),  # bf16, tails of 0-7 values
    ([2 * math.prod(s) for s in LM_TREE], 4, 1),  # lm_tree at m = 2, capped on 1 SM
    ([40_000, 3, 123_457], 4, 3),
])
def test_table_walk_steps_every_group_once(numels, vec, sms):
    """The kernel's walk over ``plan``'s blocks touches every 16-byte group
    of every segment exactly once, the scaled-down shares striding."""
    (chunk,) = FU.plan(numels, vec, 409, sms)
    hits = walk(numels, vec, [b for _, b in chunk])
    assert all(bool((h == 1).all()) for h in hits)


def group_steps(n, per_client, vec):
    """The per-client step index of each lane, as the kernel steps it
    within a 16-byte group: the group's client and remainder once, then
    one lane at a time, lanes past the segment's end reading nothing.
    Returns (the client each element reads, every client index read)."""
    got, read = np.full(n, -1), []
    for t0 in range(0, n, vec):
        c, r = divmod(t0, per_client)
        for j in range(vec):
            if t0 + j < n:
                read.append(c)
                got[t0 + j] = c
                r += 1
                if r == per_client:
                    r, c = 0, c + 1
    return got, read


@pytest.mark.parametrize("m,per_client,vec", [
    (5, 7, 4),  # a (5, 7) f32 leaf: the last group has one live lane
    (5, 1, 8),  # an (m,) bf16 leaf: one value a client, tails of 5
    (8, 3 * 50, 4), (3, 130, 8), (2, 768, 4),
])
def test_step_index_reads_only_the_segments_clients(m, per_client, vec):
    """Each element takes its own client's step, and no lane of a ragged
    tail reads a step past client m - 1 (the kernel guards the read with
    ``t0 + j < n``)."""
    n = m * per_client
    got, read = group_steps(n, per_client, vec)
    assert (got == np.arange(n) // per_client).all()
    assert max(read) == m - 1
    assert re.search(r"if \(step_arr != nullptr && t0 \+ j < n\) \{\s*st\[j\] = step_arr\[c\];",
                     EQ20)


# ---------------------------------------------------------------------------
# the launchers' C signatures against their ctypes bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kern", ops.KERNELS, ids=lambda k: k.name)
def test_launcher_signature_matches_binding(kern):
    text = (CSRC / kern.source).read_text()
    m = re.search(r'extern "C" int ' + kern.symbol + r"\(([^)]*)\)", text)
    assert m, (kern.source, kern.symbol)
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(kern.argtypes), (kern.name, len(params), len(kern.argtypes))


def test_resident_clusters_query_matches_binding():
    text = (CSRC / IL.KERNEL.source).read_text()
    m = re.search(r'extern "C" int ' + IL.CLUSTERS_SYMBOL + r"\(([^)]*)\)", text)
    assert m
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(IL.CLUSTERS_ARGTYPES)


RESIDENT_TABLE = re.compile(r"case (\d+): return launch_resident<T, (\d+), (\d+)>\(a, (\d+),")


def test_resident_table_is_the_route_rule():
    """The launcher's table of resident instantiations, (W, NQ, RPW, C),
    is the wrapper's rule: one row for each width ``route`` sends to the
    resident route, with ``cluster_size`` blocks and ``rows_per_warp``."""
    table = [tuple(map(int, t)) for t in
             RESIDENT_TABLE.findall((CSRC / IL.KERNEL.source).read_text())]
    widths = [w for w in range(128, 9601, 128) if IL.route(w) == "resident"]
    assert [t[0] for t in table] == widths == [128, 256, 384, 512, 640]
    for w, nq, rpw, c in table:
        assert (nq, c, rpw) == (w // 128, IL.cluster_size(w), IL.rows_per_warp(w, c))


FLASH_FN = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_daae7df82tc15flash_tc_kernel"
            "ILi2EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16iiiiiiiif")
WKV6_FN = ("_ZN39_GLOBAL__N__f32662c3_7_wkv6_cu_daae7df811wkv6_kernelI13__nv_bfloat16EEvPKT_"
           "S4_S4_PKfS6_S6_PS2_PfS9_Piiiiiiii")
PTXAS_LOG = f"""\
ptxas info    : Compiling entry function '{FLASH_FN}' for 'sm_90a'
ptxas info    : Function properties for {FLASH_FN}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 138 registers, used 1 barriers
ptxas info    : Compiling entry function '{WKV6_FN}' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, 1024 bytes smem, used 1 barriers
ptxas info    : Compiling entry function 'launch_plain' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("use_avg", [True, False])
def test_chip_smoke_finds_who_wrote_x_bar(use_avg):
    """``chip_smoke.x_bar_plain`` on a GPDMM pytree round of three leaves
    on the CPU: the plain versions write x_bar with tensor ops, so every
    leaf counts as plain (on the card the kernel writes it and none does);
    with ``use_avg=False`` the inner loop keeps no x_bar at all."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import gpdmm, make

    smoke = _chip_smoke()
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=3, eta=0.1, use_arena=False,
                               use_avg=use_avg))
    params = {k: torch.linspace(-1, 1, n) for k, n in (("a", 5), ("b", 7), ("c", 3))}
    state = opt.init(params, 4)
    grad = lambda p, b: {k: 0.3 * v for k, v in p.items()}  # noqa: E731
    found = smoke.x_bar_plain(torch, gpdmm, "inner_steps",
                              lambda: opt.round(state, grad, {"d": torch.zeros(4, 1)}))
    assert found == ([(3, 3)] if use_avg else [(0, 0)])
    assert gpdmm.inner_steps.__name__ == "inner_steps"  # unwrapped again


def test_chip_smoke_reads_the_register_report():
    smoke = _chip_smoke()
    assert smoke.ptxas_report(PTXAS_LOG) == [
        {"fn": "flash_tc_kernel<2>", "spill": 0, "regs": 138, "smem": 0},
        {"fn": "wkv6_kernel<__nv_bfloat16>", "spill": 4, "regs": 128, "smem": 1024},
        {"fn": "launch_plain", "regs": 12, "smem": 0},
    ]


# ---------------------------------------------------------------------------
# kernels 16b and 17b: the backward passes' walks
# ---------------------------------------------------------------------------

BWD = (CSRC / "flash_attention_bwd.cu").read_text()
WKV_BWD = (CSRC / "wkv6_bwd.cu").read_text()


def _bwd_const(text, name):
    m = re.search(r"constexpr (?:int|float) " + name + r" = ([^;]+);", text)
    assert m, name
    lit = m.group(1)
    return float(lit.rstrip("f")) if lit.endswith("f") else int(lit)


def test_bwd_model_constants_match_the_kernels():
    """The tiles the models walk are the kernels' own."""
    assert (_bwd_const(BWD, "kKeys"), _bwd_const(BWD, "kQRows"), _bwd_const(BWD, "kRows"),
            _bwd_const(BWD, "kKTile"), _bwd_const(BWD, "kRowsPad")) == (
        FLASH_BWD_KEYS, FLASH_BWD_QROWS, FLASH_BWD_ROWS, FLASH_BWD_KTILE, FA.SCRATCH_ROWS)
    assert _bwd_const(BWD, "kPadLse") == 1e30
    assert (_bwd_const(WKV_BWD, "kC"), _bwd_const(WKV_BWD, "kSub")) == (WK.CHUNK, WKV_BWD_SUB)
    assert WK.SUB_CHUNKS == WK.CHUNK // WKV_BWD_SUB  # du's shares a chunk


FLASH_BWD_KEYS, FLASH_BWD_QROWS = 128, 64   # dk/dv grid: keys a block, query rows a tile
FLASH_BWD_ROWS, FLASH_BWD_KTILE = 128, 64   # dq grid: query rows a block, keys a tile
WG = 64                                     # rows (keys or queries) a warpgroup


def _flash_bwd_model(q, k, v, do, q_offset, window, bf16=False):
    """``csrc/flash_attention_bwd.cu``'s tensor-core route in plain tensors
    (f64 unless ``bf16``, which rounds P and dS to bf16 where the kernel
    does): the dq grid (a block of 128 query rows, which first forms D and
    lse in log2 units on rows padded to 64 for the other grid, a
    warpgroup's 64 rows against key tiles of 64) and the dk/dv grid (a
    block of 128 keys, a warpgroup's 64 keys against query tiles of 64 rows
    of every head of the group, the transposed scores S^T = k q^T, P^T and
    dS^T rounded before dv += P^T do and dk += dS^T q); returns (dq, dk,
    dv, visits, ok), visits counting for each grid how often each (query,
    key) pair was used."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, scale = H // Hkv, 1.0 / math.sqrt(hd)
    scale_log2 = scale * LOG2E
    win = window or 0
    qp = torch.arange(q_offset, q_offset + Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = (kp <= qp) & ((kp > qp - win) if win else torch.ones_like(kp, dtype=bool))
    f = torch.float64
    qf, kf, vf, dof = (t.to(f) for t in (q, k, v, do))
    rnd = (lambda x: x.to(torch.bfloat16).to(f)) if bf16 else (lambda x: x)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf.repeat_interleave(G, 2)) * scale
    lse = torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1)  # the forward's (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]) * ok,
                     vf.repeat_interleave(G, 2))
    # the dq grid's rows, padded to whole tiles of 64, P = 0 on the pad rows
    pad = -(-Sq // FLASH_BWD_QROWS) * FLASH_BWD_QROWS
    lse2 = torch.full((B, H, pad), 1e30, dtype=f)
    lse2[..., :Sq] = lse * LOG2E
    Dv = torch.zeros(B, H, pad, dtype=f)
    Dv[..., :Sq] = (dof * o).sum(-1).permute(0, 2, 1)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    visits = torch.zeros(2, Sq, Sk, dtype=torch.int64)

    def probs(b, h, qs, ks, lrow, drow):
        """P and dS of queries qs against keys ks (q-major), masked."""
        hk = h // G
        sc = qf[b, qs, h] @ kf[b, ks, hk].T
        p = torch.exp2(sc * scale_log2 - lrow[:, None]) * ok[qs, ks]
        dp = dof[b, qs, h] @ vf[b, ks, hk].T
        return p, p * (dp - drow[:, None])

    for b in range(B):
        for hk in range(Hkv):  # dk, dv: a block per 128 keys
            for kt0 in range(0, Sk, FLASH_BWD_KEYS):
                k_last = min(kt0 + FLASH_BWD_KEYS, Sk) - 1
                i_begin = max(0, kt0 - q_offset) // FLASH_BWD_QROWS * FLASH_BWD_QROWS
                i_end = min(Sq, k_last + win - q_offset) if win else Sq
                for kw0 in (kt0, kt0 + WG):  # the block's two warpgroups
                    if kw0 >= Sk:
                        continue
                    ks = slice(kw0, min(kw0 + WG, Sk))
                    for h in range(hk * G, (hk + 1) * G):
                        for q0 in range(i_begin, i_end, FLASH_BWD_QROWS):
                            qp0 = q_offset + q0
                            if qp0 + FLASH_BWD_QROWS - 1 < kw0 or win and kw0 + 63 <= qp0 - win:
                                continue  # wholly masked for this warpgroup's keys
                            qs = slice(q0, min(q0 + FLASH_BWD_QROWS, Sq))
                            p, ds = probs(b, h, qs, ks, lse2[b, h, qs], Dv[b, h, qs])
                            dv[b, ks, hk] += rnd(p).T @ dof[b, qs, h]     # P^T do
                            dk[b, ks, hk] += rnd(ds).T @ qf[b, qs, h]     # dS^T q
                            if b == 0 and h == 0:
                                visits[1, qs, ks] += ok[qs, ks].long()
        for h in range(H):  # dq: a block per 128 query rows
            for q0 in range(0, Sq, FLASH_BWD_ROWS):
                lo, hi = q_offset + q0, q_offset + min(q0 + FLASH_BWD_ROWS, Sq) - 1
                k_end = min(Sk, hi + 1)
                k_begin = (max(0, lo - win + 1) if win else 0) // FLASH_BWD_KTILE * FLASH_BWD_KTILE
                for w0 in (q0, q0 + WG):
                    if w0 >= Sq:
                        continue
                    qs = slice(w0, min(w0 + WG, Sq))
                    wq_lo, wq_hi = q_offset + w0, q_offset + qs.stop - 1
                    for kt in range(k_begin, k_end, FLASH_BWD_KTILE):
                        if kt > wq_hi or win and kt + FLASH_BWD_KTILE - 1 <= wq_lo - win:
                            continue
                        ks = slice(kt, min(kt + FLASH_BWD_KTILE, Sk))
                        _, ds = probs(b, h, qs, ks, lse2[b, h, qs], Dv[b, h, qs])
                        dq[b, qs, h] += rnd(ds) @ kf[b, ks, h // G]  # dS k
                        if b == 0 and h == 0:
                            visits[0, qs, ks] += ok[qs, ks].long()
    return dq * scale, dk * scale, dv, visits, ok


# (Sq, Sk, H, Hkv, hd, q_offset, window): ragged, GQA 2:1 and 4:1, suffix
# queries at an offset, windows below and above a tile, several key blocks
FLASH_BWD_MODEL_CASES = [
    (150, 150, 4, 2, 8, 0, None), (100, 100, 2, 1, 8, 0, 30), (70, 200, 4, 4, 8, 130, None),
    (96, 96, 2, 2, 8, 0, 5), (257, 257, 2, 2, 8, 0, None), (200, 200, 8, 2, 16, 0, 64),
    (130, 300, 4, 1, 16, 170, 100), (64, 64, 2, 2, 16, 0, None), (300, 300, 2, 1, 8, 0, 200),
]


def _flash_bwd_inputs(case, B=1):
    Sq, Sk, H, Hkv, hd, off, window = case
    rng = np.random.default_rng(sum(case[:6]))
    f = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    return f(B, Sq, H, hd), f(B, Sk, Hkv, hd), f(B, Sk, Hkv, hd), f(B, Sq, H, hd), off, window


@pytest.mark.parametrize("case", FLASH_BWD_MODEL_CASES)
def test_flash_bwd_walk_matches_autograd(case):
    q, k, v, do, off, window = _flash_bwd_inputs(case)
    Sq, Sk = q.shape[1], k.shape[1]
    dq, dk, dv, visits, ok = _flash_bwd_model(q, k, v, do, off, window)
    assert torch.equal(visits[0], ok.long()) and torch.equal(visits[1], ok.long())
    want = ref.flash_attention_bwd_ref(q, k, v, do, torch.arange(off, off + Sq),
                                       torch.arange(Sk), window=window)
    for a, b in zip((dq, dk, dv), want):
        # the plain version runs in f32: 1e-5 of the largest gradient
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("case", [FLASH_BWD_MODEL_CASES[1], FLASH_BWD_MODEL_CASES[6]],
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_bwd_model_rounds_p_and_ds_where_the_kernel_does(case):
    """P and dS rounded to bf16 before their products move the gradients
    (the model is not the exact one under another name), by less than the
    card's tolerance against the plain version, 2^-6 of the largest."""
    q, k, v, do, off, window = _flash_bwd_inputs(case)
    exact = _flash_bwd_model(q, k, v, do, off, window)[:3]
    got = _flash_bwd_model(q, k, v, do, off, window, bf16=True)[:3]
    for a, b in zip(got, exact):
        err = float((a - b).abs().max())
        assert 0 < err <= 2.0 ** -6 * float(b.abs().max()), err


WM_BLK, WM_STEP, WM_WARP_ROWS = 64, 64, 16  # csrc/flash_attention_bwd.cu wm::kBlk, kStep


def _wm_bwd_walk(Sq, Sk, H, Hkv, q_offset, window, splits):
    """The (query, key) pairs each grid of 16b's warp tensor-core route
    (``csrc/flash_attention_bwd.cu`` namespace ``wm``) computes, for one
    batch row and every head, read off its loops: the dq grid (a block of
    64 query rows from ``k_begin`` to ``k_end`` in steps of 64 keys, a warp's
    16 rows skipping a step that none of them can see) and the dk/dv grid
    (a block of 64 keys and split z of the kv head's query heads, query
    tiles of 64 rows from ``i_begin`` to ``i_end``, a warp's 16 keys
    skipping a tile none of whose rows sees them; the dv warps and the dk
    warps alike).  Returns (dq visits (H, Sq, Sk), dk/dv visits, visible
    mask); a visit is a pair inside a step a warp computes and the mask
    keeps."""
    win = window or 0
    qp = torch.arange(q_offset, q_offset + Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = (kp <= qp) & ((kp > qp - win) if win else torch.ones_like(kp, dtype=bool))
    G = H // Hkv
    dq_v = torch.zeros(H, Sq, Sk, dtype=torch.int64)
    kv_v = torch.zeros(H, Sq, Sk, dtype=torch.int64)
    for h in range(H):
        for q0 in range(0, Sq, WM_BLK):
            qpos_hi = q_offset + min(q0 + WM_BLK, Sq) - 1
            k_end = min(Sk, qpos_hi + 1)
            k_begin = max(0, q_offset + q0 - win + 1) // WM_STEP * WM_STEP if win else 0
            for w in range(WM_BLK // WM_WARP_ROWS):
                r_lo = q0 + WM_WARP_ROWS * w
                if r_lo >= Sq:
                    continue
                pos_lo, pos_hi = q_offset + r_lo, q_offset + min(r_lo + 15, Sq - 1)
                rows = slice(r_lo, min(r_lo + WM_WARP_ROWS, Sq))
                for kt in range(k_begin, k_end, WM_STEP):
                    if kt > pos_hi or (win and kt + WM_STEP - 1 <= pos_lo - win):
                        continue
                    dq_v[h, rows, kt:kt + WM_STEP] += ok[rows, kt:kt + WM_STEP]
    gps = -(-G // splits)
    for hk in range(Hkv):
        for k0 in range(0, Sk, WM_BLK):
            k_last = min(k0 + WM_BLK, Sk) - 1
            i_begin = max(0, k0 - q_offset) // WM_STEP * WM_STEP
            i_end = min(Sq, k_last + win - q_offset) if win else Sq
            for z in range(splits):
                for g in range(z * gps, min(G, z * gps + gps)):
                    h = hk * G + g
                    for q0 in range(i_begin, i_end, WM_STEP):
                        qp0 = q_offset + q0
                        for kw in range(WM_BLK // WM_WARP_ROWS):
                            kw0 = k0 + WM_WARP_ROWS * kw
                            if kw0 >= Sk or qp0 + WM_STEP - 1 < kw0 or (
                                    win and kw0 + 15 <= qp0 - win):
                                continue
                            keys = slice(kw0, min(kw0 + WM_WARP_ROWS, Sk))
                            kv_v[h, q0:q0 + WM_STEP, keys] += ok[q0:q0 + WM_STEP, keys]
    return dq_v, kv_v, ok


@pytest.mark.parametrize("case", [(128, 128, 16, 1, 0, 2048, 8), (128, 128, 16, 16, 0, None, 1),
                                  (77, 200, 4, 1, 123, 40, 4), (130, 130, 8, 2, 0, None, 1),
                                  (300, 300, 4, 1, 0, 64, 3), (100, 257, 6, 2, 157, 30, 2),
                                  (200, 200, 4, 4, 0, 5, 1)],
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_bwd_warp_route_visits_every_visible_pair_once(case):
    """The warp tensor-core route's two grids, with their warps' skips and
    the dk/dv grid's split query heads (``dkdv_splits``), compute every
    visible (query, key) pair of every head exactly once, and nothing
    else (a skipped step or tile holds no visible pair)."""
    Sq, Sk, H, Hkv, off, window, splits = case
    dq_v, kv_v, ok = _wm_bwd_walk(Sq, Sk, H, Hkv, off, window, splits)
    want = ok.long().expand(H, Sq, Sk)
    assert torch.equal(dq_v, want) and torch.equal(kv_v, want)


def test_dkdv_splits_take_the_routes_key_tiles():
    """The split count the wrapper takes for each route's dk/dv grid (32
    keys a block on the CUDA cores, 64 on the warp tensor cores): the
    training round's one kv head at (8, 128) takes 8 and 16 splits of its 16
    query heads, the prefill's (4, 1,024) 4 on the warp route, no split is
    empty, and a full grid takes none."""
    assert FA.BWD_KEY_TILE == {"cuda_cores": 32, "mma": 64}
    assert FA.dkdv_splits(8, 128, 1, 16, 132, FA.BWD_KEY_TILE["cuda_cores"]) == 8
    assert FA.dkdv_splits(8, 128, 1, 16, 132, FA.BWD_KEY_TILE["mma"]) == 16
    assert FA.dkdv_splits(4, 1024, 1, 16, 132, 64) == 4
    assert FA.dkdv_splits(8, 128, 16, 1, 132, 64) == 1
    assert FA.dkdv_splits(4, 1024, 16, 1, 132, 64) == 1
    for G in range(1, 33):
        n = FA.dkdv_splits(1, 64, 1, G, 132, 64)
        assert 1 <= n <= G and (n - 1) * -(-G // n) < G


WKV_BWD_SUB = 16  # csrc/wkv6_bwd.cu kSub


def wkv6_bwd_tickets(nc, BH):
    """(chunk, b * H + h) of each ticket in the order blocks draw them:
    reverse chunk-major."""
    return [(nc - 1 - t // BH, t % BH) for t in range(nc * BH)]


def _wkv6_bwd_model(r, k, v, w, u, s0, dy, dsf, C=64, sub=WKV_BWD_SUB):
    """``csrc/wkv6_bwd.cu`` for one (b, h) in f64, r, k, w (S, K), v, dy (S,
    V): the chunks in ticket order (the last first), each publishing the
    state gradient at its start from the one at its end; inside a chunk
    the pivot split (pivots lb_I = la after step 16 I - 1; the forward's
    state S_I and the state gradient P_I at each pivot, products with
    them for every pair across sub-chunks; inside a sub-chunk the pairs
    across its middle split once more) and direct pairwise exps only on
    the 8 x 8 blocks at the diagonal, each taken for att and once more for
    dr's and dk's sums together.  Returns the gradients
    and the exps taken a chunk."""
    S, K = r.shape
    nc = -(-S // C)
    nsub = C // sub
    states, s = [], s0.clone()
    for c in range(nc):  # the forward's states entering each chunk
        states.append(s.clone())
        for t in range(c * C, min(S, (c + 1) * C)):
            s = w[t][:, None] * s + k[t][:, None] * v[t][None, :]
    states.append(s)  # s_out
    dr, dk, dv, dw, du = (torch.zeros_like(x) for x in (r, k, v, w, u))
    published, exps = {nc: dsf.clone()}, []
    inside = torch.tril(torch.ones(sub, sub, dtype=torch.bool), -1)  # tau < t, one sub-chunk
    half = sub // 2
    lower = torch.arange(sub) >= half
    diag_blocks = lower[:, None] == lower[None, :]   # both in one half of the sub-chunk
    across = lower[:, None] & ~lower[None, :]        # t below the middle, tau above it
    for c, _ in wkv6_bwd_tickets(nc, 1):
        n = min(C, S - c * C)
        pad = lambda x: torch.cat([x[c * C:c * C + n], x.new_zeros(C - n, x.shape[1])])  # noqa
        rs, ks, vs, dys = pad(r), pad(k), pad(v), pad(dy)
        lw = torch.log(torch.clamp(pad(w[:, :]) + (torch.arange(C) >= n)[:, None], min=1e-38))
        la = torch.cumsum(lw, 0)
        lp = la - lw
        lb = [torch.zeros(K, dtype=la.dtype)] + [la[I * sub - 1] for I in range(1, nsub)] + [la[-1]]
        eg = [torch.exp(lb[I + 1] - lb[I]) for I in range(nsub)]
        sub_of = torch.arange(C) // sub
        ek = torch.exp(torch.stack([lb[I + 1] for I in sub_of]) - la)  # <= 1
        er = torch.exp(torch.clamp(lp - torch.stack([lb[I] for I in sub_of]), max=0.0))
        g, bb = (dys * vs).sum(1), (rs * u * ks).sum(1)
        # the pairs inside each sub-chunk, their exps taken for att, dr and dk
        drd, dkd, dvd = torch.zeros_like(rs), torch.zeros_like(ks), bb[:, None] * dys
        n_exp = 0
        for I in range(nsub):
            rows = slice(I * sub, (I + 1) * sub)
            lr, pr = la[rows], lp[rows]
            # inside the two diagonal blocks of 8 x 8: direct exps, taken for
            # att and once more for dr's and dk's sums together
            E = torch.exp(torch.clamp(pr[:, None] - lr[None], max=0.0))  # (t, tau, k)
            E = torch.where((inside & diag_blocks)[..., None], E, 0.0)
            # across the middle m: exp(min(la_prev_t - la_m, 0)) exp(la_m - la_tau),
            # each factor taken twice (the scaled rows for att, then for the sums)
            fr = torch.exp(torch.clamp(pr - lr[half - 1], max=0.0))
            fk = torch.exp(lr[half - 1] - lr)
            E = E + torch.where(across[..., None], fr[:, None] * fk[None], 0.0)
            n_exp += (2 * int((inside & diag_blocks).sum()) + 2 * sub) * K
            att = torch.einsum("tk,sk,tsk->ts", rs[rows], ks[rows], E)
            datt = torch.where(inside, dys[rows] @ vs[rows].T, 0.0)
            drd[rows] = torch.einsum("ts,sk,tsk->tk", datt, ks[rows], E)
            dkd[rows] = torch.einsum("ts,tk,tsk->sk", datt, rs[rows], E)
            dvd[rows] += att.T @ dys[rows]
        exps.append(n_exp)
        # the forward's state at each pivot, and dr
        S_I = [states[c]]
        for I in range(nsub - 1):
            rows = slice(I * sub, (I + 1) * sub)
            S_I.append(eg[I][:, None] * S_I[-1] + (ks[rows] * ek[rows]).T @ vs[rows])
        dro = torch.cat([er[I * sub:(I + 1) * sub] * (dys[I * sub:(I + 1) * sub] @ S_I[I].T)
                         for I in range(nsub)])
        x = dro + drd
        dlp = rs * x

        # the chunk's own share before the wait: W_I by the reverse recurrence
        # from W_4 = 0, W_0 published; then P_I = W_I + exp(la_C - lb_I) dS_C
        W = [torch.zeros_like(dsf)]
        for I in reversed(range(nsub)):
            rows = slice(I * sub, (I + 1) * sub)
            W.insert(0, eg[I][:, None] * W[0] + (rs[rows] * er[rows]).T @ dys[rows])
        assert c + 1 in published  # the awaited chunk has published
        dSC = published[c + 1]
        published[c] = torch.exp(la[-1])[:, None] * dSC + W[0]
        cI = [torch.prod(torch.stack(eg[I:]), 0) for I in range(nsub)] + [torch.ones(K)]
        P = [W[I] + cI[I].to(dSC.dtype)[:, None] * dSC for I in range(nsub + 1)]
        dko = torch.cat([ek[I * sub:(I + 1) * sub] * (vs[I * sub:(I + 1) * sub] @ P[I + 1].T)
                         for I in range(nsub)])
        dvo = torch.cat([(ks[I * sub:(I + 1) * sub] * ek[I * sub:(I + 1) * sub]) @ P[I + 1]
                         for I in range(nsub)])
        y = dko + dkd
        dla = -ks * y
        tot = dla + dlp
        # dlw by sub-chunks: each sub-chunk's sum, then its rows, from la_C down
        part = [tot[I * sub:(I + 1) * sub].sum(0) for I in range(nsub)]
        dlw = torch.empty_like(tot)
        for I in range(nsub):
            run = (dSC * states[c + 1]).sum(1) + sum(part[I + 1:], torch.zeros(K))
            for s_ in reversed(range(I * sub, (I + 1) * sub)):
                run = run + tot[s_]
                dlw[s_] = run - dlp[s_]
        sl = slice(c * C, c * C + n)
        dr[sl] = (x + g[:, None] * u * ks)[:n]
        dk[sl] = (y + g[:, None] * u * rs)[:n]
        dv[sl] = (dvo + dvd)[:n]
        dw[sl] = torch.where(w[sl] >= 1e-38, dlw[:n] / w[sl], 0.0)
        du += (g[:, None] * rs * ks).sum(0)
    return dr, dk, dv, dw, du, published[0], exps


def test_wkv6_bwd_tickets_reach_a_started_chunk():
    """Reverse chunk-major tickets: the block of chunk c + 1 of the same
    (b, h), which a block of chunk c waits on, drew an earlier ticket."""
    for nc, BH in ((1, 3), (16, 128), (3, 5)):
        order = wkv6_bwd_tickets(nc, BH)
        seen = {x: i for i, x in enumerate(order)}
        assert sorted(order) == sorted((c, bh) for c in range(nc) for bh in range(BH))
        assert all(seen[(c + 1, bh)] < i for i, (c, bh) in enumerate(order) if c + 1 < nc)


def _wkv6_bwd_inputs(S, K, V, seed, decay):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    r, k = f(S, K), f(S, K)
    v, dy = f(S, V), f(S, V)
    w = torch.exp(-torch.exp(f(S, K) - 1))
    if decay == "extreme":  # decay 1e-30 (la falls by 69 a step) mixed with 0.9
        w = torch.full((S, K), 1e-30, dtype=torch.float64)
        w[::3] = 0.9
    return r, k, v, w, f(K), f(K, V), dy, f(K, V)


def _wkv6_f64_grads(r, k, v, w, u, s0, dy, dsf):
    """Autograd of the recurrence itself, step by step, in f64."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True) for t in (r, k, v, w, u, s0))
        r_, k_, v_, w_, u_, s = ins
        ys = []
        for t in range(r.shape[0]):
            kv = k_[t][:, None] * v_[t][None, :]
            ys.append(r_[t] @ (s + u_[:, None] * kv))
            s = w_[t][:, None] * s + kv
        return torch.autograd.grad((torch.stack(ys), s), ins, (dy, dsf))


def _wkv6_bwd_check(S, K, V, decay, want_fn, rel):
    r, k, v, w, u, s0, dy, dsf = _wkv6_bwd_inputs(S, K, V, S, decay)
    *got, exps = _wkv6_bwd_model(r, k, v, w, u, s0, dy, dsf)
    want = list(want_fn(r, k, v, w, u, s0, dy, dsf))
    if decay == "extreme":  # dw = dlw / w: at w = 1e-30 that is rounding noise times 1e30
        got[3], want[3] = got[3] * w, want[3] * w
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0,
                                   atol=rel * max(1.0, float(b.abs().max())))
    return exps


def _plain_bwd(r, k, v, w, u, s0, dy, dsf):
    want = ref.wkv6_bwd_ref(*(t[None, :, None] for t in (r, k, v, w)), u[None], s0[None, None],
                            dy[None, :, None], dsf[None, None])
    return (want[0][0, :, 0], want[1][0, :, 0], want[2][0, :, 0], want[3][0, :, 0], want[4][0],
            want[5][0, 0])


@pytest.mark.parametrize("S", [1, 64, 150])
def test_wkv6_bwd_passes_match_autograd(S):
    """Against autograd of the plain version (f32): 1e-5 of the largest."""
    _wkv6_bwd_check(S, 8, 6, "model", _plain_bwd, 1e-5)


@pytest.mark.parametrize("S,K,V,decay", [
    (1, 8, 6, "model"), (64, 8, 6, "model"), (150, 8, 6, "model"), (63, 8, 8, "model"),
    (65, 4, 8, "model"), (200, 8, 4, "model"), (100, 8, 6, "extreme"), (130, 4, 6, "extreme"),
])
def test_wkv6_bwd_model_matches_the_f64_recurrence(S, K, V, decay):
    """Against autograd of the recurrence step by step in f64, where the
    plain version's f32 rounding would hide an error: 1e-9 of the largest
    (decay 1e-30 mixed with 0.9: every factor of the pivot split stays <=
    1, so every gradient is finite); and the exps a chunk takes, 4 x 144 x
    K (each sub-chunk: its 8 x 8 diagonal blocks' 56 pairs twice, for att
    and for dr's and dk's sums together, and the 16 decays to its middle
    twice), against the first design's 3 x 2016 x K (every pair of the
    chunk, three times)."""
    exps = _wkv6_bwd_check(S, K, V, decay, _wkv6_f64_grads, 1e-9)
    assert exps == [4 * 144 * K] * -(-S // 64)
    assert 4 * 144 < 3 * 64 * 63 // 2


# ---------------------------------------------------------------------------
# kernels 16j and 16bj: the tangents' warp tensor-core route
# ---------------------------------------------------------------------------

JVP = (CSRC / "flash_attention_jvp.cu").read_text()
# csrc/flash_attention_jvp.cu jm::kRows, kKeys, kStep, kWarpCols
JVP_ROWS, JVP_KEYS, JVP_STEP, JVP_WARP_COLS = 64, 64, 32, 128
JVP_WARP_ROWS = 16


def test_jvp_model_constants_match_the_kernel():
    """The tiles the models below walk are the kernel's own, and the
    wrapper splits the key grid by its key tile."""
    jm = JVP[JVP.index("namespace jm {"):]
    assert (_bwd_const(jm, "kRows"), _bwd_const(jm, "kKeys"), _bwd_const(jm, "kStep"),
            _bwd_const(jm, "kWarpCols")) == (JVP_ROWS, JVP_KEYS, JVP_STEP, JVP_WARP_COLS)
    assert FA.JVP_KEY_TILE == JVP_KEYS


def _visible(Sq, Sk, q_offset, window):
    qp = torch.arange(q_offset, q_offset + Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = kp <= qp
    return ok & (kp > qp - window) if window else ok


def _block_keys(q0, Sq, Sk, q_offset, window, step):
    """``key_range``: the keys a block of rows from q0 can see, [begin, end),
    begin a multiple of ``step``."""
    hi = q_offset + min(q0 + JVP_ROWS, Sq) - 1
    begin = max(0, q_offset + q0 - window + 1) if window else 0
    return begin // step * step, min(Sk, hi + 1)


def _warps(q0, Sq):
    """A block's warps' rows that exist: (first row, slice)."""
    return [(w0, slice(w0, min(w0 + JVP_WARP_ROWS, Sq)))
            for w0 in range(q0, min(q0 + JVP_ROWS, Sq), JVP_WARP_ROWS)]


def _rounder(bf16):
    return (lambda x: x.to(torch.bfloat16).to(x.dtype)) if bf16 else (lambda x: x)


def _flash_jvp_model(q, k, v, lse, qt, kt, vt, q_offset, window, bf16, pairs=True):
    """16j's tensor-core route (``jm::fwd_kernel``) in plain tensors: blocks
    of 64 query rows, a warp's 16 rows stepping over the block's visible
    keys 32 at a time (skipping a step none of them sees); S, S', P = exp(S s
    - lse), E = P S' s; lse' the sum of E; o += P v, o'acc += E v + P v'
    with P and E each carried as a pair of bf16, hi + lo, in two products
    (``bf16``; rounded once instead unless ``pairs``).  In f32 (the
    kernel's accumulators), f64 for f64 inputs.  Returns (o', lse', visits
    of head 0, visible mask)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    G, s = H // Hkv, 1.0 / math.sqrt(hd)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    rnd = _rounder(bf16)
    parts = (lambda x: (rnd(x), rnd(x - rnd(x)))) if pairs else (lambda x: (rnd(x),))
    q, k, v, qt, kt, vt, lse = (x.to(f) for x in (q, k, v, qt, kt, vt, lse))
    ok = _visible(Sq, Sk, q_offset, window)
    ot, lse_t = torch.zeros(B, Sq, H, vd, dtype=f), torch.zeros(B, H, Sq, dtype=f)
    visits = torch.zeros(Sq, Sk, dtype=torch.int64)
    for b in range(B):
        for h in range(H):
            hk = h // G
            for q0 in range(0, Sq, JVP_ROWS):
                k_begin, k_end = _block_keys(q0, Sq, Sk, q_offset, window, JVP_STEP)
                for w0, rows in _warps(q0, Sq):
                    lo, hi = q_offset + w0, q_offset + rows.stop - 1
                    n = rows.stop - rows.start
                    o, oacc, lt = (torch.zeros(n, vd, dtype=f), torch.zeros(n, vd, dtype=f),
                                   torch.zeros(n, dtype=f))
                    for kt0 in range(k_begin, k_end, JVP_STEP):
                        if kt0 > hi or window and kt0 + JVP_STEP - 1 <= lo - window:
                            continue
                        ks = slice(kt0, min(kt0 + JVP_STEP, Sk))
                        m = ok[rows, ks]
                        sc = q[b, rows, h] @ k[b, ks, hk].T
                        st = qt[b, rows, h] @ k[b, ks, hk].T + q[b, rows, h] @ kt[b, ks, hk].T
                        p = torch.where(m, torch.exp(sc * s - lse[b, h, rows, None]), 0.0)
                        e = p * (st * s)
                        lt += e.sum(-1)
                        for part in parts(p):
                            o += part @ v[b, ks, hk]
                            oacc += part @ vt[b, ks, hk]
                        for part in parts(e):
                            oacc += part @ v[b, ks, hk]
                        if b == 0 and h == 0:
                            visits[rows, ks] += m.long()
                    ot[b, rows, h] = oacc - lt[:, None] * o
                    lse_t[b, h, rows] = lt
    return ot, lse_t, visits, ok


def _flash_bwd_jvp_model(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_offset, window, bf16,
                         splits=1):
    """16bj's tensor-core route (``jm::rows_kernel``, ``jm::keys_kernel``) in
    plain tensors.  The row grid: blocks of 64 rows, a warp's 16 rows
    stepping over the block's keys 32 at a time; at hd <= 128 one sweep
    accumulating X = sum F k + dS k' and Y = sum dS k beside lse' = sum E
    (E = P S' s, F = E (dP - D) + P (dP' - D')), dq' = s (X - lse' Y); beyond,
    a sweep for lse' and a second for dS' = P' (dP - D) + P (dP' - D') into X
    = sum dS' k + dS k', dq' = s X; dS and F (dS') rounded.  The key grid:
    blocks of 64 keys and ``splits`` shares of each kv head's query heads, a
    warp's 16 keys stepping over the query tiles of 32 rows that see the
    block's keys; dv' += P'^T do + P^T do', dk' += dS'^T q + dS^T q' with
    P, P', dS, dS' rounded; the shares' partials added in split order.
    Returns (dq', dk', dv', row-grid visits, key-grid visits of head 0,
    visible mask)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    G, s = H // Hkv, 1.0 / math.sqrt(hd)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    rnd = _rounder(bf16)
    q, k, v, o, do, qt, kt, vt, ot, dot, lse = (
        x.to(f) for x in (q, k, v, o, do, qt, kt, vt, ot, dot, lse))
    ok = _visible(Sq, Sk, q_offset, window)
    one = hd <= JVP_WARP_COLS
    D = torch.einsum("bqhv,bqhv->bhq", do, o)
    Dt = torch.einsum("bqhv,bqhv->bhq", dot, o) + torch.einsum("bqhv,bqhv->bhq", do, ot)
    lse_t = torch.zeros(B, H, Sq, dtype=f)
    dq_t = torch.zeros(B, Sq, H, hd, dtype=f)
    visits = torch.zeros(2, Sq, Sk, dtype=torch.int64)

    def tiles(b, h, rows, ks, lt):
        """P, E (or P' given lse' ``lt``), dP and dP' of rows against keys."""
        hk = h // G
        m = ok[rows, ks]
        sc = q[b, rows, h] @ k[b, ks, hk].T
        s1 = (qt[b, rows, h] @ k[b, ks, hk].T + q[b, rows, h] @ kt[b, ks, hk].T) * s
        p = torch.where(m, torch.exp(sc * s - lse[b, h, rows, None]), 0.0)
        e = p * s1 if lt is None else p * (s1 - lt[:, None])
        dp = do[b, rows, h] @ v[b, ks, hk].T
        dpt = dot[b, rows, h] @ v[b, ks, hk].T + do[b, rows, h] @ vt[b, ks, hk].T
        return m, p, e, dp, dpt

    for b in range(B):
        for h in range(H):
            hk = h // G
            for q0 in range(0, Sq, JVP_ROWS):
                k_begin, k_end = _block_keys(q0, Sq, Sk, q_offset, window, JVP_STEP)
                for w0, rows in _warps(q0, Sq):
                    lo, hi = q_offset + w0, q_offset + rows.stop - 1
                    steps = [slice(kt0, min(kt0 + JVP_STEP, Sk))
                             for kt0 in range(k_begin, k_end, JVP_STEP)
                             if not (kt0 > hi or window and kt0 + JVP_STEP - 1 <= lo - window)]
                    n = rows.stop - rows.start
                    X, Y, lt = (torch.zeros(n, hd, dtype=f), torch.zeros(n, hd, dtype=f),
                                torch.zeros(n, dtype=f))
                    if not one:  # the first sweep: lse' alone
                        for ks in steps:
                            lt += tiles(b, h, rows, ks, None)[2].sum(-1)
                    for ks in steps:
                        m, p, e, dp, dpt = tiles(b, h, rows, ks, None if one else lt)
                        if one:
                            lt += e.sum(-1)
                        x = dp - D[b, h, rows, None]
                        ds = rnd(p * x)
                        fx = rnd(e * x + p * (dpt - Dt[b, h, rows, None]))
                        X += fx @ k[b, ks, hk] + ds @ kt[b, ks, hk]
                        Y += ds @ k[b, ks, hk]
                        if b == 0 and h == 0:
                            visits[0, rows, ks] += m.long()
                    dq_t[b, rows, h] = s * (X - lt[:, None] * Y if one else X)
                    lse_t[b, h, rows] = lt
    parts = torch.zeros(splits, 2, B, Sk, Hkv, max(hd, vd), dtype=f)
    gps = -(-G // splits)
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Sk, JVP_KEYS):
                k_last = min(k0 + JVP_KEYS, Sk) - 1
                i_begin = max(0, k0 - q_offset) // JVP_STEP * JVP_STEP
                i_end = min(Sq, k_last + window - q_offset) if window else Sq
                for z in range(splits):
                    for g in range(z * gps, min(G, z * gps + gps)):
                        h = hk * G + g
                        for q0 in range(i_begin, i_end, JVP_STEP):
                            qp0 = q_offset + q0
                            rows = slice(q0, min(q0 + JVP_STEP, Sq))
                            for kw0 in range(k0, k0 + JVP_KEYS, JVP_WARP_ROWS):
                                if kw0 >= Sk or qp0 + JVP_STEP - 1 < kw0 or (
                                        window and kw0 + 15 <= qp0 - window):
                                    continue
                                ks = slice(kw0, min(kw0 + JVP_WARP_ROWS, Sk))
                                m, p, pt, dp, dpt = tiles(b, h, rows, ks, lse_t[b, h, rows])
                                x = dp - D[b, h, rows, None]
                                ds, dst = p * x, pt * x + p * (dpt - Dt[b, h, rows, None])
                                parts[z, 0, b, ks, hk, :vd] += (
                                    rnd(pt).T @ do[b, rows, h] + rnd(p).T @ dot[b, rows, h])
                                parts[z, 1, b, ks, hk, :hd] += (
                                    rnd(dst).T @ q[b, rows, h] + rnd(ds).T @ qt[b, rows, h])
                                if b == 0 and h == 0:
                                    visits[1, rows, ks] += m.long()
    total = parts[0]
    for z in range(1, splits):
        total = total + parts[z]
    return (dq_t, s * total[1, ..., :hd], total[0, ..., :vd], visits[0], visits[1], ok)


# The four head dims of chip_smoke.py's FLASH_JVP_CASES with short, ragged
# sequences (B, Sq, H, Hkv, hd, vd, window, q_offset, splits): olmo-1b's
# 128 (one sweep), MLA's 192 / 128 and stablelm's 160 with GQA (two sweeps),
# recurrentgemma's 256 on one kv head with a window below the sequence and
# its query heads split across key blocks; a query offset
JVP_MODEL_CASES = [
    (1, 100, 2, 2, 128, 128, None, 0, 1),
    (1, 77, 2, 2, 192, 128, None, 0, 1),
    (1, 130, 4, 1, 256, 256, 40, 0, 3),
    (1, 70, 4, 2, 160, 160, None, 23, 2),
]


def _jvp_inputs(case, dtype):
    B, Sq, H, Hkv, hd, vd, window, off, _ = case
    Sk = Sq + off
    rng = np.random.default_rng(sum(case[:6]))

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    q, qt = t(B, Sq, H, hd), t(B, Sq, H, hd)
    k, kt = t(B, Sk, Hkv, hd), t(B, Sk, Hkv, hd)
    v, vt = t(B, Sk, Hkv, vd), t(B, Sk, Hkv, vd)
    do, dot, ot = t(B, Sq, H, vd), t(B, Sq, H, vd), t(B, Sq, H, vd)
    q_pos, k_pos = torch.arange(off, off + Sq), torch.arange(Sk)
    o = ref.flash_attention_ref(q, k, v, q_pos, k_pos, window=window)
    lse = ref.flash_attention_lse_ref(q, k, q_pos, k_pos, window=window).to(
        torch.float64 if dtype == torch.float64 else torch.float32)
    return (q, k, v, o, lse, do, qt, kt, vt, ot, dot), (q_pos, k_pos, window, off)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("case", JVP_MODEL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_jvp_tile_algebra_is_exact(case):
    """Unrounded and in f64, the models' tile walks and algebra (16bj's one
    sweep, X - lse' Y, and its two; the key grid's split partials) equal
    the plain versions within 1e-5 of the largest value (the plain versions
    run in f32), and both grids of each visit every visible pair of a head
    exactly once."""
    (q, k, v, o, lse, do, qt, kt, vt, ot, dot), (q_pos, k_pos, window, off) = _jvp_inputs(
        case, torch.float64)
    got_o, got_l, visits, ok = _flash_jvp_model(q, k, v, lse, qt, kt, vt, off, window, False)
    assert torch.equal(visits, ok.long())
    want_o, want_l = ref.flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, q_pos, k_pos,
                                                 window=window)
    assert _rel(got_o, want_o) <= 1e-5 and _rel(got_l, want_l) <= 1e-5
    *got, rv, kv, ok = _flash_bwd_jvp_model(q, k, v, o, lse, do, qt, kt, vt, ot, dot, off, window,
                                            False, splits=case[-1])
    assert torch.equal(rv, ok.long()) and torch.equal(kv, ok.long())
    want = ref.flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_pos, k_pos,
                                           window=window)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("case", JVP_MODEL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_jvp_model_rounds_where_the_kernel_does(case):
    """bf16 operands with dS, F (dS'), P' and the key grid's P rounded to
    bf16 and 16j's P and E carried as hi + lo, where the kernels do so: o'
    within 2^-7, lse' 1e-4 (summed unrounded), dq', dk', dv' within 2^-6 of
    the plain versions -- the card's tolerances
    (``chip_smoke.py`` ``JVP_BF16_REL``, ``BWD_JVP_BF16_REL``) -- and the
    rounding moves the result (the model is not the plain version under
    another name)."""
    ins, (q_pos, k_pos, window, off) = _jvp_inputs(case, torch.bfloat16)
    q, k, v, o, lse, do, qt, kt, vt, ot, dot = ins
    want_o, want_l = ref.flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, q_pos, k_pos,
                                                 window=window)
    got_o, got_l = _flash_jvp_model(q, k, v, lse, qt, kt, vt, off, window, True)[:2]
    exact_o = _flash_jvp_model(q, k, v, lse, qt, kt, vt, off, window, False)[0]
    once_o = _flash_jvp_model(q, k, v, lse, qt, kt, vt, off, window, True, pairs=False)[0]
    assert _rel(got_o.bfloat16(), want_o) <= 2.0 ** -7 and _rel(got_l, want_l) <= 1e-4
    assert _rel(got_o, exact_o) > 0
    # P and E rounded once each: o' = o'acc - lse' o, two terms that cancel,
    # moves at least twice as far (four times at these cases)
    assert 2 * _rel(got_o.bfloat16(), want_o) <= _rel(once_o.bfloat16(), want_o)
    want = ref.flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_pos, k_pos,
                                           window=window)
    got = _flash_bwd_jvp_model(q, k, v, o, lse, do, qt, kt, vt, ot, dot, off, window, True,
                               splits=case[-1])[:3]
    exact = _flash_bwd_jvp_model(q, k, v, o, lse, do, qt, kt, vt, ot, dot, off, window, False,
                                 splits=case[-1])[:3]
    for a, b, c in zip(got, want, exact):
        assert _rel(a.bfloat16(), b) <= 2.0 ** -6
        assert _rel(a, c) > 0


@pytest.mark.parametrize("dtype,hd,vd,want", [
    (torch.bfloat16, 128, 128, "mma"), (torch.bfloat16, 192, 128, "mma"),
    (torch.bfloat16, 256, 256, "mma"), (torch.bfloat16, 160, 160, "mma"),
    (torch.bfloat16, 64, 128, "mma"), (torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, 72, 128, "cuda_cores"), (torch.bfloat16, 128, 136, "cuda_cores"),
    (torch.bfloat16, 100, 100, "cuda_cores"), (torch.float32, 128, 128, "cuda_cores"),
    (torch.float32, 256, 256, "cuda_cores"), (torch.float32, 192, 128, "cuda_cores"),
])
def test_jvp_route_by_dtype_and_head_dims(dtype, hd, vd, want):
    """16j's and 16bj's route: the warp tensor cores for bf16 with hd and vd
    multiples of 16, the CUDA cores for f32 and other dims."""
    assert FA.jvp_route(dtype, hd, vd) == want


def test_jvp_key_grid_splits_fill_the_card():
    """The splits the wrapper gives 16bj's key grid at the four shapes of
    ``chip_smoke.py``'s ``FLASH_JVP_CASES`` (B 8, 128 tokens) on 132 SMs:
    recurrentgemma's one kv head, 16 blocks of 64 keys, splits its 16
    query heads 16 ways, stablelm's 128 blocks its 4 two ways, and olmo-1b's
    and MLA's 256 blocks fill the card unsplit."""
    assert FA.dkdv_splits(8, 128, 1, 16, 132, FA.JVP_KEY_TILE) == 16
    assert FA.dkdv_splits(8, 128, 8, 4, 132, FA.JVP_KEY_TILE) == 2
    assert FA.dkdv_splits(8, 128, 16, 1, 132, FA.JVP_KEY_TILE) == 1


# ---------------------------------------------------------------------------
# kernels 17j and 17bj: the RWKV-6 recurrence's tangents
# ---------------------------------------------------------------------------

WKV_JVP = (CSRC / "wkv6_jvp.cu").read_text()
WKV_JVP_THREADS, WKV_JVP_ITEMS = 256, 16   # csrc/wkv6_jvp.cu kThreads, kItems
H100_SMEM_OPTIN = 227 * 1024               # the most dynamic shared memory a block may ask


def test_wkv6_tangent_model_constants_match_the_kernel():
    """The chunk and the largest K and V the model below walks are the
    kernel's and the wrappers'; each thread's items cover a (64, 64) tile
    once; and the shared memory each of the three chunk kernels asks for
    (whole (64, 64) f32 tiles and 64-float rows) fits an H100 block."""
    assert (_bwd_const(WKV_JVP, "kC"), _bwd_const(WKV_JVP, "kD")) == (WK.CHUNK, WK.MAX_DIM)
    assert _bwd_const(WKV_JVP, "kThreads") == WKV_JVP_THREADS
    assert WKV_JVP_THREADS // WK.MAX_DIM * WKV_JVP_ITEMS == WK.CHUNK
    sizes = re.findall(r"sizeof\(float\) \* \(\(size_t\)(\(kOut \? 12 : 6\)|\d+) \* kTile \+ "
                       r"(\d+) \* kD\) \+ 16", WKV_JVP)
    assert len(sizes) == 3, sizes
    for tiles, rows in sizes:
        n = 12 if tiles.startswith("(") else int(tiles)
        assert 4 * (n * WK.CHUNK * WK.MAX_DIM + int(rows) * WK.MAX_DIM) + 16 <= H100_SMEM_OPTIN


def wkv6_jvp_tickets(nc, BH):
    """(chunk, b * H + h) of each ticket in the order 17j's blocks (and
    17bj's state pass) draw them: chunk-major."""
    return [(t // BH, t % BH) for t in range(nc * BH)]


def test_wkv6_jvp_tickets_reach_a_started_chunk():
    """Chunk-major tickets: the block of chunk c - 1 of the same (b, h),
    which a block of chunk c waits on, drew an earlier ticket."""
    for nc, BH in ((1, 3), (16, 128), (3, 5)):
        order = wkv6_jvp_tickets(nc, BH)
        seen = {x: i for i, x in enumerate(order)}
        assert sorted(order) == sorted((c, bh) for c in range(nc) for bh in range(BH))
        assert all(seen[(c - 1, bh)] < i for i, (c, bh) in enumerate(order) if c > 0)


def _wkv6_chunk_view(c, n, C, *xs):
    """Rows c C .. c C + n - 1 of each (S, .) tensor, zero-padded to C rows."""
    return [torch.cat([x[c * C:c * C + n], x.new_zeros(C - n, x.shape[1])]) for x in xs]


def _wkv6_tangent_model(r, k, v, w, u, s0, dy, dsf, rt, kt, vt, wt, ut, s0t, dyt, dsft, C=64):
    """``csrc/wkv6_jvp.cu`` for one (b, h), in the inputs' dtype: r, k, w
    (S, K), v, dy (S, V), u (K,), s0, ds_final (K, V) and their tangents.
    17j: the chunks in ticket order (chunk-major), each forming la, la' and
    la_prev, la'_prev down its columns, att and att' of every pair with the
    direct clamped exp and its tangent E (la'_prev_t - la'_tau), the bonus
    on the diagonal, its own part of S'_C, then S' from the chunk before
    (published), S'_C published for the next, and y' from S and S'.  17bj:
    (a) that state pass, (b) the reverse walk carrying (dS, dS'), (c) every
    output of a chunk from the states at its two ends, (d) du' summed over
    the chunks in order.  Returns (y', S_final') and (dr', dk', dv', dw',
    du', ds0')."""
    S, K = r.shape
    V = v.shape[1]
    nc = -(-S // C)
    states, s = [], s0.clone()  # the forward's (kernel 17's) states entering each chunk
    for c in range(nc):
        states.append(s.clone())
        for t in range(c * C, min(S, (c + 1) * C)):
            s = w[t][:, None] * s + k[t][:, None] * v[t][None, :]
    states.append(s)
    strict = torch.tril(torch.ones(C, C, dtype=torch.bool), -1)
    eye = torch.eye(C, dtype=torch.bool)

    def chunk(c):
        n = min(C, S - c * C)
        rs, ks, vs, rts, kts, vts, dys, dyts = _wkv6_chunk_view(
            c, n, C, r, k, v, rt, kt, vt, dy, dyt)
        ws, wts = _wkv6_chunk_view(c, n, C, w, wt)
        ws = ws + (torch.arange(C) >= n)[:, None]  # w = 1 past the chunk: lw = lw' = 0
        lw = torch.log(torch.clamp(ws, min=1e-38))
        lwt = torch.where(ws >= 1e-38, wts / ws, 0.0)
        la, lat = torch.cumsum(lw, 0), torch.cumsum(lwt, 0)
        lp, lpt = la - lw, lat - lwt
        d = lp[:, None] - la[None]  # (t, tau, k)
        E = torch.exp(torch.clamp(d, max=0.0))
        Et = torch.where(d <= 0, lpt[:, None] - lat[None], 0.0) * E
        return dict(n=n, r=rs, k=ks, v=vs, rt=rts, kt=kts, vt=vts, dy=dys, dyt=dyts, w=ws,
                    wt=wts, la=la, lat=lat, lp=lp, lpt=lpt, E=E, Et=Et)

    def att_pair(x):  # att, att' of every pair, the bonus and its tangent on the diagonal
        rs, ks, rts, kts = x["r"], x["k"], x["rt"], x["kt"]
        att = torch.einsum("tk,sk,tsk->ts", rs, ks, x["E"])
        att_t = (torch.einsum("tk,sk,tsk->ts", rts, ks, x["E"])
                 + torch.einsum("tk,sk,tsk->ts", rs, kts, x["E"])
                 + torch.einsum("tk,sk,tsk->ts", rs, ks, x["Et"]))
        b, bt = (rs * u * ks).sum(1), (rts * u * ks + rs * ut * ks + rs * u * kts).sum(1)
        att = torch.where(strict, att, 0.0) + torch.diag(b)
        att_t = torch.where(strict, att_t, 0.0) + torch.diag(bt)
        return att, att_t, b, bt

    def k_to_end(x):  # k e^{la_C - la} and its tangent
        ec = torch.exp(x["la"][-1] - x["la"])
        return x["k"] * ec, (x["kt"] + x["k"] * (x["lat"][-1] - x["lat"])) * ec

    # 17j, and 17bj's pass (a): S' at every chunk entry, published in ticket order
    tstates, yt = {0: s0t.clone()}, torch.zeros_like(v)
    for c, _ in wkv6_jvp_tickets(nc, 1):
        x = chunk(c)
        kd, kdt = k_to_end(x)
        own = kdt.T @ x["v"] + kd.T @ x["vt"]
        assert c in tstates  # the awaited chunk has published
        Sc, Sct = states[c], tstates[c]
        tstates[c + 1] = torch.exp(x["la"][-1])[:, None] * (x["lat"][-1][:, None] * Sc + Sct) + own
        ep = torch.exp(x["lp"])
        rd, rdt = x["r"] * ep, (x["rt"] + x["r"] * x["lpt"]) * ep
        att, att_t, _, _ = att_pair(x)
        y = rdt @ Sc + rd @ Sct + att_t @ x["v"] + att @ x["vt"]
        yt[c * C:c * C + x["n"]] = y[:x["n"]]
    jvp_out = (yt, tstates[nc])

    # 17bj (b): the pair (dS, dS') at each chunk's end, in reverse ticket order
    dstates = {nc: (dsf.clone(), dsft.clone())}
    for c, _ in wkv6_bwd_tickets(nc, 1):
        x = chunk(c)
        ep = torch.exp(x["lp"])
        rd, rdt = x["r"] * ep, (x["rt"] + x["r"] * x["lpt"]) * ep
        xa, xt = rd.T @ x["dy"], rdt.T @ x["dy"] + rd.T @ x["dyt"]
        assert c + 1 in dstates
        g, gt = dstates[c + 1]
        ec = torch.exp(x["la"][-1])[:, None]
        dstates[c] = (ec * g + xa, ec * (x["lat"][-1][:, None] * g + gt) + xt)

    # 17bj (c): every output of a chunk; (d) du' over the chunks in order
    drt, dkt, dvt, dwt = (torch.zeros_like(t) for t in (r, k, v, w))
    du_part = []
    for c in range(nc):
        x = chunk(c)
        n = x["n"]
        rs, ks, vs, rts, kts, vts, dys, dyts = (x[a] for a in ("r", "k", "v", "rt", "kt", "vt",
                                                               "dy", "dyt"))
        E, Et, lp, lpt = x["E"], x["Et"], x["lp"], x["lpt"]
        g, gt = (dys * vs).sum(1), (dyts * vs + dys * vts).sum(1)
        datt = torch.where(strict, dys @ vs.T, 0.0)
        datt_t = torch.where(strict, dyts @ vs.T + dys @ vts.T, 0.0)
        xr = torch.einsum("ts,sk,tsk->tk", datt, ks, E)
        xrt = (torch.einsum("ts,sk,tsk->tk", datt_t, ks, E)
               + torch.einsum("ts,sk,tsk->tk", datt, kts, E)
               + torch.einsum("ts,sk,tsk->tk", datt, ks, Et))
        yk = torch.einsum("ts,tk,tsk->sk", datt, rs, E)
        ykt = (torch.einsum("ts,tk,tsk->sk", datt_t, rs, E)
               + torch.einsum("ts,tk,tsk->sk", datt, rts, E)
               + torch.einsum("ts,tk,tsk->sk", datt, rs, Et))
        att, att_t, _, _ = att_pair(x)
        dS, dSt = dstates[c + 1]
        kd, kdt = k_to_end(x)
        S_C, S_Ct = states[c + 1], tstates[c + 1]
        dlc, dlct = (dS * S_C).sum(1), (dSt * S_C + dS * S_Ct).sum(1)
        tri = strict | eye  # t >= tau
        dv_t = (torch.where(tri, att_t, 0.0).T @ dys + torch.where(tri, att, 0.0).T @ dyts
                + kd @ dSt + kdt @ dS)
        ec = torch.exp(x["la"][-1] - x["la"])
        lt = x["lat"][-1] - x["lat"]
        bm, bmt = vs @ dS.T, vts @ dS.T + vs @ dSt.T
        ykt, yk = ykt + ec * (lt * bm + bmt), yk + ec * bm
        Sc, Sct = states[c], tstates[c]
        a, at = dys @ Sc.T, dys @ Sct.T + dyts @ Sc.T
        ep = torch.exp(lp)
        xrt, xr = xrt + ep * (lpt * a + at), xr + ep * a
        dr_t = xrt + gt[:, None] * u * ks + g[:, None] * ut * ks + g[:, None] * u * kts
        dk_t = ykt + gt[:, None] * u * rs + g[:, None] * ut * rs + g[:, None] * u * rts
        dlp, dlpt = rs * xr, rts * xr + rs * xrt
        dla, dlat = -ks * yk, -(kts * yk + ks * ykt)
        dlw, dlwt = torch.empty_like(dla), torch.empty_like(dla)
        run, runt = dlc.clone(), dlct.clone()
        for s_ in reversed(range(C)):  # down each column from la_C's gradient
            run, runt = run + dla[s_] + dlp[s_], runt + dlat[s_] + dlpt[s_]
            dlw[s_], dlwt[s_] = run - dlp[s_], runt - dlpt[s_]
        ws, wts = x["w"], x["wt"]
        dw_t = torch.where(ws >= 1e-38, (dlwt - dlw * (wts / ws)) / ws, 0.0)
        sl = slice(c * C, c * C + n)
        drt[sl], dkt[sl], dvt[sl], dwt[sl] = dr_t[:n], dk_t[:n], dv_t[:n], dw_t[:n]
        du_part.append((gt[:, None] * rs * ks + g[:, None] * rts * ks
                        + g[:, None] * rs * kts).sum(0))
    dut = torch.zeros_like(u)
    for p in du_part:
        dut = dut + p
    return jvp_out, (drt, dkt, dvt, dwt, dut, dstates[0][1])


def _wkv6_f64_recurrence(r, k, v, w, u, s0):
    """The recurrence itself, step by step: (y, S_final)."""
    ys, s = [], s0
    for t in range(r.shape[0]):
        kv = k[t][:, None] * v[t][None, :]
        ys.append(r[t] @ (s + u[:, None] * kv))
        s = w[t][:, None] * s + kv
    return torch.stack(ys), s


def _wkv6_tangent_inputs(S, K, V, seed, decay):
    """f64 primals (``_wkv6_bwd_inputs``'; decay "slow": w = exp(-0.02
    exp(x)), so that a chunk's state and its tangent carry into the next,
    where the model's decay leaves e^{la_C} near 1e-11), the tangents with w'
    = w x' (the chain rule's form through the model's exp(-exp(.)))."""
    r, k, v, w, u, s0, dy, dsf = _wkv6_bwd_inputs(S, K, V, seed,
                                                  "model" if decay == "slow" else decay)
    if decay == "slow":
        w = torch.exp(0.02 * torch.log(w))
    g = torch.Generator().manual_seed(seed + 1)
    f = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    tangents = (f(S, K), f(S, K), f(S, V), w * f(S, K), f(K), f(K, V), f(S, V), f(K, V))
    return (r, k, v, w, u, s0, dy, dsf), tangents


@pytest.mark.parametrize("S,K,V,decay", [
    (1, 8, 6, "model"), (64, 8, 6, "model"), (150, 8, 6, "model"), (65, 4, 8, "model"),
    (150, 8, 6, "slow"), (130, 4, 8, "slow"), (100, 8, 6, "extreme"), (130, 4, 6, "extreme"),
])
def test_wkv6_tangent_model_matches_f64_forward_mode(S, K, V, decay):
    """17j's and 17bj's arithmetic (``_wkv6_tangent_model``) in f64 against
    forward-mode AD (``torch.func.jvp``) of the recurrence step by step and
    of its gradient (``torch.func.vjp``): 1e-9 of the largest value, and
    at decay 1e-30 mixed with 0.9 every output finite.  dw' is held as dw'
    w, the tangent in the log-decay's terms, dlw' - dlw w' / w: the chunk
    form's dw' = (dlw' - dlw w' / w) / w divides a difference of sums of
    size 1 by w, so where w is small its rounding is magnified by 1 / w
    (1e30 at decay 1e-30, and 1e11 at the w = 9.4e-12 that the model's
    exp(-exp(.)) draws at S = 1 here) in any order of sums."""
    primals, tangents = _wkv6_tangent_inputs(S, K, V, S + 7, decay)
    (yt, st), grads_t = _wkv6_tangent_model(*primals, *tangents)
    _, want_j = torch.func.jvp(_wkv6_f64_recurrence, primals[:6], tangents[:6])

    def grads(r, k, v, w, u, s0, dy, dsf):
        return torch.func.vjp(_wkv6_f64_recurrence, r, k, v, w, u, s0)[1]((dy, dsf))

    _, want_b = torch.func.jvp(grads, primals, tangents)
    got, want = [yt, st, *grads_t], [*want_j, *want_b]
    got[5], want[5] = got[5] * primals[3], want[5] * primals[3]
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9 * max(1.0, float(b.abs().max())))
