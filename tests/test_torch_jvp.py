"""Forward mode through the port's kernels (``kernels.ops``' jvp rules, the
curvature probe of ``--eta auto``) on the CPU, where each Function runs its
plain version, against the same transform over the plain ops; the fused MoE
dispatch's token gather under ``jvp``; and ``core.autotune.estimate_L`` on
reduced LMs against the reference's ``repro.core.autotune.estimate_L``.

Tolerances:
  * ``vmap(jvp(grad))`` through ``FlashAttention`` and its backward against
    the plain forward's, f32: 1e-5 of the largest magnitude (the rules'
    plain versions form P from lse and the tangents' sums in another order
    than ``torch.func`` does through the online softmax); bf16: 2^-6 of the
    largest magnitude (each side rounds o, o' and the gradients to bf16
    after f32 sums in other orders, as 16b's bf16 check holds them);
  * through ``LruScan``: bitwise (the rules' plain versions round in the
    order of torch's forward-mode formulas, and the backward in that of
    autograd's);
  * through ``Wkv6`` and its backward against ``ref.wkv6_ref``'s, f32:
    1e-5 of the largest magnitude (the rules' plain versions sum each
    tangent's terms in the chunk form, ``torch.func`` in the order of its
    formulas); bf16: 2^-6 (both round y, y' and the gradients to bf16 after
    f32 sums in other orders);
  * the same through ``FlashAttention`` and ``Wkv6`` against the
    reference's ``jax.vmap(jax.jvp(jax.grad))`` of its ``impl="xla"``
    flash and wkv6, f32: 1e-5;
  * the plain versions of the six tangents against ``torch.func.jvp`` of
    the plain forward and backward, f32: 1e-5 (flash, wkv6), bitwise
    (RG-LRU);
  * ``_DispatchGather``'s tangent: bitwise the gather of xt's tangent, and
    ``vmap(jvp(grad))`` through the fused MoE block within 1e-5 of the
    same with a plain gather (its backward adds in another order);
  * ``estimate_L`` against the reference's, 8 iterations from the same
    keyed weights and probe batch: rtol 5e-3.  Both sides run the same
    power iteration in f32 on Hessian-vector products that round
    differently (the reference's RG-LRU is a chunked associative scan, the
    port's sequential; XLA fuses and reorders the rest); after 8 iterations
    the two stood 7.2e-4 (olmo-1b), 3.9e-4 (deepseek-v2-lite-16b) and
    1.0e-3 (recurrentgemma-9b) apart, and at the launcher's 96 iterations
    within 1.1e-3 (recurrentgemma-9b: 6364 against 6357).

The reference's ``estimate_L`` is one jitted loop: compiling it takes most
of this file's time (10-30 s an arch on one CPU core, about 90 s in all).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import autotune as ref_autotune
from repro.data.synthetic import lm_batches as ref_lm_batches
from repro.kernels import ops as ref_ops
from repro.models import build as ref_build
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import autotune
from repro_torch.kernels import _args, ops, ref
from repro_torch.models import build
from repro_torch.models import moe as M

F32_REL = 1e-5
BF16_REL = 2.0 ** -6
L_RTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(1e-30, float(b.float().abs().max()))
        err = float((a.float() - b.float()).abs().max()) / scale
        assert err <= rel, (err, rel)


def _hvp(f, primals, tangents, in_dims):
    """``vmap(jvp(grad(f)))``: each client's gradient of ``f`` in all its
    arguments, differentiated forward along its tangents."""
    n = len(primals)

    def one(*args):
        return torch.func.jvp(torch.func.grad(f, argnums=tuple(range(n))), args[:n],
                              args[n:])[1]
    return torch.func.vmap(one, in_dims=in_dims + in_dims)(*primals, *tangents)


# (m, B, Sq, Sk, H, Hkv, hd, vd, window, q_offset): GQA 4:2 with vd != hd,
# a window and a query offset (every row sees a key); recurrentgemma-like
# one kv head; MHA with no window
FLASH_CASES = ((2, 2, 6, 9, 4, 2, 8, 6, 5, 3), (2, 1, 7, 7, 4, 1, 16, 16, 4, 0),
               (3, 1, 5, 5, 2, 2, 8, 8, None, 0))


def _flash_data(case, dtype, seed):
    m, B, Sq, Sk, H, Hkv, hd, vd, window, off = case
    rng = np.random.default_rng(seed)
    t = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype))
    primals = (t(m, B, Sq, H, hd), t(m, B, Sk, Hkv, hd), t(m, B, Sk, Hkv, vd))
    tangents = tuple(t(*p.shape) for p in primals)
    c = torch.from_numpy(rng.standard_normal((B, Sq, H, vd)).astype(np.float32))
    return primals, tangents, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=["gqa_window_offset", "one_kv_head", "mha"])
def test_flash_function_vmap_jvp_grad(case, dtype):
    """``vmap(jvp(grad))`` through ``FlashAttention`` (forward rule 16j's
    plain version, backward 16b's, whose rule is 16bj's) equals the same
    transform of the plain forward; k and v not vmapped too (the jvp
    Functions' vmap rules expand them)."""
    window, off = case[8], case[9]
    primals, tangents, c = _flash_data(case, dtype, 0)
    q_pos = off + torch.arange(case[2])
    k_pos = torch.arange(case[3])

    def f(q, k, v):
        o = ops.FlashAttention.apply(q, k, v, True, window, off, True)[0]
        return (o.float() ** 2 * c).sum()

    def f_plain(q, k, v):
        o = ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=True, window=window)
        return (o.float() ** 2 * c).sum()

    rel = F32_REL if dtype == torch.float32 else BF16_REL
    _close(_hvp(f, primals, tangents, (0, 0, 0)), _hvp(f_plain, primals, tangents, (0, 0, 0)),
           rel)
    shared = (primals[0], primals[1][0], primals[2][0])
    shared_t = (tangents[0], tangents[1][0], tangents[2][0])
    _close(_hvp(f, shared, shared_t, (0, None, None)),
           _hvp(f_plain, shared, shared_t, (0, None, None)), rel)


@pytest.mark.parametrize("case", FLASH_CASES, ids=["gqa_window_offset", "one_kv_head", "mha"])
def test_flash_function_vmap_jvp_grad_matches_reference(case):
    """``vmap(jvp(grad))`` through ``FlashAttention`` (the forward-mode rules'
    plain versions, 16j's and 16bj's) against the reference's
    ``jax.vmap(jax.jvp(jax.grad))`` of ``repro.kernels.ops.flash_attention(...,
    impl="xla")`` (the branch its probe differentiates) on the same
    numpy-seeded f32 inputs and loss: within ``F32_REL`` of the largest
    magnitude (XLA's online softmax against P formed from lse, f32 sums in
    other orders)."""
    window, off = case[8], case[9]
    primals, tangents, c = _flash_data(case, torch.float32, 3)
    q_pos, k_pos = off + np.arange(case[2]), np.arange(case[3])

    def f(q, k, v):
        o = ops.FlashAttention.apply(q, k, v, True, window, off, True)[0]
        return (o ** 2 * c).sum()

    got = _hvp(f, primals, tangents, (0, 0, 0))
    cj = jax.numpy.asarray(c.numpy())

    def f_ref(q, k, v):
        o = ref_ops.flash_attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                                    impl="xla")
        return (o ** 2 * cj).sum()

    def one(q, k, v, qt, kt, vt):
        return jax.jvp(jax.grad(f_ref, argnums=(0, 1, 2)), (q, k, v), (qt, kt, vt))[1]

    want = jax.vmap(one)(*(jax.numpy.asarray(t.numpy()) for t in primals + tangents))
    _close(got, tuple(torch.from_numpy(np.array(w)) for w in want), F32_REL)


def test_flash_tangent_plain_versions_are_jvp_of_the_plain_ops():
    """``ref.flash_attention_jvp_ref`` and ``flash_attention_bwd_jvp_ref`` (the
    formulas kernels 16j and 16bj compute) equal ``torch.func.jvp`` of the
    plain forward and of its vjp, lse' formed inside the backward's."""
    (q, k, v), (qt, kt, vt), _ = _flash_data(FLASH_CASES[0], torch.float32, 1)
    q, k, v, qt, kt, vt = (x[0] for x in (q, k, v, qt, kt, vt))
    window, off = FLASH_CASES[0][8], FLASH_CASES[0][9]
    q_pos, k_pos = off + torch.arange(q.shape[1]), torch.arange(k.shape[1])

    def fwd(q, k, v):
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=True, window=window)

    o, ot = torch.func.jvp(fwd, (q, k, v), (qt, kt, vt))
    lse = ref.flash_attention_lse_ref(q, k, q_pos, k_pos, causal=True, window=window)
    _, lse_t = torch.func.jvp(
        lambda q, k: ref.flash_attention_lse_ref(q, k, q_pos, k_pos, causal=True, window=window),
        (q, k), (qt, kt))
    got = ref.flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, q_pos, k_pos, window=window)
    _close(got, (ot, lse_t), F32_REL)
    rng = np.random.default_rng(2)
    do, dot = (torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
               for _ in range(2))

    def bwd(q, k, v, do):
        return torch.func.vjp(fwd, q, k, v)[1](do)

    _, want = torch.func.jvp(bwd, (q, k, v, do), (qt, kt, vt, dot))
    got = ref.flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot, q_pos, k_pos,
                                          window=window)
    _close(got, want, F32_REL)


def _lru_data(seed, m=3, B=2, S=11, D=5):
    rng = np.random.default_rng(seed)
    t = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (m, B, S, D)).astype(np.float32))
    primals = (a, t(m, B, S, D), t(m, B, D))
    tangents = tuple(t(*p.shape) for p in primals)
    return primals, tangents, t(B, S, D), t(B, D)


@pytest.mark.parametrize("h0_shared", [False, True], ids=["h0_per_client", "h0_shared"])
def test_lru_function_vmap_jvp_grad_is_bitwise(h0_shared):
    """``vmap(jvp(grad))`` through ``LruScan`` (rules ``lru_scan_jvp`` and,
    on its backward, ``lru_scan_bwd_jvp``, as plain versions) equals the
    same transform of ``ref.lru_ref`` bit for bit; h0 not vmapped too."""
    (a, b, h0), (at, bt, h0t), cy, ch = _lru_data(3)
    dims = (0, 0, None if h0_shared else 0)
    if h0_shared:
        h0, h0t = h0[0], h0t[0]

    def loss(fn):
        def f(a, b, h0):
            y, h = fn(a, b, h0)
            return (y ** 2 * cy).sum() + (h * ch).sum()
        return f

    got = _hvp(loss(lambda *x: ops.LruScan.apply(*x, True)), (a, b, h0), (at, bt, h0t), dims)
    want = _hvp(loss(ref.lru_ref), (a, b, h0), (at, bt, h0t), dims)
    for x, w in zip(got, want):
        assert x.shape == w.shape and torch.equal(x, w)


def test_lru_tangent_plain_versions_are_bitwise_jvp():
    """``ref.lru_jvp_ref`` and ``lru_bwd_jvp_ref`` (the order the CUDA
    kernels round in) equal ``torch.func.jvp`` of ``lru_ref`` and
    ``lru_bwd_ref`` bit for bit."""
    (a, b, h0), (at, bt, h0t), dy, dh = _lru_data(4, m=1)
    a, b, h0, at, bt, h0t = (x[0] for x in (a, b, h0, at, bt, h0t))
    (y, _), (yt, hlt) = torch.func.jvp(ref.lru_ref, (a, b, h0), (at, bt, h0t))
    got = ref.lru_jvp_ref(a, y, h0, at, bt, h0t)
    assert torch.equal(got[0], yt) and torch.equal(got[1], hlt)
    rng = np.random.default_rng(5)
    dyt, dht = (torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
                for x in (dy, dh))
    _, want = torch.func.jvp(ref.lru_bwd_ref, (a, y, h0, dy, dh), (at, yt, h0t, dyt, dht))
    got = ref.lru_bwd_jvp_ref(a, y, h0, dy, dh, at, yt, h0t, dyt, dht)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


# (m, B, S, H, K, V, u rows a client (0: u not vmapped, shared), s0 zero):
# u shared, one chunk; u one row a client over two chunks, the last ragged
# (70 = 64 + 6 steps); two rows of u a client with s0 = 0
WKV_CASES = ((2, 2, 9, 2, 4, 3, 0, False), (2, 1, 70, 2, 4, 4, 1, False),
             (3, 2, 12, 1, 4, 2, 2, True))
WKV_IDS = ["u_shared", "u_per_client_ragged", "u_rows_s0_zero"]


def _wkv_data(case, dtype, seed):
    """Primals and tangents of ``Wkv6`` for m clients, numpy-seeded: w =
    exp(-exp(x)) as the model forms it, and w' = w x' (the chain rule's
    form through it); the loss's weights on y and the final state."""
    m, B, S, H, K, V, n_u, s0_zero = case
    rng = np.random.default_rng(seed)
    t = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    x = 0.5 * t(m, B, S, H, K) - 1.0
    w = torch.exp(-torch.exp(x))
    u_shape = (H, K) if n_u == 0 else (m, H, K) if n_u == 1 else (m, n_u, H, K)
    u = 0.3 * t(*u_shape)
    s0 = torch.zeros(m, B, H, K, V) if s0_zero else 0.5 * t(m, B, H, K, V)
    primals = (t(m, B, S, H, K).to(dtype), t(m, B, S, H, K).to(dtype), t(m, B, S, H, V).to(dtype),
               w, u, s0)
    tangents = (t(m, B, S, H, K).to(dtype), t(m, B, S, H, K).to(dtype),
                t(m, B, S, H, V).to(dtype), w * t(*w.shape), 0.3 * t(*u.shape),
                0.5 * t(*s0.shape))
    return primals, tangents, t(B, S, H, V), t(B, H, K, V)


def _wkv_loss(fn, cy, cs):
    def f(r, k, v, w, u, s0):
        y, s = fn(r, k, v, w, u, s0)
        return (y.float() ** 2 * cy).sum() + (s * cs).sum()
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WKV_CASES, ids=WKV_IDS)
def test_wkv6_function_vmap_jvp_grad(case, dtype):
    """``vmap(jvp(grad))`` through ``Wkv6`` (forward rule 17j's plain
    version, backward 17b's, whose rule is 17bj's) equals the same
    transform of ``ref.wkv6_ref``: f32 within ``F32_REL`` of the largest
    magnitude (the rules' plain versions sum the tangents' terms in the
    chunk form, ``torch.func`` in the order of its formulas), bf16 within
    ``BF16_REL`` (each side rounds y, y' and the gradients to bf16 after
    f32 sums in other orders, as 17b's bf16 check holds them)."""
    primals, tangents, cy, cs = _wkv_data(case, dtype, 10)
    dims = (0, 0, 0, 0, None if case[6] == 0 else 0, 0)
    got = _hvp(_wkv_loss(lambda *a: ops.Wkv6.apply(*a)[:2], cy, cs), primals, tangents,
               dims)
    want = _hvp(_wkv_loss(ref.wkv6_ref, cy, cs), primals, tangents, dims)
    _close(got, want, F32_REL if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("case", WKV_CASES[:2], ids=WKV_IDS[:2])
def test_wkv6_function_vmap_jvp_grad_matches_reference(case):
    """``vmap(jvp(grad))`` through ``Wkv6`` against the reference's
    ``jax.vmap(jax.jvp(jax.grad))`` of ``repro.kernels.ops.wkv6(...,
    impl="xla")`` (``_wkv6_chunked_xla``, the branch its probe
    differentiates) on the same numpy-seeded f32 inputs and loss, at a
    length whose chunks both take (S a multiple of 64, or one chunk):
    within ``F32_REL`` of the largest magnitude (f32 sums in other
    orders)."""
    m, B, S, H, K, V, n_u, s0_zero = case
    S = 9 if S < 64 else 128
    primals, tangents, cy, cs = _wkv_data((m, B, S, H, K, V, n_u, s0_zero), torch.float32, 11)
    dims = (0, 0, 0, 0, None if n_u == 0 else 0, 0)
    got = _hvp(_wkv_loss(lambda *a: ops.Wkv6.apply(*a)[:2], cy, cs), primals, tangents,
               dims)
    cyj, csj = (jax.numpy.asarray(c.numpy()) for c in (cy, cs))

    def f_ref(*a):
        y, s = ref_ops.wkv6(*a, impl="xla")
        return (y ** 2 * cyj).sum() + (s * csj).sum()

    def one(*a):
        return jax.jvp(jax.grad(f_ref, argnums=tuple(range(6))), a[:6], a[6:])[1]

    want = jax.vmap(one, in_axes=dims + dims)(
        *(jax.numpy.asarray(t.numpy()) for t in primals + tangents))
    _close(got, tuple(torch.from_numpy(np.array(w)) for w in want), F32_REL)


@pytest.mark.parametrize("n_u, ds_final", [(1, True), (2, False)],
                         ids=["u_shared_ds_final", "u_rows_no_ds_final"])
def test_wkv6_tangent_plain_versions_are_jvp_of_the_plain_ops(n_u, ds_final):
    """``ref.wkv6_jvp_ref`` and ``wkv6_bwd_jvp_ref`` (the formulas kernels
    17j and 17bj compute, the states' tangents formed inside the
    backward's) equal ``torch.func.jvp`` of ``wkv6_ref`` and of its vjp,
    within ``F32_REL`` of the largest magnitude, over three chunks of 4
    steps, the last ragged; ds_final given or None (zero)."""
    case = (1, 2, 10, 2, 3, 4, n_u, False)
    (r, k, v, w, u, s0), tangents, _, _ = _wkv_data(case, torch.float32, 12)
    primals = tuple(x[0] for x in (r, k, v, w, u, s0))
    tangents = tuple(x[0] for x in tangents)
    chunk = 4

    def fwd(*a):
        return ref.wkv6_ref(*a, chunk=chunk)

    _, want = torch.func.jvp(fwd, primals, tangents)
    _close(ref.wkv6_jvp_ref(*primals, *tangents, chunk=chunk), want, F32_REL)
    rng = np.random.default_rng(13)
    t = (lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    dy, dyt = t(2, 10, 2, 4), t(2, 10, 2, 4)
    dsf, dsft = (t(2, 2, 3, 4), t(2, 2, 3, 4)) if ds_final else (None, None)

    def bwd(*a):
        if ds_final:
            return torch.func.vjp(fwd, *a[:6])[1]((a[6], a[7]))
        return torch.func.vjp(lambda *x: fwd(*x)[0], *a[:6])[1](a[6])

    extra, extra_t = ((dy, dsf), (dyt, dsft)) if ds_final else ((dy,), (dyt,))
    _, want = torch.func.jvp(bwd, primals + extra, tangents + extra_t)
    got = ref.wkv6_bwd_jvp_ref(*primals, dy, dsf, *tangents, dyt, dsft, chunk=chunk)
    _close(got, want, F32_REL)


def test_forward_mode_rule_lets_a_kernel_launch_inside_a_probe():
    """Inside ``jvp_target`` a wrapper off the CPU raises, naming the oracle,
    unless the launch comes from a Function with a forward-mode rule."""
    meta = torch.zeros(1, device="meta")
    with _args.jvp_target("the oracle 'probe'"):
        with pytest.raises(TypeError, match="probe.*lru_scan.*forward-mode rule"):
            _args.on_cpu("lru_scan", meta)
        with _args.forward_mode_rule():
            with pytest.raises(ValueError, match="not supported"):  # meta: not CUDA either
                _args.on_cpu("lru_scan", meta)
        with pytest.raises(TypeError, match="probe"):
            _args.on_cpu("lru_scan", meta)


# ---------------------------------------------------------------------------
# the fused MoE dispatch's token gather
# ---------------------------------------------------------------------------

def test_dispatch_gather_tangent_is_the_gather_of_the_tangent():
    rng = np.random.default_rng(7)
    T, D, E, cap = 6, 4, 3, 3
    xt, xt_t = (torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
                for _ in range(2))
    tok = torch.tensor([[0, 2, T], [1, 5, 3], [4, T, T]])
    rows = torch.tensor([[0, 3], [1, 7], [2, 4], [5, 7], [6, 7], [4, 8]])
    kept = torch.ones(T, 2, dtype=torch.bool)

    def plain(x):
        return torch.cat([x, x.new_zeros((1, D))], dim=0)[tok]

    y, yt = torch.func.jvp(lambda x: M._DispatchGather.apply(x, tok, rows, kept), (xt,), (xt_t,))
    assert torch.equal(y, plain(xt)) and torch.equal(yt, plain(xt_t))


def test_fused_moe_block_vmap_jvp_grad():
    """``vmap(jvp(grad))`` through deepseek-v2-lite's reduced MoE block with
    the fused dispatch (``_DispatchGather``'s rule) against the same block
    with a plain gather in its place."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    layer = {k: v[0] for k, v in params["stack"]["units"]["b0"]["moe"].items()
             if torch.is_tensor(v)}
    layer["shared"] = {k: v[0] for k, v in params["stack"]["units"]["b0"]["moe"]["shared"].items()}
    rng = np.random.default_rng(8)
    m, B, S = 2, 1, 8
    x = torch.from_numpy(rng.standard_normal((m, B, S, cfg.d_model)).astype(np.float32))
    xt = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def f(x):
        out, aux = M.moe_apply(cfg, layer, x, fused=True)
        return (out ** 2).sum() + aux

    got = _hvp(f, (x,), (xt,), (0,))
    plain = M._DispatchGather.apply
    try:
        M._DispatchGather.apply = staticmethod(
            lambda xt, tok, rows, kept: torch.cat([xt, xt.new_zeros((1, xt.shape[-1]))], 0)[tok])
        want = _hvp(f, (x,), (xt,), (0,))
    finally:
        M._DispatchGather.apply = plain
    _close(got, want, F32_REL)


# ---------------------------------------------------------------------------
# estimate_L on reduced LMs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
                                  "rwkv6-1.6b"])
def test_estimate_L_matches_reference(arch):
    """The launcher's probe (``vmap(jvp(grad(loss)))`` power iteration,
    ``estimate_L`` with 8 iterations) at the reference's keyed weights and
    probe batch, against the reference's ``estimate_L``."""
    m, iters = 2, 8
    rc = dataclasses.replace(ref_get_arch(arch).reduced(), dtype="float32")
    pc = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    rm, pm = ref_build(rc), build(pc)
    rp = rm.init(jax.random.key(0))
    rb = next(ref_lm_batches(jax.random.key(3), 1, m, 1, 16, rc.vocab_size))
    want = ref_autotune.estimate_L(lambda p, b: jax.grad(lambda q: rm.loss(q, b)[0])(p), rp, m,
                                   rb, iters=iters)
    pp = convert.model_params(rp, "cpu")
    pb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}

    def client_grad(p, b):
        return torch.func.grad(lambda q: pm.loss(q, b)[0])(p)

    got = autotune.estimate_L(client_grad, pp, m, pb, iters=iters)
    assert got.shape == (m,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=L_RTOL)


def test_estimate_L_takes_a_bf16_model():
    """A bf16 model's probe runs in bf16, as the reference's does, and its
    estimates come back as positive float64 (numpy has no bf16: the full
    archs' ``--eta auto`` failed there).  Not held to the f32 model's: its
    start vector's first product cancels to rounding noise in bf16."""
    m = 2
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced(), dtype="bfloat16", n_layers=1)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (m, 1, 8)))

    def client_grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    got = autotune.estimate_L(client_grad, params, m, {"tokens": toks, "targets": toks},
                              iters=4)
    assert got.dtype == np.float64 and got.shape == (m,)
    assert np.all(np.isfinite(got)) and np.all(got > 0)
