"""The port's kernels against the reference's (``repro.kernels.ops``).

On the CPU each port wrapper runs its plain PyTorch version, so these tests
hold the plain versions -- the arithmetic every CUDA kernel is checked
against on the card -- to the reference's ``"xla"`` branch and to its
Pallas kernels in interpret mode.  Inputs come from numpy with a seed.

Tolerances:
  * elementwise kernels vs ``"xla"``: bitwise (both sides run the same f32
    operations in the same order, and cast back at the same points);
  * elementwise kernels vs ``"pallas_interpret"``: rtol 1e-6, atol 1e-5
    on O(1)-O(10) values (atol 1e-6 for ``fused_update`` and
    ``scaffold_cv``) -- interpret mode compiles the kernel body as one XLA
    computation, another program with the same operation order, whose CPU
    backend may contract a multiply and an add into one FMA (one rounding
    fewer), a few ulps apart; with bf16 outputs such a difference can flip
    the final rounding, so rtol 8e-3 (one bf16 ulp) there;
  * the K-step inner loop: rtol = atol = 1e-4 (as tests/test_inner_loop.py),
    because the matvec sums in another order;
  * the cohort gather/scatter and the EF21 row max: bitwise against both
    (copies and maxima round nothing), a NaN row included;
  * EF21's apply pass: bitwise against ``"xla"``, and to ``pallas_interpret``
    at the elementwise tolerance above (its body's u_hat + q s may become
    one FMA there: measured differences of one f32 ulp).

``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain versions
on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as R
from repro.kernels import round_tail as ref_round_tail
from repro_torch.kernels import _build, inner_loop, ops as P

BF16 = jnp.bfloat16
M_W = [(3, 128), (8, 384)]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bf16":
        return jnp.asarray(a).astype(BF16), torch.from_numpy(a.copy()).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _same(ref_out, port_out, impl, atol=1e-5):
    a, b = _np(ref_out), _np(port_out)
    if impl == "xla":
        np.testing.assert_array_equal(a, b)
    elif port_out.dtype == torch.bfloat16:
        np.testing.assert_allclose(b, a, rtol=8e-3, atol=atol)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=atol)


@pytest.fixture(params=["xla", "pallas_interpret"])
def impl(request):
    """Each reference call names its impl; the global default is restored
    in any case."""
    prev = R._DEFAULT_IMPL
    try:
        R.set_default_impl(request.param)
        yield request.param
    finally:
        R.set_default_impl(prev)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_lam_is", [True, False])
@pytest.mark.parametrize("m,w", M_W)
def test_round_tail_matches_reference(impl, m, w, with_lam_is, dtype):
    x, lam, xs = _draw(m * w, (m, w), (m, w), (w,))
    (xj, xt), (lj, lt), (sj, st) = (_pair(a, dtype) for a in (x, lam, xs))
    rho = 3.7
    lam_is_r, up_r = R.round_tail(xj, lj, sj, rho, with_lam_is=with_lam_is, impl=impl)
    lam_is_p, up_p = P.round_tail(xt, lt, st, rho, with_lam_is=with_lam_is)
    assert up_p.dtype == xt.dtype and tuple(up_p.shape) == (m, w)
    _same(up_r, up_p, impl)
    if with_lam_is:
        _same(lam_is_r, lam_is_p, impl)
    else:
        assert lam_is_p is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,w", M_W)
def test_dual_from_uplink_matches_reference(impl, m, w, dtype):
    u, xs = _draw(m + w, (m, w), (w,))
    (uj, ut), (sj, st) = _pair(u, dtype), _pair(xs, dtype)
    _same(R.dual_from_uplink(uj, sj, 2.5, impl=impl), P.dual_from_uplink(ut, st, 2.5), impl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_client_step", [False, True])
@pytest.mark.parametrize("has_lam", [True, False])
@pytest.mark.parametrize("m,w", M_W)
def test_fused_update_arena_matches_reference(impl, m, w, has_lam, per_client_step, dtype):
    x, g, lam, xs = _draw(7 * m + w, (m, w), (m, w), (m, w), (w,))
    (xj, xt), (gj, gt), (lj, lt), (sj, st) = (_pair(a, dtype) for a in (x, g, lam, xs))
    step_np = np.linspace(0.01, 0.3, m).astype(np.float32)
    step_r = step_np if per_client_step else 0.13
    step_p = torch.from_numpy(step_np) if per_client_step else 0.13
    out_r = R.fused_update_arena(xj, gj, sj, lj if has_lam else None, step_r, 1.7, impl=impl)
    out_p = P.fused_update_arena(xt, gt, st, lt if has_lam else None, step_p, 1.7)
    assert out_p.dtype == xt.dtype
    _same(out_r, out_p, impl)


# leaves of the per-leaf path: a 0-d leaf per client, ragged sizes
# (numel % 4 != 0 and % 8 != 0), and the Fig. 2 leaf's shape family
LEAF_SHAPES = [(6,), (6, 7), (4, 3, 50), (5, 130)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_client_step", [False, True])
@pytest.mark.parametrize("has_lam", [True, False])
@pytest.mark.parametrize("shape", LEAF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_update_matches_reference(impl, shape, has_lam, per_client_step, dtype):
    """Kernel 6 on one leaf.  A per-client step is (m, 1, ...), as the
    pytree rounds pass it (the reference sends it to its plain version in
    either impl)."""
    x, g, xs, lam = _draw(sum(shape) + 3, shape, shape, shape, shape)
    (xj, xt), (gj, gt), (sj, st), (lj, lt) = (_pair(a, dtype) for a in (x, g, xs, lam))
    lead = (-1,) + (1,) * (len(shape) - 1)
    step_np = np.linspace(0.01, 0.3, shape[0]).astype(np.float32).reshape(lead)
    step_r = step_np if per_client_step else 0.13
    step_p = torch.from_numpy(step_np) if per_client_step else 0.13
    out_r = R.fused_update(xj, gj, sj, lj if has_lam else None, step_r, 1.7, impl=impl)
    out_p = P.fused_update(xt, gt, st, lt if has_lam else None, step_p, 1.7)
    assert out_p.dtype == xt.dtype and tuple(out_p.shape) == shape
    _same(out_r, out_p, impl, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", LEAF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_update_broadcasts_the_server_leaf(shape, dtype):
    """The port's wrapper also takes the server leaf without the client dim
    and broadcasts it (as the GPDMM/AGPDMM pytree rounds pass x_s): bitwise
    the reference's step on the materialised broadcast."""
    x, g, lam = _draw(len(shape), shape, shape, shape)
    xs = _draw(7, shape[1:])[0]
    (xj, xt), (gj, gt), (lj, lt), (sj, st) = (_pair(a, dtype) for a in (x, g, lam, xs))
    out_r = R.fused_update(xj, gj, jnp.broadcast_to(sj, shape), lj, 0.2, 3.0, impl="xla")
    _same(out_r, P.fused_update(xt, gt, st, lt, 0.2, 3.0), "xla")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_client_alpha", [False, True])
@pytest.mark.parametrize("m,w", M_W)
def test_scaffold_cv_matches_reference(impl, m, w, per_client_alpha, dtype):
    """Kernel 5, SCAFFOLD's c_i' = (c_i - c) + alpha (x_s - x_K)."""
    ci, xk, c, xs = _draw(5 * m + w, (m, w), (m, w), (w,), (w,))
    (cij, cit), (xkj, xkt), (cj, ct), (sj, st) = (_pair(a, dtype) for a in (ci, xk, c, xs))
    alpha_np = (1.0 / (3 * np.linspace(0.01, 0.03, m))).astype(np.float32)
    alpha_r = alpha_np if per_client_alpha else 37.5
    alpha_p = torch.from_numpy(alpha_np) if per_client_alpha else 37.5
    out_r = R.scaffold_cv(cij, xkj, cj, sj, alpha_r, impl=impl)
    out_p = P.scaffold_cv(cit, xkt, ct, st, alpha_p)
    assert out_p.dtype == cit.dtype and tuple(out_p.shape) == (m, w)
    _same(out_r, out_p, impl, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_client_step", [False, True])
@pytest.mark.parametrize("has_off", [False, True])
@pytest.mark.parametrize("has_lam", [True, False])
@pytest.mark.parametrize("m,w", M_W)
def test_inner_loop_affine_matches_reference(impl, m, w, has_lam, has_off, per_client_step,
                                             dtype):
    """f32 H and c with f32 or bf16 client rows (x0, x_s, lam, off), as a
    bf16 parameter tree on the arena gives them: both sides upcast on load,
    run the K steps in f32 and round x_K and x_bar once to x0's dtype.  With
    bf16 rows a result may also cross a bf16 rounding boundary where the f32
    loops differ: one bf16 ulp, 2^-7 of the value (measured: equal)."""
    K, rho = 4, 0.9
    x0, c, lam, off, xs = _draw(11 * m + w, (m, w), (m, w), (m, w), (m, w), (w,))
    A = _draw(m * w + 1, (m, w, w))[0] / np.sqrt(w)
    H = (np.einsum("mij,mkj->mik", A, A) / 4.0).astype(np.float32)  # PSD, ||H|| ~ 1
    step_np = np.linspace(0.05, 0.2, m).astype(np.float32)
    step_r = step_np if per_client_step else 0.1
    step_p = torch.from_numpy(step_np) if per_client_step else 0.1
    (x0j, x0t), (xsj, xst), (lamj, lamt), (offj, offt) = (
        _pair(a, dtype) for a in (x0, xs, lam, off))
    t = lambda a: torch.from_numpy(a.copy())
    j = jnp.asarray
    out_r = R.inner_loop_affine(x0j, j(H), j(c), xsj, lamj if has_lam else None, step_r, rho,
                                K, off=offj if has_off else None, impl=impl)
    out_p = P.inner_loop_affine(x0t, t(H), t(c), xst, lamt if has_lam else None, step_p, rho,
                                K, off=offt if has_off else None)
    for a, b in zip(out_r, out_p):
        assert b.dtype == x0t.dtype and a.dtype == x0j.dtype
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4 if dtype == "f32" else 2.0 ** -7,
                                   atol=1e-4)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_bf16_lsq_arena_round_matches_reference(algo):
    """A bf16 parameter tree through ``prob.oracle()`` with ``use_arena=True``:
    the affine inner loop takes bf16 rows and f32 (H, c) on both sides.
    Four rounds, each from the reference's state carried across, compared
    by ``_torch_parity.compare_trees`` (bf16 leaves within 4 bf16 ulps of
    their largest value, at most 2% of them off bitwise)."""
    import jax
    from repro.configs.base import FederatedConfig as RefConfig
    from repro.core import make as ref_make, quadratic as ref_quadratic
    from repro_torch import convert
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make
    from _torch_parity import compare_trees

    ref = ref_quadratic.generate(jax.random.key(0), m=8, n=64, d=64)
    prob = convert.least_squares(ref, "cpu")
    kw = dict(algorithm=algo, inner_steps=5, eta=0.5 / ref.L, use_arena=True)
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rs = ro.init(jnp.zeros(ref.d, BF16), ref.m)
    ps = po.init(torch.zeros(ref.d, dtype=torch.bfloat16), ref.m)
    for r in range(4):
        if r:
            ps = convert.round_state(rs, "cpu")
        rs, rm = ro.round(rs, ref.oracle(), ref.batch())
        ps, pm = po.round(ps, prob.oracle(), prob.batch())
        assert float(pm["used_arena"]) == float(rm["used_arena"]) == 1.0
        compare_trees(rs, rm, ps, pm, FederatedConfig(**kw))


# the resident route's arithmetic: (W, route, blocks per client, rows of H a
# warp holds, floats of H a thread holds, shared memory a block)
RESIDENT_CASES = [(128, "resident", 1, 8, 32, 68_640),
                  (512, "resident", 8, 4, 64, 138_016),
                  (640, "resident", 16, 3, 60, 110_592),
                  (1024, "stream", None, None, None, None)]


@pytest.mark.parametrize("w,want_route,cluster,rpw,frag,smem", RESIDENT_CASES,
                         ids=[str(c[0]) for c in RESIDENT_CASES])
def test_inner_loop_route_and_resident_arithmetic(w, want_route, cluster, rpw, frag, smem):
    """The route is a function of the width alone: resident where a cluster
    of at most 16 blocks of 16 warps keeps each thread's share of H within
    64 floats of registers (its warp's rows, W / 32 columns of each) and the
    next client's staged slab within shared memory; streaming where none
    does.  ``affine_inner_fits`` keeps its meaning: a width either route
    takes, the streaming route's rows rule."""
    assert inner_loop.route(w) == want_route
    assert inner_loop.cluster_size(w) == cluster
    assert P.affine_inner_fits(w) == (w % 128 == 0 and 24 * w <= 232_448)
    if cluster is None:
        assert all(inner_loop.fragment_floats(w, c) > inner_loop.FRAGMENT_FLOATS
                   for c in inner_loop.CLUSTER_SIZES)
        return
    rows = w // cluster
    assert rows % 8 == 0 and inner_loop.rows_per_warp(w, cluster) == rpw == -(-rows // 16)
    assert inner_loop.fragment_floats(w, cluster) == frag == rpw * (w // 128) * 4 <= 64
    assert cluster == 1 or inner_loop.fragment_floats(w, cluster // 2) > 64
    assert inner_loop.resident_smem_bytes(w) == smem == 32 + 4 * (rows * w + 3 * w + 3 * rows)
    assert smem <= inner_loop.SMEM_CAP_BYTES


def test_inner_loop_route_refuses_what_no_route_takes():
    """Widths off the 128-lane arena or past the streaming route's rows
    raise before any launch, naming the width."""
    for w in (200, 500, 9728):
        assert not P.affine_inner_fits(w)
        with pytest.raises(ValueError, match="width"):
            inner_loop.route(w)
    assert [w for w in range(128, 9601, 128) if inner_loop.route(w) == "resident"][-1] == 640


# EF21 widths and per-leaf row counts: one leaf, two leaves, the softmax
# arena (W = 7,936) as one leaf and as two
EF21_CASES = [(128, (1,)), (384, (3,)), (384, (1, 2)), (7936, (62,)), (7936, (61, 1))]


def _ef21_inputs(m, w, dtype, seed):
    """u = u_hat + a delta of mixed scale, with a NaN in one element of
    client 1 (it must turn that client's leaf to NaN on both sides)."""
    u_hat, delta = _draw(seed, (m, w), (m, w))
    u = u_hat + delta * np.linspace(0.01, 3.0, m, dtype=np.float32)[:, None]
    u[1, 5] = np.nan
    return _pair(u, dtype), _pair(u_hat, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("w,leaf_rows", EF21_CASES, ids=lambda c: str(c))
def test_ef21_update_matches_reference(impl, w, leaf_rows, bits, dtype):
    """Kernels 7 and 8 with the per-(client, leaf) scales between them."""
    m = 4
    (uj, ut), (hj, ht) = _ef21_inputs(m, w, dtype, seed=w + bits)
    out_r = R.ef21_update(uj, hj, bits, leaf_rows, impl=impl)
    out_p = P.ef21_update(ut, ht, bits, leaf_rows)
    assert out_p.dtype == ut.dtype and tuple(out_p.shape) == (m, w)
    n0 = 128 * leaf_rows[0]  # the NaN's leaf; a second leaf keeps its scale
    assert torch.isnan(out_p[1, :n0]).all() and not torch.isnan(out_p[1, n0:]).any()
    assert not torch.isnan(out_p[0]).any()
    _same(out_r, out_p, impl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w", [128, 384, 7936])
def test_ef21_rowmax_matches_reference(w, dtype):
    """Kernel 7 alone against the reference's Pallas kernel in interpret
    mode, bitwise; the NaN propagates to its row's max only."""
    m = 3
    (uj, ut), (hj, ht) = _ef21_inputs(m, w, dtype, seed=w)
    got = P.ef21_rowmax(ut, ht)
    want = np.asarray(ref_round_tail.ef21_rowmax_pallas(uj, hj, interpret=True))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, w // 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isnan(got[1, 0]) and int(torch.isnan(got).sum()) == 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("w", [128, 384, 7936])
def test_ef21_apply_matches_reference(w, bits, dtype):
    """Kernel 8 alone, with given per-row scales, against the reference's
    Pallas kernel in interpret mode (tolerance: module docstring)."""
    m = 3
    (uj, ut), (hj, ht) = _ef21_inputs(m, w, dtype, seed=2 * w + bits)
    scales = (0.001 + np.random.default_rng(w).random((m, w // 128))).astype(np.float32)
    out_r = ref_round_tail.ef21_apply_pallas(uj, hj, jnp.asarray(scales), bits,
                                             interpret=True)
    out_p = P.ef21_apply(ut, ht, torch.from_numpy(scales), bits)
    _same(out_r, out_p, "pallas_interpret")


@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,w,ids", [(10, 128, [0, 3, 4, 9]), (7, 384, [6]),
                                     (5, 7936, [0, 1, 2, 3, 4])])
def test_row_gather_and_scatter_match_reference(impl, m, w, ids, dtype, idx_dtype):
    """Kernels 9 and 10: the cohort's rows out of the population arena, and
    back in (a new buffer; the population buffer is left as it was)."""
    arr, rows = _draw(m * w + len(ids), (m, w), (len(ids), w))
    (aj, at), (rj, rt) = _pair(arr, dtype), _pair(rows, dtype)
    idx = np.asarray(ids, np.int32)
    it = torch.from_numpy(idx).to(getattr(torch, idx_dtype))
    got = P.row_gather(at, it)
    assert tuple(got.shape) == (len(ids), w) and got.dtype == at.dtype
    _same(R.row_gather(aj, jnp.asarray(idx), impl=impl), got, "xla")
    before = at.clone()
    got = P.row_scatter(at, it, rt)
    assert torch.equal(at, before) and got.data_ptr() != at.data_ptr()
    _same(R.row_scatter(aj, jnp.asarray(idx), rj, impl=impl), got, "xla")


def test_inner_loop_keeps_padding_zero():
    """Zero H rows/cols and zero c/x/x_s/lam columns stay zero (arena
    padding invariant)."""
    m, d, w = 3, 50, 128
    x0, c, lam, xs = _draw(5, (m, w), (m, w), (m, w), (w,))
    for a in (x0, c, lam):
        a[:, d:] = 0.0
    xs[d:] = 0.0
    H = np.zeros((m, w, w), np.float32)
    H[:, :d, :d] = np.eye(d, dtype=np.float32)
    t = lambda a: torch.from_numpy(a)
    x_K, x_bar = P.inner_loop_affine(t(x0), t(H), t(c), t(xs), t(lam), 0.1, 0.5, 3)
    assert torch.all(x_K[:, d:] == 0) and torch.all(x_bar[:, d:] == 0)


def test_ops_surface_and_width_rule():
    """The public names, the launch accounting, and the kernel's own width
    rule (its shared-memory rows), which replaces the TPU's VMEM gate."""
    assert [k.name for k in P.KERNELS] == [
        "inner_loop_affine", "round_tail", "dual_from_uplink", "fused_update_arena",
        "scaffold_cv", "fused_update", "ef21_rowmax", "ef21_apply", "row_gather",
        "row_scatter", "screen_uplink", "stale_mix", "residual_norm", "neighbor_reduce",
        "edge_flip", "flash_attention", "wkv6", "round_tail_mean", "client_mean",
        "ef21_update", "screen_keep", "scaffold_step"]
    assert P.affine_inner_fits(512) and P.affine_inner_fits(7936)
    assert not P.affine_inner_fits(500)  # not a multiple of 128
    widest = inner_loop.SMEM_CAP_BYTES // (4 * inner_loop.SMEM_ROWS)
    assert not P.affine_inner_fits((widest // 128 + 1) * 128)
    P.reset_launches()
    x = torch.zeros(2, 128)
    P.dual_from_uplink(x, torch.zeros(128), 1.0)  # the CPU runs the plain version
    assert P.launches() == {k.name: 0 for k in P.KERNELS}


@pytest.mark.parametrize("fn", ["round_tail", "dual_from_uplink", "fused_update_arena",
                                "inner_loop_affine", "scaffold_cv", "fused_update",
                                "ef21_rowmax", "ef21_apply", "ef21_update", "row_gather",
                                "row_scatter", "screen_keep", "scaffold_step"])
def test_non_cpu_non_cuda_tensor_raises(fn):
    """Only a CPU tensor reaches a plain version; any other device that is
    not CUDA is refused, never computed some other way."""
    x = torch.zeros(2, 128, device="meta")
    xs = torch.zeros(128, device="meta")
    calls = {
        "round_tail": lambda: P.round_tail(x, x, xs, 1.0),
        "dual_from_uplink": lambda: P.dual_from_uplink(x, xs, 1.0),
        "fused_update_arena": lambda: P.fused_update_arena(x, x, xs, x, 0.1, 1.0),
        "inner_loop_affine": lambda: P.inner_loop_affine(
            x, torch.zeros(2, 128, 128, device="meta"), x, xs, x, 0.1, 1.0, 2),
        "scaffold_cv": lambda: P.scaffold_cv(x, x, xs, xs, 2.0),
        "fused_update": lambda: P.fused_update(x, x, x, None, 0.1, 1.0),
        "ef21_rowmax": lambda: P.ef21_rowmax(x, x),
        "ef21_apply": lambda: P.ef21_apply(x, x, torch.ones(2, 1, device="meta"), 8),
        "ef21_update": lambda: P.ef21_update(x, x, 8, (1,)),
        "row_gather": lambda: P.row_gather(x, torch.zeros(1, dtype=torch.int64, device="meta")),
        "row_scatter": lambda: P.row_scatter(
            x, torch.zeros(1, dtype=torch.int64, device="meta"), x[:1]),
        "screen_keep": lambda: P.screen_keep(x, xs, 100.0),
        "scaffold_step": lambda: P.scaffold_step(x, x, xs, xs, 2.0, 1.0),
    }
    with pytest.raises(ValueError, match="not supported"):
        calls[fn]()


def test_build_targets_hopper_and_sources_are_hand_written():
    """Every source compiles for sm_90a with a plain C interface, and no
    kernel leans on a library kernel."""
    cmd = _build.nvcc_command("nvcc", "round_tail.cu", _build.BUILD_DIR / "x.so")
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert _build.library_path("inner_loop.cu").parent == _build.BUILD_DIR
    for src in _build.SOURCES + _build.HEADERS:
        text = (_build.CSRC / src).read_text()
        for banned in ("cublas", "cudnn", "torch/extension.h", "cutlass", "ATen"):
            assert banned not in text, (src, banned)
    for src in _build.SOURCES:
        assert 'extern "C" int launch_' in (_build.CSRC / src).read_text()


# ---------------------------------------------------------------------------
# kernels 16-17: attention and the RWKV-6 recurrence, with the decode steps
# ---------------------------------------------------------------------------
#
# Tolerances: those of tests/test_kernels.py for the same comparisons -- flash
# in f32 atol = rtol = 2e-5 (the softmax sums in another order), in bf16 3e-2
# (q k^T, p v and the output round to bf16 at other points); wkv6 atol 2e-4,
# rtol 1e-3 against the sequential oracle (chunked against sequential
# accumulation), 1e-4 between the chunked forms (the chunk products contract
# in another order); the decode steps 1e-5.

from repro.kernels import ref as RR  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.wkv6 import wkv6_pallas  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402

FLASH_CASES = [  # B, Sq, Sk, H, Hkv, hd, window: tests/test_kernels.py's sweep, GQA 4, offsets
    (1, 128, 128, 2, 2, 16, None), (2, 256, 256, 4, 2, 32, None), (2, 256, 256, 4, 1, 32, 64),
    (1, 128, 128, 8, 2, 16, 50), (2, 128, 128, 8, 2, 32, 16), (1, 64, 192, 4, 1, 16, None),
    (2, 64, 256, 4, 4, 32, 16),
]


def _flash_inputs(case, dtype, seed=0):
    B, Sq, Sk, H, Hkv, hd, _ = case
    q, k, v = _draw(seed, (B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))
    return [_pair(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"c{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_plain_matches_reference(case, dtype):
    """The plain version (what the CUDA kernel is held to) against
    ``attention_ref``, the ``"xla"`` branch and the Pallas kernel in
    interpret mode; suffix queries (Sq < Sk) through ``q_offset``."""
    B, Sq, Sk, H, Hkv, hd, window = case
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(case, dtype)
    off = Sk - Sq
    qp, kp = jnp.arange(off, Sk), jnp.arange(Sk)
    got = _np(P.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=off))
    explicit = _np(P.flash_attention(tq, tk, tv, torch.arange(off, Sk), torch.arange(Sk),
                                     causal=True, window=window))
    np.testing.assert_array_equal(explicit, got)
    tol = 2e-5 if dtype == "f32" else 3e-2
    wants = [RR.attention_ref(jq, jk, jv, qp, kp, causal=True, window=window),
             # the xla branch's causal skip assumes queries from position 0
             R.flash_attention(jq, jk, jv, qp, kp, causal=True, window=window, q_chunk=64,
                               k_chunk=64, causal_skip=off == 0, impl="xla"),
             flash_attention_pallas(jq, jk, jv, qp, kp, causal=True, window=window,
                                    q_block=64, k_block=64, interpret=True)]
    for want in wants:
        np.testing.assert_allclose(got, _np(want), atol=tol, rtol=tol)


def _wkv_inputs(B, S, H, K, V, seed=0, dtype="f32"):
    r, k, wr, v, u, s0 = _draw(seed, (B, S, H, K), (B, S, H, K), (B, S, H, K), (B, S, H, V),
                               (H, K), (B, H, K, V))
    w = np.exp(-np.exp(0.5 * wr)).astype(np.float32)
    rkv = [_pair(0.5 * a, dtype) for a in (r, k, v)]
    rest = [_pair(a, "f32") for a in (w, 0.1 * u, 0.1 * s0)]
    return rkv + rest


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 32, 1, 8, 8, 8), (2, 64, 3, 16, 16, 16), (2, 128, 2, 32, 32, 32), (1, 96, 2, 32, 16, 32),
    (2, 128, 2, 64, 64, 64),
])
def test_wkv6_plain_matches_reference(B, S, H, K, V, chunk, dtype):
    """The kernel wrapper's plain version (chunks of 64) against the
    sequential oracle, the ``"xla"`` branch and the Pallas kernel in
    interpret mode (at the reference's chunk), and the plain version at
    that chunk against the ``"xla"`` branch."""
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = _wkv_inputs(B, S, H, K, V,
                                                                             dtype=dtype)
    y, s = P.wkv6(tr, tk, tv, tw, tu, ts)
    assert y.dtype == tr.dtype and s.dtype == torch.float32
    rtol, atol = (1e-3, 2e-4) if dtype == "f32" else (3e-2, 3e-2)
    for want_y, want_s in (RR.wkv6_ref(jr, jk, jv, jw, ju, js),
                           R.wkv6(jr, jk, jv, jw, ju, js, chunk=chunk, impl="xla"),
                           wkv6_pallas(jr, jk, jv, jw, ju, js, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=atol, rtol=rtol)
        np.testing.assert_allclose(s.numpy(), _np(want_s), atol=2e-4, rtol=1e-3)
    y_c, s_c = PR.wkv6_ref(tr, tk, tv, tw, tu, ts, chunk=chunk)
    want_y, want_s = R.wkv6(jr, jk, jv, jw, ju, js, chunk=chunk, impl="xla")
    np.testing.assert_allclose(_np(y_c), _np(want_y), atol=1e-4 if dtype == "f32" else 3e-2,
                               rtol=1e-4 if dtype == "f32" else 3e-2)
    np.testing.assert_allclose(s_c.numpy(), _np(want_s), atol=1e-4, rtol=1e-4)


def test_wkv6_extreme_decay_chunks_and_ragged_length():
    """Near-zero decay stays finite (the clamped pairwise decay), the result
    does not depend on the chunk, and a length that is no multiple of the
    chunk (the reference's ``wkv6`` refuses it) agrees with the sequential
    oracle."""
    B, S, H, K, V = 1, 64, 1, 16, 16
    (jr, tr), (jk, tk), (jv, tv), _, (ju, tu), _ = _wkv_inputs(B, S, H, K, V, seed=2)
    tw, jw = torch.full((B, S, H, K), 1e-30), jnp.full((B, S, H, K), 1e-30)
    ts, js = torch.zeros(B, H, K, V), jnp.zeros((B, H, K, V))
    y, _ = P.wkv6(tr, tk, tv, tw, tu, ts)
    assert torch.isfinite(y).all()
    y_ref, _ = RR.wkv6_ref(jr, jk, jv, jw, ju, js)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), rtol=2e-4, atol=1e-3)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = _wkv_inputs(1, 32, 1, 8, 8, 5)
    base = PR.wkv6_ref(tr, tk, tv, tw, tu, ts, chunk=32)
    for chunk in (4, 8, 16, 5):
        for a, b in zip(PR.wkv6_ref(tr, tk, tv, tw, tu, ts, chunk=chunk), base):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=1e-3)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = _wkv_inputs(2, 100, 2, 8, 8, 7)
    for a, b in zip(P.wkv6(tr, tk, tv, tw, tu, ts), RR.wkv6_ref(jr, jk, jv, jw, ju, js)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("window", [None, 16])
def test_attend_cache_and_wkv6_step_match_reference(window):
    """The two decode steps, plain tensor code on both sides: attention of
    one token against a cache with empty slots (k_pos = -1), and one step
    of the recurrence."""
    B, S, H, Hkv, hd = 2, 40, 4, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs((B, 1, S, H, Hkv, hd, None), "f32", seed=3)
    kpos = np.arange(S, dtype=np.int32)
    kpos[30:] = -1
    q_pos = 29
    got = P.attend_cache(tq, tk, tv, torch.tensor(q_pos, dtype=torch.int32),
                         torch.from_numpy(kpos), window=window)
    want = R.attend_cache(jq, jk, jv, q_pos, jnp.asarray(kpos), window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=1e-5)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = _wkv_inputs(2, 1, 3, 8, 8, 4)
    gy, gs = P.wkv6_step(tr[:, 0], tk[:, 0], tv[:, 0], tw[:, 0], tu, ts)
    wy, ws = R.wkv6_step(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js)
    np.testing.assert_allclose(gy.numpy(), _np(wy), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), _np(ws), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("fn", ["flash_attention", "wkv6"])
def test_model_kernels_refuse_other_devices(fn):
    """Kernels 16-17 run their plain version for a CPU tensor only."""
    x = torch.zeros(1, 8, 2, 16, device="meta")
    calls = {"flash_attention": lambda: P.flash_attention(x, x, x),
             "wkv6": lambda: P.wkv6(x, x, x, x, torch.zeros(2, 16, device="meta"),
                                    torch.zeros(1, 2, 16, 16, device="meta"))}
    with pytest.raises(ValueError, match="not supported"):
        calls[fn]()
