"""The port's ten kernels against the reference's (``repro.kernels.ops``).

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


@pytest.mark.parametrize("per_client_step", [False, True])
@pytest.mark.parametrize("has_off", [False, True])
@pytest.mark.parametrize("has_lam", [True, False])
@pytest.mark.parametrize("m,w", M_W)
def test_inner_loop_affine_matches_reference(impl, m, w, has_lam, has_off, per_client_step):
    K, rho = 4, 0.9
    x0, c, lam, off, xs = _draw(11 * m + w, (m, w), (m, w), (m, w), (m, w), (w,))
    A = _draw(m * w + 1, (m, w, w))[0] / np.sqrt(w)
    H = (np.einsum("mij,mkj->mik", A, A) / 4.0).astype(np.float32)  # PSD, ||H|| ~ 1
    step_np = np.linspace(0.05, 0.2, m).astype(np.float32)
    step_r = step_np if per_client_step else 0.1
    step_p = torch.from_numpy(step_np) if per_client_step else 0.1
    t = lambda a: torch.from_numpy(a.copy())
    j = jnp.asarray
    out_r = R.inner_loop_affine(j(x0), j(H), j(c), j(xs), j(lam) if has_lam else None,
                                step_r, rho, K, off=j(off) if has_off else None, impl=impl)
    out_p = P.inner_loop_affine(t(x0), t(H), t(c), t(xs), t(lam) if has_lam else None,
                                step_p, rho, K, off=t(off) if has_off else None)
    for a, b in zip(out_r, out_p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


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
        "edge_flip"]
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
                                "ef21_rowmax", "ef21_apply", "row_gather", "row_scatter"])
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
        "row_gather": lambda: P.row_gather(x, torch.zeros(1, dtype=torch.int64, device="meta")),
        "row_scatter": lambda: P.row_scatter(
            x, torch.zeros(1, dtype=torch.int64, device="meta"), x[:1]),
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
