"""Whole GPDMM/AGPDMM rounds of the port against the reference, round by
round, on the same problem carried across by ``repro_torch.convert``.

After every round the tests compare x_s, lam_s, x_c, lam_sum_norm and
client_drift.  Tolerances: rtol = atol = 1e-5 on x-level quantities, as
tests/test_inner_loop.py uses; the affine inner loop's matvec sums in
another order on each side, so the two runs differ by rounding.  The duals
are rho times a difference of x-level quantities (lam' = rho (u - x_s')),
so lam_s and lam_sum_norm get the same tolerance scaled by rho: atol =
1e-5 * rho.  lam_sum_norm is zero in exact arithmetic; both sides report
rounding noise of that size.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make, quadratic as ref_quadratic
from repro.core.softmax import SoftmaxRegression as RefSoftmax
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, resolved_rho
from repro_torch.core import tree_util as T
from repro_torch.core.softmax import SoftmaxRegression

from _torch_parity import run_trees

R = 5


@pytest.fixture(scope="module")
def lsq64():
    ref = ref_quadratic.generate(jax.random.key(0), m=8, n=64, d=64)
    return ref, convert.least_squares(ref, "cpu")


@pytest.fixture(scope="module")
def lsq500():
    ref = ref_quadratic.generate(jax.random.key(0), m=4, n=500, d=500)
    return ref, convert.least_squares(ref, "cpu")


def _compare(rs, rm, ps, pm, rho):
    tol = dict(rtol=1e-5, atol=1e-5)
    lam_tol = dict(rtol=1e-5, atol=1e-5 * rho)
    for k in ("x_s", "x_c"):
        assert (k in rs) == (k in ps), k
        if k in rs:
            np.testing.assert_allclose(convert.to_numpy(ps[k]), np.asarray(rs[k]),
                                       err_msg=k, **tol)
    np.testing.assert_allclose(ps["lam_s"].numpy(), np.asarray(rs["lam_s"]), **lam_tol)
    assert int(ps["round"]) == int(rs["round"])
    np.testing.assert_allclose(float(pm["lam_sum_norm"]), float(rm["lam_sum_norm"]),
                               **lam_tol)
    np.testing.assert_allclose(float(pm["client_drift"]), float(rm["client_drift"]), **tol)
    assert float(pm["used_arena"]) == float(rm["used_arena"]) == 1.0


def _run_both(kw, ref_grad, port_grad, ref_batch, port_batch, params, m, *,
              per_step=False, rounds=R, ref_state=None):
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rho = resolved_rho(FederatedConfig(**kw))
    rs = ro.init(jnp.asarray(params), m) if ref_state is None else ref_state
    ps = (po.init(torch.from_numpy(np.array(params)), m) if ref_state is None
          else convert.round_state(ref_state, "cpu"))
    for r in range(rounds):
        rb = ref_batch(r) if callable(ref_batch) else ref_batch
        pb = port_batch(r) if callable(port_batch) else port_batch
        rs, rm = ro.round(rs, ref_grad, rb, per_step)
        ps, pm = po.round(ps, port_grad, pb, per_step)
        _compare(rs, rm, ps, pm, rho)
    return rs, ps


@pytest.mark.parametrize("eta_kind", ["scalar", "tuple"])
@pytest.mark.parametrize("algo,use_avg", [("gpdmm", True), ("gpdmm", False),
                                          ("agpdmm", True)])
def test_lsq_rounds_match_reference(lsq64, algo, use_avg, eta_kind):
    """Quickstart-sized least squares (W = 128) through the fused affine
    inner-loop path (``use_arena=True`` with ``oracle()``)."""
    ref, prob = lsq64
    eta = 0.5 / ref.L
    if eta_kind == "tuple":
        eta = tuple(float(e) for e in np.linspace(0.3, 0.6, ref.m) / ref.L)
    kw = dict(algorithm=algo, inner_steps=5, eta=eta, use_avg=use_avg, use_arena=True)
    _run_both(kw, ref.oracle(), prob.oracle(), ref.batch(), prob.batch(),
              np.zeros(ref.d, np.float32), ref.m)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_lsq_d500_rounds_match_reference_from_converted_state(lsq500, algo):
    """The paper's d = 500 (W = 512) at m = 4: one reference round, then the
    round state carried across by ``convert.round_state`` and four more
    rounds on both sides."""
    ref, prob = lsq500
    kw = dict(algorithm=algo, inner_steps=5, eta=0.5 / ref.L, use_arena=True)
    ro = ref_make(RefConfig(**kw))
    rs, _ = ro.round(ro.init(jnp.zeros(ref.d), ref.m), ref.oracle(), ref.batch())
    _run_both(kw, ref.oracle(), prob.oracle(), ref.batch(), prob.batch(), None, ref.m,
              rounds=R - 1, ref_state=rs)


def test_plain_grad_on_arena_matches_reference(lsq64):
    """A plain per-client grad on the arena: the step-at-a-time path through
    the tree boundary (vmapped grad), one ``fused_update_arena`` per step."""
    ref, prob = lsq64
    kw = dict(algorithm="gpdmm", inner_steps=3, eta=0.5 / ref.L, use_arena=True)
    _run_both(kw, ref.grad, prob.grad, ref.batch(), prob.batch(),
              np.zeros(ref.d, np.float32), ref.m)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_softmax_per_step_rounds_match_reference(algo):
    """Small softmax regression (F=16, C=4, m=4, B=8, K=3) with one
    minibatch per inner step: the ``grad_arena`` + ``fused_update_arena``
    path."""
    F, C, m, B, K = 16, 4, 4, 8, 3
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((R, K, m, B, F)).astype(np.float32)
    ys = np.broadcast_to(np.arange(m, dtype=np.int32)[None, None, :, None], (R, K, m, B)).copy()
    rp, pp = RefSoftmax(F, C), SoftmaxRegression(F, C)
    kw = dict(algorithm=algo, inner_steps=K, eta=0.05, use_arena=True)
    _run_both(kw, rp.oracle(), pp.oracle(),
              lambda r: {"x": jnp.asarray(xs[r]), "y": jnp.asarray(ys[r])},
              lambda r: {"x": torch.from_numpy(xs[r]), "y": torch.from_numpy(ys[r])},
              np.zeros(pp.dim, np.float32), m, per_step=True)


def test_softmax_grad_matches_reference():
    F, C, B = 16, 4, 8
    rng = np.random.default_rng(4)
    w = 0.1 * rng.standard_normal(F * C + C).astype(np.float32)
    x = rng.standard_normal((B, F)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    rp, pp = RefSoftmax(F, C), SoftmaxRegression(F, C)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    tw = torch.from_numpy(w)
    np.testing.assert_allclose(pp.grad(tw, tb).numpy(), np.asarray(rp.grad(jnp.asarray(w), jb)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pp.loss(tw, tb)), float(rp.loss(jnp.asarray(w), jb)),
                               rtol=1e-5)
    assert float(pp.accuracy(tw, tb["x"], tb["y"])) == float(
        rp.accuracy(jnp.asarray(w), jb["x"], jb["y"]))


def test_trace_round_matches_reference(lsq64):
    """``return_trace=True`` adds x_ref, x_bar, lam_is (the optional
    ``round_tail`` output) and x_K, unpacked to the parameter tree."""
    ref, prob = lsq64
    kw = dict(algorithm="gpdmm", inner_steps=5, eta=0.5 / ref.L, use_arena=True)
    rho = resolved_rho(FederatedConfig(**kw))
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rs, rm = ro.round(ro.init(jnp.zeros(ref.d), ref.m), ref.oracle(), ref.batch(),
                      return_trace=True)
    ps, pm = po.round(po.init(torch.zeros(ref.d), ref.m), prob.oracle(), prob.batch(),
                      return_trace=True)
    _compare(rs, rm, ps, pm, rho)
    for k in ("x_ref", "x_bar", "x_K"):
        assert pm["trace"][k].shape == (ref.m, ref.d)
        np.testing.assert_allclose(pm["trace"][k].numpy(), np.asarray(rm["trace"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pm["trace"]["lam_is"].numpy(),
                               np.asarray(rm["trace"]["lam_is"]), rtol=1e-5, atol=1e-5 * rho)


# ---------------------------------------------------------------------------
# bf16, mixed-dtype and nested parameter trees (tests/_torch_parity.py's
# ``run_trees``: 4 rounds, bf16 leaves bitwise up to rare flips of the
# reference's fused scan, f32 leaves at rtol = atol = 1e-5)
# ---------------------------------------------------------------------------

TREE_CASES = [("bf16", "flat"), ("mixed", "flat"), ("f32", "nested"), ("bf16", "nested"),
              ("mixed", "nested")]


@pytest.mark.parametrize("dtype,kind", TREE_CASES, ids=[f"{d}-{k}" for d, k in TREE_CASES])
@pytest.mark.parametrize("path", ["arena", "pytree"])
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_tree_dtype_rounds_match_reference(algo, path, dtype, kind):
    """Whole GPDMM/AGPDMM rounds on bf16, mixed-dtype and nested trees
    (a dict inside a dict, a list of leaves, an empty dict), on the arena
    (``use_arena=True``; a mixed-dtype tree takes the pytree path there on
    both sides) and on the pytree path: the server tree leaf by leaf and
    the arena rows element for element."""
    run_trees(dict(algorithm=algo, eta=0.1, use_arena=True if path == "arena" else False),
              kind, dtype)


def test_weak_scalar_rounds_as_jax():
    """A Python scalar meets a bf16 tensor as JAX's weak type: cast to
    bf16 first.  x * (1/3), x / 3.3 and 0.7 * x + y on 1,001 bf16 values
    agree bitwise with jnp, and x * (1/3) without the cast differs."""
    x32 = np.linspace(-7.0, 7.0, 1001, dtype=np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = convert.tensor(xj, "cpu")
    bits = lambda t: t.view(torch.int16).numpy()  # noqa: E731
    jbits = lambda a: np.asarray(a).view(np.int16)  # noqa: E731
    np.testing.assert_array_equal(bits(xt * T.weak(1 / 3, xt)), jbits(xj * (1 / 3)))
    np.testing.assert_array_equal(bits(xt / T.weak(3.3, xt)), jbits(xj / 3.3))
    np.testing.assert_array_equal(bits(T.tree_axpy(0.7, xt, xt)), jbits(0.7 * xj + xj))
    np.testing.assert_array_equal(bits(T.tree_scale(xt, 1 / 3)), jbits(xj * (1 / 3)))
    assert np.sum(bits(xt * (1 / 3)) != jbits(xj * (1 / 3))) > 0
    assert T.weak(0.1, torch.zeros(1)) == 0.1  # f32 keeps the Python scalar


def test_tree_flattening_matches_jax():
    """Leaves, key paths and ``tmap``'s structure in ``jax.tree`` order:
    dict keys sorted at every level, lists and tuples in order, None and
    empty containers kept without a leaf."""
    rng = np.random.default_rng(0)
    tree = {"z": {"y": rng.standard_normal(2), "b": [rng.standard_normal(3), None,
                                                      (rng.standard_normal(1),)]},
            "a": {}, "m": rng.standard_normal(4)}
    pt = convert.params(tree, "cpu")
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert T.paths(pt) == [jax.tree_util.keystr(p) for p, _ in want]
    for got, (_, w) in zip(T.leaves(pt), want):
        np.testing.assert_array_equal(got.numpy(), w)
    doubled = T.tmap(lambda x: 2 * x, pt)
    assert doubled["a"] == {} and doubled["z"]["b"][1] is None
    assert isinstance(doubled["z"]["b"][2], tuple)
    assert jax.tree.structure(convert.to_numpy(doubled)) == jax.tree.structure(tree)
    assert T.leaves(T.unflatten(pt, T.leaves(doubled)))[0].equal(T.leaves(doubled)[0])
