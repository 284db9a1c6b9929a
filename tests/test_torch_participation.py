"""Partial participation, the cohort engine and the EF21 uplink in the port,
against the reference, round by round, on problems carried across by
``repro_torch.convert``.

Three paths: the arena's cohort round (``use_arena=True, cohort=True``),
the arena's masked full-population round (``cohort=False``) and the
per-leaf pytree path (``use_arena="auto"`` at these widths).  Sizes are
those of tests/test_cohort.py: m = 8, n = 60, d = 24 (W = 128) and d = 130
(W = 256, 126 zero-padded columns).  The participation draw itself is
pinned bit for bit in tests/test_torch_prng.py.

Tolerances, as tests/test_torch_baselines.py states them: rtol = atol =
1e-5 on x-level values (the matvec and the client mean sum in another
order on each side); duals get atol 1e-5 * rho, SCAFFOLD's control
variates atol 1e-5 / (K eta).

EF21 rounds are compared one round at a time from the reference's state
(carried across before every round): the quantiser rounds (u - u_hat) / s
to a grid, so where rounding noise of 1e-7 puts an element on the other
side of a half-integer the two sides land one quantisation step s apart,
and a free-running comparison would carry that step on.  Such an element
is accepted when it is exactly one step s (within the tolerance) from the
reference, at most two per round.  Each such element moves the mean x_s by
s / m, and lam_s = rho (u_hat - x_s) by rho s in its own client's row plus
rho times the shift of x_s: with f flips x_s is allowed s f / m more atol,
lam_s rho s (1 + f / m).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make, quadratic as ref_quadratic
from repro.core import fedsplit as ref_fedsplit, pdmm as ref_pdmm
from repro.core import api as ref_api, tree_util as ref_T
from repro.core.gpdmm import participation_key as ref_participation_key
from repro.core.softmax import SoftmaxRegression as RefSoftmax
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import api, fedsplit, gpdmm, make, pdmm, resolved_rho
from repro_torch.core import tree_util as T
from repro_torch.core.softmax import SoftmaxRegression

from _torch_parity import run_trees

M = 8
R = 4
PATHS = {
    "cohort": dict(use_arena=True, cohort=True),
    "masked": dict(use_arena=True, cohort=False),
    "pytree": dict(use_arena="auto"),
}
# (algorithm, uplink_bits): SCAFFOLD refuses EF21 (tests/test_torch_port.py)
VARIANTS = [("gpdmm", None), ("gpdmm", 8), ("agpdmm", None), ("agpdmm", 8),
            ("scaffold", None), ("fedavg", None), ("fedavg", 8)]


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    ref = ref_quadratic.generate(jax.random.key(0), m=M, n=60, d=request.param)
    return ref, convert.least_squares(ref, "cpu")


def _scales(kw):
    """(dual scale rho, control-variate scale 1/(K eta)) for the tolerances."""
    cfg = FederatedConfig(**kw)
    eta = np.mean(cfg.eta) if isinstance(cfg.eta, tuple) else cfg.eta
    return resolved_rho(cfg), 1.0 / (cfg.inner_steps * eta)


def _tol(key, rho, alpha):
    if key in ("lam_s", "lam_sum_norm"):
        return dict(rtol=1e-5, atol=1e-5 * rho)
    if key in ("c", "c_i", "c_sum_norm"):
        return dict(rtol=1e-5, atol=1e-5 * alpha)
    return dict(rtol=1e-5, atol=1e-5)


def _ef21_slack(prev_u_hat, ref_u_hat, port_u_hat, bits):
    """Check the port's u_hat against the reference's, allowing an element to
    sit exactly one quantisation step off (module docstring); returns the
    extra atol (x_s, lam_s / rho) the flips allow.  Single-leaf
    parameters: the step s_i of client i is max_j |u_hat' - u_hat|_ij / lo
    (the element at the max lands on the grid's end, q = +-lo)."""
    lo = 2 ** (bits - 1) - 1
    new, old = np.asarray(ref_u_hat, np.float32), np.asarray(prev_u_hat, np.float32)
    step = np.abs(new - old).max(axis=1, keepdims=True) / lo
    diff = np.abs(convert.to_numpy(port_u_hat) - new)
    tol = 1e-5 + 1e-5 * np.abs(new)
    flip = diff > tol
    assert np.all(~flip | (np.abs(diff - step) <= tol)), "u_hat off by more than one step"
    assert flip.sum() <= 2, f"{flip.sum()} elements one quantisation step off"
    if not flip.any():
        return 0.0, 0.0
    s, f = float(step.max()), flip.sum() / new.shape[0]
    return s * f, s * (1.0 + f)


def compare(rs, rm, ps, pm, kw, *, slack=(0.0, 0.0), checked_u_hat=False):
    rho, alpha = _scales(kw)
    assert sorted(ps) == sorted(rs)
    for k in rs:
        if k == "round":
            assert int(ps[k]) == int(rs[k])
            continue
        if k == "u_hat" and checked_u_hat:
            continue  # checked step by step in _ef21_slack
        tol = _tol(k, rho, alpha)
        if k == "x_s":
            tol["atol"] += slack[0]
        if k == "lam_s":
            tol["atol"] += rho * slack[1]
        want, got = rs[k], convert.to_numpy(ps[k])
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for leaf in want:
                np.testing.assert_allclose(got[leaf], np.asarray(want[leaf]),
                                           err_msg=f"{k}[{leaf}]", **tol)
        else:
            np.testing.assert_allclose(got, np.asarray(want), err_msg=k, **tol)
    assert sorted(pm) == sorted(rm)
    for k in rm:
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), err_msg=k, **_tol(k, rho, alpha))


def run_both(kw, rgrad, pgrad, rbatch, pbatch, params, m, *, per_step=False, rounds=R):
    """``rounds`` rounds of the reference and the port from the same init,
    compared after each.  With EF21 each port round starts from the
    reference's state (module docstring)."""
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rs, ps = ro.init(jnp.asarray(params), m), po.init(torch.from_numpy(params.copy()), m)
    bits = kw.get("uplink_bits")
    for r in range(rounds):
        rb = rbatch(r) if callable(rbatch) else rbatch
        pb = pbatch(r) if callable(pbatch) else pbatch
        ef21 = bits is not None and "u_hat" in rs
        if ef21:
            ps = convert.round_state(rs, "cpu")
        prev = rs
        rs, rm = ro.round(rs, rgrad, rb, per_step)
        ps, pm = po.round(ps, pgrad, pb, per_step)
        slack = (0.0, 0.0)
        if ef21:
            slack = _ef21_slack(prev["u_hat"], rs["u_hat"], ps["u_hat"], bits)
        compare(rs, rm, ps, pm, kw, slack=slack, checked_u_hat=ef21)
    return rs, ps


def _lsq_run(lsq, kw, rounds=R):
    ref, prob = lsq
    arena = kw["use_arena"] is True
    return run_both(kw, ref.oracle() if arena else ref.grad,
                    prob.oracle() if arena else prob.grad, ref.batch(), prob.batch(),
                    np.zeros(ref.d, np.float32), ref.m, rounds=rounds)


@pytest.mark.parametrize("participation", [0.5, 0.25], ids=["p50", "p25"])
@pytest.mark.parametrize("algo,bits", VARIANTS,
                         ids=[f"{a}-{'ef21' if b else 'plain'}" for a, b in VARIANTS])
@pytest.mark.parametrize("path", PATHS)
def test_partial_participation_rounds_match_reference(lsq, path, algo, bits, participation):
    """Masked, cohort and pytree rounds, plain and EF21, round by round:
    every state entry (u_hat, x_s, lam_s, x_c, c, c_i, the counter) and
    every metric."""
    ref, _ = lsq
    kw = dict(PATHS[path], algorithm=algo, inner_steps=3, eta=0.3 / ref.L,
              participation=participation, uplink_bits=bits)
    _lsq_run(lsq, kw)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "fedavg"])
@pytest.mark.parametrize("path", PATHS)
def test_ef21_full_participation_matches_reference(lsq, path, algo):
    """EF21 alone (participation 1): the masked tail with no mask, the
    cache integrating every client's quantised delta."""
    ref, _ = lsq
    kw = dict(PATHS[path], algorithm=algo, inner_steps=3, eta=0.3 / ref.L, uplink_bits=4)
    _lsq_run(lsq, kw)


@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_cohort_tile_matches_reference(lsq, algo, tile):
    """``cohort_tile`` runs the cohort's inner loop tile by tile; the
    rounds match the reference's tiled rounds."""
    ref, _ = lsq
    kw = dict(PATHS["cohort"], algorithm=algo, inner_steps=3, eta=0.3 / ref.L,
              participation=0.5, cohort_tile=tile)
    _lsq_run(lsq, kw, rounds=3)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_per_client_eta_under_the_cohort_matches_reference(lsq, algo):
    """A per-client eta tuple: the cohort's rows of eta are gathered with
    its state rows (and tiled with them)."""
    ref, _ = lsq
    eta = tuple(float(e) for e in np.linspace(0.2, 0.4, ref.m) / ref.L)
    kw = dict(PATHS["cohort"], algorithm=algo, inner_steps=3, eta=eta, participation=0.5,
              cohort_tile=2)
    _lsq_run(lsq, kw, rounds=3)


def _softmax_data(F, C, m, B, K, rounds, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((rounds, K, m, B, F)).astype(np.float32)
    ys = np.broadcast_to(np.arange(m, dtype=np.int32)[None, None, :, None] % C,
                         (rounds, K, m, B)).copy()
    return (lambda r: {"x": jnp.asarray(xs[r]), "y": jnp.asarray(ys[r])},
            lambda r: {"x": torch.from_numpy(xs[r]), "y": torch.from_numpy(ys[r])})


@pytest.mark.parametrize("algo,bits", VARIANTS,
                         ids=[f"{a}-{'ef21' if b else 'plain'}" for a, b in VARIANTS])
def test_softmax_cohort_per_step_matches_reference(algo, bits):
    """Small softmax regression (F=16, C=4, m=6, B=8, K=3) with one
    minibatch per inner step: the cohort engine gathers the (K, m, ...)
    batch on axis 1 and runs ``grad_arena`` on the cohort."""
    F, C, m, B, K = 16, 4, 6, 8, 3
    rb, pb = _softmax_data(F, C, m, B, K, R, seed=5)
    rp, pp = RefSoftmax(F, C), SoftmaxRegression(F, C)
    kw = dict(PATHS["cohort"], algorithm=algo, inner_steps=K, eta=0.05, participation=0.5,
              uplink_bits=bits)
    run_both(kw, rp.oracle(), pp.oracle(), rb, pb, np.zeros(pp.dim, np.float32), m,
             per_step=True)


@pytest.mark.parametrize("algo,bits", VARIANTS,
                         ids=[f"{a}-{'ef21' if b else 'plain'}" for a, b in VARIANTS])
def test_cohort_equals_masked_inside_the_port(lsq, algo, bits):
    """The reference's own contract (tests/test_cohort.py) inside the port:
    the cohort round equals the masked full-population round, state by
    state, at f32 resolution relative to each buffer's scale."""
    _, prob = lsq
    runs = {}
    for cohort in (True, False):
        opt = make(FederatedConfig(algorithm=algo, inner_steps=3, eta=0.3 / prob.L,
                                   use_arena=True, participation=0.25, cohort=cohort,
                                   uplink_bits=bits))
        s = opt.init(torch.zeros(prob.d), prob.m)
        runs[cohort] = []
        for _ in range(5):
            s, _ = opt.round(s, prob.oracle(), prob.batch())
            runs[cohort].append(s)
    for r, (sc, sm) in enumerate(zip(runs[True], runs[False])):
        assert sorted(sc) == sorted(sm)
        for k in sc:
            a, b = convert.to_numpy(sm[k]), convert.to_numpy(sc[k])
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b / scale, a / scale, atol=1e-5,
                                       err_msg=f"{algo} round {r}: {k}")


def test_cohort_batch_gathers_or_passes_through():
    """``cohort_batch`` as the reference's: population leaves gathered on
    the client axis (0, or 1 for per-step batches), cohort-sized leaves
    passed through, any other size refused with ValueError."""
    m = 10
    jk = jax.random.fold_in(jax.random.key(3), 2)
    ridx, _ = ref_T.cohort_indices(jk, m, 0.3)
    idx = torch.from_numpy(np.array(ridx)).long()
    rng = np.random.default_rng(0)
    pop = rng.standard_normal((m, 5)).astype(np.float32)
    step = rng.standard_normal((2, m, 5)).astype(np.float32)
    small = rng.standard_normal((3, 5)).astype(np.float32)
    for arr, per_step in ((pop, False), (step, True), (small, False)):
        want = ref_api.cohort_batch({"a": jnp.asarray(arr)}, ridx, m, per_step)["a"]
        got = api.cohort_batch({"a": torch.from_numpy(arr)}, idx, m, per_step)["a"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = rng.standard_normal((4, 5)).astype(np.float32)
    with pytest.raises(ValueError, match="neither"):
        ref_api.cohort_batch(jnp.asarray(bad), ridx, m, False)
    with pytest.raises(ValueError, match="neither"):
        api.cohort_batch(torch.from_numpy(bad), idx, m, False)


def test_cohort_tile_must_divide_the_cohort(lsq):
    _, prob = lsq
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=3, eta=0.3 / prob.L,
                               use_arena=True, participation=0.5, cohort_tile=3))
    s = opt.init(torch.zeros(prob.d), prob.m)
    with pytest.raises(ValueError, match="divide"):
        opt.round(s, prob.oracle(), prob.batch())


@pytest.mark.parametrize("kw", [
    dict(participation=1.0), dict(participation=0.5), dict(participation=0.5, cohort=False),
    dict(participation=0.5, cohort=True), dict(participation=0.99),
    dict(participation=0.5, algorithm="fedsplit"), dict(participation=0.5, algorithm="scaffold"),
])
def test_use_cohort_policy_matches_reference(kw):
    for m in (8, 100):
        assert api.use_cohort(FederatedConfig(**kw), m) == ref_api.use_cohort(RefConfig(**kw), m)


@pytest.mark.parametrize("path", ["arena", "pytree"])
@pytest.mark.parametrize("kw", [dict(participation=0.5), dict(participation=0.5, uplink_bits=8)],
                         ids=["p50", "p50_ef21"])
def test_fedsplit_with_partial_participation_does_what_the_reference_does(lsq, kw, path):
    """The reference's FedSplit does not consult ``participation`` or
    ``uplink_bits``: every client runs every round and the state carries no
    u_hat.  The port does the same."""
    ref, _ = lsq
    kw = dict(kw, algorithm="fedsplit", fedsplit_init="xs", inner_steps=3, eta=0.5 / ref.L,
              use_arena=True if path == "arena" else "auto")
    rs, ps = _lsq_run(lsq, kw, rounds=3)
    assert "u_hat" not in rs and "u_hat" not in ps
    _, full = _lsq_run(lsq, dict(kw, participation=1.0, uplink_bits=None), rounds=3)
    for k in ps:
        np.testing.assert_array_equal(convert.to_numpy(ps[k]), convert.to_numpy(full[k]))


@pytest.mark.parametrize("which", ["pdmm", "fedsplit"])
def test_exact_rounds_ignore_participation_as_the_reference_does(lsq, which):
    """Exact PDMM and exact FedSplit do not consult ``participation`` or
    ``uplink_bits`` in the reference either: with both set, the port's
    rounds are bitwise its full-participation rounds and match the
    reference's (rtol = atol = 1e-5, duals 1e-5 * rho)."""
    ref, prob = lsq
    rmod, pmod = (ref_pdmm, pdmm) if which == "pdmm" else (ref_fedsplit, fedsplit)
    rho = 200.0
    kw = dict(rho=rho, participation=0.5, uplink_bits=8)
    ro, po = rmod.make_exact(RefConfig(**kw)), pmod.make_exact(FederatedConfig(**kw))
    full = pmod.make_exact(FederatedConfig(rho=rho))
    rs, ps = ro.init(jnp.zeros(ref.d), ref.m), po.init(torch.zeros(ref.d), ref.m)
    fs = full.init(torch.zeros(ref.d), ref.m)
    assert sorted(ps) == sorted(rs) == sorted(fs)
    rprox, pprox = ref.make_client_prox(), prob.make_client_prox()
    for _ in range(3):
        rs, _ = ro.round(rs, rprox)
        ps, _ = po.round(ps, pprox)
        fs, _ = full.round(fs, pprox)
        for k in rs:
            if k != "round":
                np.testing.assert_array_equal(ps[k].numpy(), fs[k].numpy(), err_msg=k)
                tol = dict(rtol=1e-5, atol=1e-5 * (rho if k == "lam_s" else 1.0))
                np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]), err_msg=k, **tol)


@pytest.mark.parametrize("path", ["cohort", "pytree"])
@pytest.mark.parametrize("algo", ["gpdmm", "fedavg"])
def test_round_state_carries_u_hat(lsq, algo, path):
    """``convert.round_state`` carries the reference's ``u_hat`` cache
    across; two more rounds on each side then match."""
    ref, prob = lsq
    kw = dict(PATHS[path], algorithm=algo, inner_steps=3, eta=0.3 / ref.L, participation=0.5)
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    arena = kw["use_arena"] is True
    rgrad, pgrad = (ref.oracle(), prob.oracle()) if arena else (ref.grad, prob.grad)
    rs = ro.init(jnp.zeros(ref.d), ref.m)
    for _ in range(2):
        rs, _ = ro.round(rs, rgrad, ref.batch())
    ps = convert.round_state(rs, "cpu")
    assert "u_hat" in ps
    np.testing.assert_array_equal(ps["u_hat"].numpy(), np.asarray(rs["u_hat"]))
    for _ in range(2):
        rs, rm = ro.round(rs, rgrad, ref.batch())
        ps, pm = po.round(ps, pgrad, prob.batch())
        compare(rs, rm, ps, pm, kw)


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_state_keys_and_the_round_counter_key(algo):
    """The state carries ``u_hat`` exactly when the reference's does, and
    the mask of each round is drawn from ``cfg.seed`` and the device round
    counter, as the reference draws it."""
    for kw in (dict(participation=0.5), dict(), dict(participation=0.5, use_arena=True)):
        rs = ref_make(RefConfig(algorithm=algo, **kw)).init(jnp.zeros(4), 6)
        ps = make(FederatedConfig(algorithm=algo, **kw)).init(torch.zeros(4), 6)
        assert sorted(ps) == sorted(rs)
    cfg = FederatedConfig(algorithm=algo, participation=0.5, seed=123)
    for r in (0, 5):
        want = ref_T.participation_mask(ref_participation_key(RefConfig(seed=123), r), 6, 0.5)
        got = gpdmm.participation(cfg, {"round": torch.tensor(r, dtype=torch.int32)}, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.bool
    assert T.cohort_count(6, 0.5) == 3


# ---------------------------------------------------------------------------
# bf16 and nested parameter trees under the cohort engine
# (tests/_torch_parity.py's ``run_trees`` and its tolerances)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "nested"])
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_bf16_cohort_rounds_match_reference(algo, kind):
    """The cohort round (half the clients, gathered and scattered back) on
    bf16 flat and nested trees."""
    run_trees(dict(algorithm=algo, eta=0.1, use_arena=True, cohort=True, participation=0.5),
              kind, "bf16")


def test_nested_batch_reaches_the_client_count_and_the_cohort():
    """A nested batch tree: ``cohort_batch`` gathers every leaf of it and
    FedAvg's client count reads its first leaf, as the reference's do."""
    from repro_torch.core import fedavg

    m = 6
    rng = np.random.default_rng(1)
    batch = {"x": {"u": rng.standard_normal((m, 3)).astype(np.float32)},
             "ys": [rng.standard_normal((m, 2)).astype(np.float32)]}
    ridx, _ = ref_T.cohort_indices(jax.random.key(2), m, 0.5)
    idx = torch.from_numpy(np.array(ridx)).long()
    want = ref_api.cohort_batch(jax.tree.map(jnp.asarray, batch), ridx, m, False)
    got = api.cohort_batch(convert.params(batch, "cpu"), idx, m, False)
    for w, g in zip(jax.tree.leaves(want), T.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert fedavg._num_clients({}, convert.params(batch, "cpu"), False) == m
