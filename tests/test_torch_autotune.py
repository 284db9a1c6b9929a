"""Auto-tuned stepsizes and residual-based early exit in the port
(``repro_torch.core.autotune``, ``api.make_scan_rounds``, kernel 13's plain
version) against the reference (``repro.core.autotune``).

Tolerances:
  * the power iteration against the reference's, rtol 1e-5: the same 96
    normalised batched matvecs, summed in another order on each side (the
    estimates agreed to 3e-7).  Not against ``eigvalsh``: after 96
    iterations the reference itself is 0.67% short on one client of the
    ``wide`` problem, and its own eigvalsh test fails there (ROADMAP §3);
    the 600-iteration runs are held to ``eigvalsh`` at the reference's
    rtol 1e-4;
  * ``residual_norm``'s plain version against ``"xla"`` and
    ``"pallas_interpret"``: rtol 2e-6 sqrt(W / 128), a sum of W f32 squares
    in two orders (as tests/test_torch_faults.py's screen sums), NaN rows
    NaN on both sides;
  * ``state_residual`` against the reference's on the same state: rtol 1e-5
    (sums of several such row sums);
  * rounds at tests/_torch_parity.py's tolerances, round by round;
  * inside the port: ``make_scan_rounds``, the ``tol`` gate and the early-exit
    prefix are state for state bitwise the loop of rounds.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import autotune as ref_autotune
from repro.core import make as ref_make
from repro.core import quadratic as ref_quadratic
from repro.core import softmax as ref_softmax
from repro.core.api import make_oracle as ref_make_oracle
from repro.core.api import make_scan_rounds as ref_scan
from repro.kernels import ops as R
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import autotune, make, make_scan_rounds
from repro_torch.core.api import make_oracle, mean_eta, resolved_rho
from repro_torch.core.softmax import SoftmaxRegression
from repro_torch.kernels import _args, ops

from _torch_parity import compare, configs, run_both

L_RTOL = 1e-5
M = 6


@pytest.fixture(scope="module", params=[24, 144], ids=["narrow", "wide"])
def lsq(request):
    """The reference's autotune problem: m = 6, n = 160; 144 pads to W = 256."""
    ref_prob = ref_quadratic.generate(jax.random.key(3), m=M, n=160, d=request.param)
    return ref_prob, convert.least_squares(ref_prob, "cpu")


def _oracles(ref_prob, prob, form):
    """(reference oracle, port oracle) resolving through step ``form``."""
    if form == "curvature":
        return ref_prob.oracle(), prob.oracle()
    if form == "affine":
        return (ref_make_oracle(ref_prob.grad, affine_arena=ref_prob.oracle().affine_arena),
                make_oracle(prob.grad, affine_arena=prob.oracle().affine_arena))
    if form == "grad_arena":
        return (ref_make_oracle(ref_prob.grad, grad_arena=ref_prob.oracle().grad_arena),
                make_oracle(prob.grad, grad_arena=prob.oracle().grad_arena))
    return ref_prob.grad, prob.grad


# ---------------------------------------------------------------------------
# the stepsizes
# ---------------------------------------------------------------------------

def test_power_iter_arena_matches_reference(lsq):
    ref_prob, prob = lsq
    want = np.asarray(ref_autotune.power_iter_arena(ref_prob.AtA), np.float64)
    got = autotune.power_iter_arena(prob.AtA)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M,)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=L_RTOL)
    long = autotune.power_iter_arena(prob.AtA, iters=600).double().numpy()
    np.testing.assert_allclose(long, np.asarray(ref_prob.evals[:, -1], np.float64), rtol=1e-4)


@pytest.mark.parametrize("form", ["curvature", "affine", "grad_arena", "plain"])
def test_estimate_L_matches_reference_through_every_resolution_step(lsq, form):
    """Each of the four resolution steps, probed at a nonzero point (the
    HVP steps go through ``torch.func.jvp``)."""
    ref_prob, prob = lsq
    ro, po = _oracles(ref_prob, prob, form)
    x = np.linspace(-1.0, 1.0, prob.d).astype(np.float32)
    want = ref_autotune.estimate_L(ro, jnp.asarray(x), M, ref_prob.batch())
    got = autotune.estimate_L(po, torch.from_numpy(x), M, prob.batch())
    assert got.dtype == np.float64 and got.shape == (M,)
    np.testing.assert_allclose(got, want, rtol=L_RTOL)


def test_estimate_L_on_a_dict_tree_matches_reference():
    """The plain-oracle HVP on a two-leaf dict tree (vmapped per-client
    jvp through the tree boundary)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 3.0, (M, 1)).astype(np.float32)
    b = rng.uniform(0.1, 1.0, (M, 1)).astype(np.float32)
    params = {"u": rng.standard_normal(40).astype(np.float32),
              "v": rng.standard_normal((3, 5)).astype(np.float32)}

    def ref_grad(p, bt):
        return {"u": bt["a"][0] * p["u"] ** 3, "v": bt["b"][0] * p["v"]}

    def port_grad(p, bt):
        return {"u": bt["a"][0] * p["u"] ** 3, "v": bt["b"][0] * p["v"]}

    want = ref_autotune.estimate_L(ref_grad, {k: jnp.asarray(v) for k, v in params.items()}, M,
                                   {"a": jnp.asarray(a), "b": jnp.asarray(b)})
    got = autotune.estimate_L(port_grad, {k: torch.from_numpy(v) for k, v in params.items()},
                              M, {"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    np.testing.assert_allclose(got, want, rtol=L_RTOL)


def test_softmax_curvature_hook_matches_reference():
    F, C, B = 20, 4, 12
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, B, F)).astype(np.float32)
    y = rng.integers(0, C, (M, B)).astype(np.int32)
    rs = ref_softmax.SoftmaxRegression(n_features=F, n_classes=C)
    ps = SoftmaxRegression(n_features=F, n_classes=C)
    want = ref_autotune.estimate_L(rs.oracle(), jnp.zeros(rs.dim), M,
                                   {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    got = autotune.estimate_L(ps.oracle(), torch.zeros(ps.dim), M,
                              {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(got, want, rtol=L_RTOL)


@pytest.mark.parametrize("algo", ["gpdmm", "scaffold"])
def test_resolve_matches_reference(lsq, algo):
    ref_prob, prob = lsq
    rcfg = ref_autotune.resolve(RefConfig(algorithm=algo, inner_steps=5, eta="auto"),
                                ref_prob.oracle(), jnp.zeros(ref_prob.d), M, ref_prob.batch())
    cfg = FederatedConfig(algorithm=algo, inner_steps=5, eta="auto")
    got = autotune.resolve(cfg, prob.oracle(), torch.zeros(prob.d), M, prob.batch())
    assert isinstance(got.eta, tuple) and len(got.eta) == M
    np.testing.assert_allclose(np.asarray(got.eta), np.asarray(rcfg.eta), rtol=L_RTOL)
    # a concrete eta is returned as it is
    for eta in (0.1, (0.1,) * M):
        c2 = dataclasses.replace(cfg, eta=eta)
        assert autotune.resolve(c2, prob.oracle(), torch.zeros(prob.d), M, prob.batch()) is c2


def test_derive_eta_and_the_config_forms_match_reference():
    L = np.array([0.0, 1e-14, 0.5, 3.0, 1e4])
    np.testing.assert_array_equal(autotune.derive_eta(L), ref_autotune.derive_eta(L))
    np.testing.assert_array_equal(autotune.derive_eta(L, 0.25),
                                  ref_autotune.derive_eta(L, 0.25))
    assert (autotune.POWER_ITERS, autotune.SAFETY) == (96, 0.5)
    for eta in (0.25, (0.1, 0.2, 0.4)):
        cfg, rcfg = FederatedConfig(eta=eta, inner_steps=5), RefConfig(eta=eta, inner_steps=5)
        assert autotune.mean_eta(cfg) == ref_autotune.mean_eta(rcfg)
        assert mean_eta is autotune.mean_eta
        assert resolved_rho(cfg) == pytest.approx(1.0 / (5 * float(np.mean(eta))), rel=1e-15)
        got, want = autotune.client_eta(cfg), ref_autotune.client_eta(rcfg)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert autotune.scale_eta(cfg, 0.5).eta == ref_autotune.scale_eta(rcfg, 0.5).eta
        assert autotune.scale_eta(cfg, 1.0) is cfg
    with pytest.raises(ValueError, match="2 entries for 3"):
        autotune.client_eta(FederatedConfig(eta=(0.1, 0.2)), m=3)
    for fn in (autotune.client_eta, autotune.mean_eta, resolved_rho):
        with pytest.raises(ValueError, match="resolved host-side"):
            fn(FederatedConfig(eta="auto"))
    with pytest.raises(ValueError, match="resolved host-side"):
        make(FederatedConfig(eta="auto"))


def test_a_kernel_in_the_oracle_is_refused_as_a_jvp_target_by_name():
    """A wrapper handed a tensor off the CPU while an oracle is being
    differentiated raises, naming the oracle (a ctypes kernel cannot carry a
    tangent).  On the CPU the plain versions are differentiable and run."""
    with _args.jvp_target("the oracle 'my_grad'"):
        with pytest.raises(TypeError, match="my_grad.*fused_update_arena.*jvp"):
            ops.fused_update_arena(torch.zeros(2, 128, device="meta"),
                                   torch.zeros(2, 128, device="meta"),
                                   torch.zeros(128, device="meta"), None, 0.1, 1.0)
    assert _args.on_cpu("x", torch.zeros(1))

    def kernel_grad(xa, b):
        return ops.fused_update_arena(xa, xa, torch.zeros(xa.shape[1]), None, 1.0, 0.0)

    oracle = make_oracle(lambda p, b: p, grad_arena=lambda spec: kernel_grad)
    L = autotune.estimate_L(oracle, torch.ones(128), 3, None, iters=4)
    # x - (x + 0) = 0 per step: zero curvature, through the plain version
    np.testing.assert_array_equal(L, 0.0)


# ---------------------------------------------------------------------------
# kernel 13 and the residual metrics
# ---------------------------------------------------------------------------

def _pair(a, dtype):
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a.copy()).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m, w", [(3, 128), (8, 384), (5, 130)])
def test_residual_norm_plain_matches_reference(m, w, dtype, impl):
    rng = np.random.default_rng(m * w)
    x = rng.standard_normal((m, w)).astype(np.float32)
    xp = x + 0.01 * rng.standard_normal((m, w)).astype(np.float32)
    x[1, w // 2] = np.nan
    (xj, xt), (pj, pt) = _pair(x, dtype), _pair(xp, dtype)
    want = [np.asarray(a) for a in R.residual_norm(xj, pj, impl=impl)]
    got = [a.numpy() for a in ops.residual_norm(xt, pt)]
    rtol = 2e-6 * np.sqrt(w / 128)
    for g, wv in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (m,)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(wv))
        assert np.isnan(g[1])
        np.testing.assert_allclose(g, wv, rtol=rtol)


def _states(kw, ref_prob, prob, rounds, oracle=True):
    """(reference states, port states) of ``rounds + 1`` rounds from zero."""
    rcfg, pcfg = configs(kw)
    ro, po = ref_make(rcfg), make(pcfg)
    rg, pg = (ref_prob.oracle(), prob.oracle()) if oracle else (ref_prob.grad, prob.grad)
    rs = [ro.init(jnp.zeros(ref_prob.d), M)]
    ps = [po.init(torch.zeros(prob.d), M)]
    for _ in range(rounds):
        rs.append(ro.round(rs[-1], rg, ref_prob.batch())[0])
        ps.append(po.round(ps[-1], pg, prob.batch())[0])
    return rs, ps


STATE_CASES = {
    "gpdmm_arena": (dict(algorithm="gpdmm", inner_steps=3, use_arena=True), True),
    "scaffold_arena": (dict(algorithm="scaffold", inner_steps=3, use_arena=True), True),
    "agpdmm_pytree": (dict(algorithm="agpdmm", inner_steps=3, use_arena=False), False),
    "fedavg_partial": (dict(algorithm="fedavg", inner_steps=3, use_arena=True,
                            participation=0.5), True),
    "graph_ring": (dict(algorithm="gpdmm_graph", topology="ring", inner_steps=3), True),
    "graph_star": (dict(algorithm="gpdmm_graph", inner_steps=3), True),
}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_state_residual_matches_reference(lsq, case):
    """Arena, pytree and graph states: every 2-D buffer through the
    kernel's plain version, the rest through plain sums, in the
    reference's key and leaf order."""
    ref_prob, prob = lsq
    kw, oracle = STATE_CASES[case]
    rs, ps = _states(dict(kw, eta=0.5 / prob.L), ref_prob, prob, 3, oracle)
    for r in range(3):
        want = ref_autotune.state_residual(rs[r], rs[r + 1])
        got = autotune.state_residual(ps[r], ps[r + 1])
        for k in ("res_dx2", "res_x2"):
            assert got[k].dtype == torch.float32 and got[k].ndim == 0
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    # the metric is the round's true squared step
    dx2 = sum(float(torch.sum((q.double() - p.double()) ** 2))
              for k in autotune.RESIDUAL_KEYS if k in ps[0]
              for p, q in zip(_leaves(ps[0][k]), _leaves(ps[1][k])))
    np.testing.assert_allclose(float(autotune.state_residual(ps[0], ps[1])["res_dx2"]), dx2,
                               rtol=1e-4)


def _leaves(v):
    return [v[k] for k in sorted(v)] if isinstance(v, dict) else [v]


def test_state_residual_rejects_non_dict_states():
    with pytest.raises(TypeError, match="dict"):
        autotune.state_residual(torch.zeros(3), torch.zeros(3))


def test_early_exit_rules_match_reference():
    def both(tol, patience, seq):
        a, b = autotune.EarlyExit(tol, patience), ref_autotune.EarlyExit(tol, patience)
        out = []
        for dx2, x2 in seq:
            g, w = a.update(dx2, x2), b.update(dx2, x2)
            assert g == w and a.hits == b.hits
            assert a.last_rel == b.last_rel
            out.append(g)
        return out

    ee = autotune.EarlyExit(tol=1e-3, patience=2)
    assert ee.update(np.float64(1e-8), np.float64(1.0)) is None
    assert ee.update(np.float64(1.0), np.float64(1.0)) is None  # resets the count
    assert ee.update(np.float64(1e-8), np.float64(1.0)) is None
    assert ee.update(np.float64(1e-8), np.float64(1.0)) == 0
    ee2 = autotune.EarlyExit(tol=1e-3, patience=2)
    assert ee2.update(np.array([1e-8, 1e-8, 1.0]), np.ones(3)) == 1
    assert ee2.last_rel == pytest.approx(1e-4)
    assert autotune.EarlyExit(tol=0.0).update(np.zeros(4), np.ones(4)) is None
    # tensors (a stacked chunk on the device) are read like arrays
    ee3 = autotune.EarlyExit(tol=1e-2)
    assert ee3.update(torch.tensor([1.0, 1e-6]), torch.tensor([1.0, 1.0])) == 1
    rng = np.random.default_rng(5)
    for patience in (1, 2, 3):
        chunks = [rng.choice([1e-9, 1e-3, 1.0], size=rng.integers(1, 4)) for _ in range(20)]
        both(1e-2, patience, [(d, np.ones_like(d)) for d in chunks])


def test_early_exit_is_a_prefix_of_the_fixed_budget_run(lsq):
    _, prob = lsq
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=3, eta=0.5 / prob.L, tol=1e-3,
                          patience=2, use_arena=True)
    fed = make(cfg)
    s0 = fed.init(torch.zeros(prob.d), M)

    def rf(s):
        s2, mets = fed.round(s, prob.oracle(), prob.batch())
        return s2, {**mets, **autotune.state_residual(s, s2)}

    ee = autotune.EarlyExit(cfg.tol, cfg.patience)
    s, stop_at = s0, None
    for r in range(1, 201):
        s, mets = rf(s)
        if ee.update(mets["res_dx2"], mets["res_x2"]) is not None:
            stop_at = r
            break
    assert stop_at is not None and stop_at < 200, "the tracker never fired"
    assert float(prob.dist(fed.server_params(s))) < 1.0
    s_full = s0
    for _ in range(stop_at):
        s_full, _ = fed.round(s_full, prob.oracle(), prob.batch())
    for k in s:
        assert torch.equal(s[k], s_full[k]), k


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_scan_rounds_equal_the_loop_and_tol_changes_no_state(lsq, algo):
    ref_prob, prob = lsq
    cfg = FederatedConfig(algorithm=algo, inner_steps=3, eta=0.5 / prob.L, use_arena=True)
    fed = make(cfg)
    R_ = 5
    batches = {k: v[None].expand((R_,) + tuple(v.shape)) for k, v in prob.batch().items()}
    s0 = fed.init(torch.zeros(prob.d), M)
    s_plain, m_plain = make_scan_rounds(fed, prob.oracle())(s0, batches)
    s_res, m_res = make_scan_rounds(fed, prob.oracle(), tol=1e-6)(s0, batches)
    assert "res_dx2" not in m_plain and tuple(m_res["res_dx2"].shape) == (R_,)
    s_loop = s0
    for r in range(R_):
        prev = s_loop
        s_loop, ml = fed.round(s_loop, prob.oracle(), prob.batch())
        for k in ml:
            assert torch.equal(m_plain[k][r], ml[k]), k
        res = autotune.state_residual(prev, s_loop)
        assert torch.equal(m_res["res_dx2"][r], res["res_dx2"])
    for s in (s_plain, s_res):
        assert sorted(s) == sorted(s_loop)
        for k in s_loop:
            got, want = _leaves(s[k]), _leaves(s_loop[k])
            assert all(torch.equal(a, b) for a, b in zip(got, want)), k
    # the reference's make_scan_rounds with tol > 0: the same residual rows
    rcfg = configs(dict(algorithm=algo, inner_steps=3, eta=0.5 / prob.L, use_arena=True))[0]
    rfed = ref_make(rcfg)
    rb = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (R_,) + a.shape), ref_prob.batch())
    rs, rm = ref_scan(rfed, ref_prob.oracle(), tol=1e-6)(rfed.init(jnp.zeros(ref_prob.d), M), rb)
    compare(rs, {}, s_res, {}, cfg)
    for k in ("res_dx2", "res_x2"):
        np.testing.assert_allclose(m_res[k].numpy(), np.asarray(rm[k]), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# rounds at the auto-derived stepsizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo, use_arena", [("gpdmm", True), ("agpdmm", True),
                                             ("scaffold", True), ("fedavg", True),
                                             ("gpdmm", False)])
def test_auto_eta_rounds_match_reference(lsq, algo, use_arena):
    """The port's resolved tuple agrees with the reference's (rtol 1e-5);
    the rounds at the reference's tuple agree round by round."""
    ref_prob, prob = lsq
    rcfg = ref_autotune.resolve(RefConfig(algorithm=algo, inner_steps=4, eta="auto"),
                                ref_prob.oracle(), jnp.zeros(ref_prob.d), M, ref_prob.batch())
    cfg = autotune.resolve(FederatedConfig(algorithm=algo, inner_steps=4, eta="auto"),
                           prob.oracle(), torch.zeros(prob.d), M, prob.batch())
    np.testing.assert_allclose(np.asarray(cfg.eta), np.asarray(rcfg.eta), rtol=L_RTOL)
    run_both(dict(algorithm=algo, inner_steps=4, eta=rcfg.eta, use_arena=use_arena), ref_prob,
             prob, 6)


def test_auto_eta_converges_at_least_as_well_as_the_hand_tuned_eta(lsq):
    """The reference's claim, in the port: per-client eta_i = safety / L_i
    lands at least as close as the one global safety / max_i L_i."""
    _, prob = lsq
    oracle, x0 = prob.oracle(), torch.zeros(prob.d)

    def dist_after(cfg, rounds=120):
        fed = make(cfg)
        s = fed.init(x0, M)
        for _ in range(rounds):
            s, _ = fed.round(s, oracle, prob.batch())
        return float(prob.dist(fed.server_params(s)))

    base = FederatedConfig(algorithm="gpdmm", inner_steps=5, eta="auto", use_arena=True)
    d_auto = dist_after(autotune.resolve(base, oracle, x0, M, prob.batch()))
    d_hand = dist_after(dataclasses.replace(base, eta=autotune.SAFETY / prob.L))
    assert d_auto < 1e-2, d_auto
    assert d_auto <= d_hand * 1.1 + 1e-6, (d_auto, d_hand)
