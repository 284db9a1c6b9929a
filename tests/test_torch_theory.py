"""The convergence-theory instruments of the port (``core.theory``) and the
least-squares pieces they read (``LeastSquares.lam_star``, ``prox_fn``,
``with_ridge``) against the reference, on problems carried across by
``repro_torch.convert`` (tests/test_theory.py's sizes: m = 6, n = 80,
d = 16).

Tolerances: ``gpdmm_beta`` and ``gpdmm_gammas`` are the same Python float
arithmetic on both sides, so they are compared exactly.  ``q_functional``
and ``kkt_residuals`` on the same arrays sum in other orders (rtol 1e-6,
a few f32 roundings of sums of squares).  Along trajectories the iterates
differ by the rounds' rounding (rtol 1e-4 on Q, whose terms are squared
distances that fall by orders of magnitude, so each is held relative to
Q^0 as well).  ``with_ridge`` solves in float64 and casts back, the
reference in f32: x* within 1e-4 of its largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make, quadratic as ref_quadratic, theory as ref_theory
from repro.core import tree_util as ref_T
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import arena, make, prng, quadratic, resolved_rho, theory
from repro_torch.core import tree_util as T


@pytest.fixture(scope="module")
def lsq():
    ref = ref_quadratic.generate(jax.random.key(3), m=6, n=80, d=16)
    return ref, convert.least_squares(ref, "cpu")


GRID = [(L, mu, eta_f, rho)
        for L, mu in ((10.0, 1.0), (250.0, 0.5), (4.0, 4.0))
        for eta_f in (0.1, 0.5, 0.9)
        for rho in (0.3, 2.0, 40.0)]


@pytest.mark.parametrize("L,mu,eta_f,rho", GRID)
def test_beta_and_gammas_equal_reference(L, mu, eta_f, rho):
    """Bit for bit on the grid, including the cases the theorem's
    preconditions refuse (both sides raise)."""
    eta = eta_f / L
    for theta, phi in ((0.5, 0.5), (0.2, 0.9)):
        assert (theory.gpdmm_gammas(L, mu, eta, rho, theta, phi)
                == ref_theory.gpdmm_gammas(L, mu, eta, rho, theta, phi))
        try:
            want = ref_theory.gpdmm_beta(L, mu, eta, rho, theta, phi)
        except AssertionError:
            with pytest.raises(AssertionError):
                theory.gpdmm_beta(L, mu, eta, rho, theta, phi)
            continue
        assert theory.gpdmm_beta(L, mu, eta, rho, theta, phi) == want


def test_beta_bound_valid(lsq):
    _, prob = lsq
    eta = 0.5 / prob.L
    beta = theory.gpdmm_beta(prob.L, prob.mu, eta, 1.0 / (5 * eta))
    assert 0.0 < beta < 1.0


def test_instruments_agree_with_reference_on_the_same_arrays(lsq):
    ref, prob = lsq
    rng = np.random.default_rng(0)
    m, d = ref.m, ref.d
    arrs = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("x_c_prev", (m, d)), ("x_bar", (m, d)), ("lam_is", (m, d)),
                         ("x_s", (d,)), ("lam_s", (m, d)))}
    kw = dict(algorithm="gpdmm", inner_steps=5, eta=0.5 / ref.L)
    common = dict(L=ref.L, mu=ref.mu, theta=0.4, phi=0.6)
    want = ref_theory.q_functional(
        RefConfig(**kw), x_c_prev=jnp.asarray(arrs["x_c_prev"]), x_bar=jnp.asarray(arrs["x_bar"]),
        lam_is=jnp.asarray(arrs["lam_is"]), x_star=ref.x_star, lam_star=ref.lam_star(), **common)
    got = theory.q_functional(
        FederatedConfig(**kw), x_c_prev=torch.from_numpy(arrs["x_c_prev"]),
        x_bar=torch.from_numpy(arrs["x_bar"]), lam_is=torch.from_numpy(arrs["lam_is"]),
        x_star=prob.x_star, lam_star=prob.lam_star(), **common)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    rk = ref_theory.kkt_residuals(ref, jnp.asarray(arrs["x_s"]), jnp.asarray(arrs["lam_s"]))
    pk = theory.kkt_residuals(prob, torch.from_numpy(arrs["x_s"]),
                              torch.from_numpy(arrs["lam_s"]))
    assert sorted(pk) == sorted(rk)
    for k in rk:
        # the gap is F(x) - F*, sums of ~1e4 terms: its rounding is F's
        atol = 1e-6 * float(abs(ref.f_star)) if k == "primal_gap" else 0.0
        np.testing.assert_allclose(float(pk[k]), float(rk[k]), rtol=1e-6, atol=atol, err_msg=k)


def test_lam_star_prox_and_ridge_match_reference(lsq):
    ref, prob = lsq
    np.testing.assert_allclose(convert.to_numpy(prob.lam_star()), np.asarray(ref.lam_star()),
                               rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(ref.d).astype(np.float32)
    i, rho = 2, 3.5
    want = ref.prox_fn()(ref.evals[i], ref.evecs[i], ref.Atb[i], jnp.asarray(v), rho)
    got = prob.prox_fn()(prob.evals[i], prob.evecs[i], prob.Atb[i], torch.from_numpy(v), rho)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the prox is the argmin: its gradient vanishes there
    g = prob.AtA[i] @ got - prob.Atb[i] + rho * (got - torch.from_numpy(v))
    assert float(torch.linalg.vector_norm(g)) < 1e-3 * float(torch.linalg.vector_norm(prob.Atb[i]))
    rr, pr = ref.with_ridge(0.7), prob.with_ridge(0.7)
    assert (pr.L, pr.mu, pr.reg) == (rr.L, rr.mu, rr.reg)
    assert pr.x_star.dtype == torch.float32 and pr.f_star.dtype == torch.float32
    xs = np.asarray(rr.x_star)
    np.testing.assert_allclose(pr.x_star.numpy(), xs, rtol=0, atol=1e-4 * np.abs(xs).max())
    np.testing.assert_allclose(float(pr.f_star), float(rr.f_star), rtol=1e-5)
    # the ridge optimum zeroes the ridge gradient (in float64)
    H = prob.AtA.double().sum(0) + prob.m * 0.7 * torch.eye(prob.d, dtype=torch.float64)
    res = H @ pr.x_star.double() - prob.Atb.double().sum(0)
    assert float(torch.linalg.vector_norm(res)) < 1e-4 * float(torch.linalg.vector_norm(
        prob.Atb.double().sum(0)))
    np.testing.assert_allclose(convert.to_numpy(pr.lam_star()).sum(0), 0.0,
                               atol=1e-3 * float(prob.Atb.abs().max()))


@pytest.mark.parametrize("seed", [0, 3])
def test_split_and_normal_are_jax_draws(seed):
    """``prng.split(k, num=3)`` is jax's split bit for bit; ``prng.normal``
    takes jax's uniform bits and differs only by torch's ``erfinv``: within
    6e-6 of max(1, |x|), 3e-5 absolute in the tails."""
    ks = jax.random.split(jax.random.key(seed), 3)
    pk = prng.split(prng.key(seed), num=3)
    for a, b in zip(ks, pk):
        d = jax.random.key_data(a)
        assert (int(d[0]), int(d[1])) == (int(b[0]), int(b[1]))
    want = np.asarray(jax.random.normal(ks[0], (10, 400, 64), dtype=jnp.float32)).ravel()
    got = prng.normal(pk[0], want.size).numpy()
    err = np.abs(got - want)
    assert float((err / np.maximum(np.abs(want), 1.0)).max()) < 6e-6
    assert float(err.max()) < 3e-5


def test_generate_from_key_is_the_reference_problem():
    """``quadratic.generate_from_key(prng.key(3), ...)`` builds
    benchmarks/theory_rate.py's problem: the reference's data up to the
    normal draw's few roundings, carried through the Gram sums (L, mu and
    x* within 1e-5 relative)."""
    ref = ref_quadratic.generate(jax.random.key(3), m=10, n=400, d=64)
    got = quadratic.generate_from_key(prng.key(3), m=10, n=400, d=64, device="cpu")
    np.testing.assert_allclose(got.L, ref.L, rtol=1e-5)
    np.testing.assert_allclose(got.mu, ref.mu, rtol=1e-5)
    for f in ("AtA", "Atb", "btb", "x_star"):
        want = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(convert.to_numpy(getattr(got, f)), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=f)


def _q_trajectory(make_fn, cfg, grad, batch, prob, rounds, x0, m, *, device_args):
    """Q^r over ``rounds`` traced GPDMM rounds from x0."""
    opt = make_fn(cfg)
    s = opt.init(x0, m)
    lam_star = prob.lam_star()
    x_c_prev = device_args["broadcast"](x0, m)
    qs = []
    for _ in range(rounds):
        s, met = opt.round(s, grad, batch, return_trace=True)
        tr = met["trace"]
        qs.append(float(device_args["q"](cfg, x_c_prev=x_c_prev, x_bar=tr["x_bar"],
                                         lam_is=tr["lam_is"], x_star=prob.x_star,
                                         lam_star=lam_star, L=prob.L, mu=prob.mu)))
        x_c_prev = tr["x_K"]
    return np.asarray(qs)


@pytest.mark.parametrize("use_arena", [False, True], ids=["pytree", "arena"])
def test_q_functional_linear_decay_matches_reference(lsq, use_arena):
    """Q^{r+1} <= beta Q^r along the port's GPDMM trajectory (Theorem 1),
    on the pytree path (the reference's default at this width, plain grad)
    and the arena (the fused oracle), and the port's Q^r the reference's."""
    ref, prob = lsq
    K, eta = 5, 0.5 / ref.L
    kw = dict(algorithm="gpdmm", inner_steps=K, eta=eta, use_avg=True, use_arena=use_arena)
    rho = resolved_rho(FederatedConfig(**kw))
    beta = theory.gpdmm_beta(prob.L, prob.mu, eta, rho)
    assert beta == ref_theory.gpdmm_beta(ref.L, ref.mu, eta, rho)
    rounds = 25
    qp = _q_trajectory(make, FederatedConfig(**kw), prob.oracle() if use_arena else prob.grad,
                       prob.batch(), prob, rounds, torch.zeros(prob.d), prob.m,
                       device_args=dict(broadcast=T.tree_broadcast, q=theory.q_functional))
    qr = _q_trajectory(ref_make, RefConfig(**kw), ref.oracle() if use_arena else ref.grad,
                       ref.batch(), ref, rounds, jnp.zeros(ref.d), ref.m,
                       device_args=dict(broadcast=ref_T.tree_broadcast,
                                        q=ref_theory.q_functional))
    ratios = qp[1:] / np.maximum(qp[:-1], 1e-30)
    assert np.all(ratios <= beta + 1e-3), (ratios.max(), beta)
    assert qp[-1] < qp[0] * beta ** (rounds - 1) * 10
    np.testing.assert_allclose(qp, qr, rtol=1e-4, atol=1e-6 * qr[0])


def test_kkt_residuals_vanish(lsq):
    """300 arena rounds: the three residuals of eq. (7) to the reference
    test's thresholds."""
    _, prob = lsq
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=5, eta=0.5 / prob.L,
                               use_arena=True))
    s = opt.init(torch.zeros(prob.d), prob.m)
    grad, batch = prob.grad, prob.batch()
    for _ in range(300):
        s, _ = opt.round(s, grad, batch)
    spec = arena.ArenaSpec.from_tree(s["x_s"])
    res = theory.kkt_residuals(prob, s["x_s"], spec.unpack_stacked(s["lam_s"]))
    assert float(res["dual_sum"]) < 1e-3
    assert float(res["primal_gap"]) < 1e-2
    assert float(res["grad_match"]) < 1e-1


def test_sublinear_general_convex():
    """mu = 0 (rank-deficient clients, data drawn by the reference's key
    and carried across): the optimality gap trends like O(1/R) --
    gap(2R) <~ 0.75 gap(R)."""
    key = jax.random.key(7)
    m, n, d = 4, 10, 24  # n < d: each client is rank-deficient => mu = 0
    A = np.asarray(jax.random.normal(key, (m, n, d)), np.float64)
    y0 = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (d,)), np.float64)
    b = np.einsum("mnd,d->mn", A, y0)
    AtA = np.einsum("mnd,mne->mde", A, A)
    Atb = np.einsum("mnd,mn->md", A, b)
    H, g = AtA.sum(0), Atb.sum(0)
    x_star = np.linalg.pinv(H) @ g
    c0 = 0.5 * np.einsum("mn,mn->", b, b)
    f_star = 0.5 * x_star @ H @ x_star - g @ x_star + c0
    L = float(np.linalg.eigvalsh(AtA).max())

    def gap(x):
        x = x.double().numpy()
        return float(0.5 * x @ H @ x - g @ x + c0 - f_star)

    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=3, eta=0.5 / L))
    s = opt.init(torch.zeros(d), m)
    batch = {"AtA": torch.from_numpy(AtA.astype(np.float32)),
             "Atb": torch.from_numpy(Atb.astype(np.float32))}

    def grad(x, cb):
        return cb["AtA"] @ x - cb["Atb"]

    gaps = {}
    for r in range(1, 241):
        s, _ = opt.round(s, grad, batch)
        if r in (60, 120, 240):
            gaps[r] = gap(opt.server_params(s))
    assert gaps[120] < 0.75 * gaps[60] + 1e-12, gaps
    assert gaps[240] < 0.75 * gaps[120] + 1e-12, gaps
