"""The paper's baselines (SCAFFOLD, FedAvg, Inexact FedSplit), the per-leaf
pytree path of GPDMM/AGPDMM and SVRG in the port, against the reference,
round by round, on problems carried across by ``repro_torch.convert``.

Sizes are those of tests/test_conformance.py: m = 6, n = 80, d = 24
(W = 128) and d = 130 (W = 256, 126 zero-padded columns).  Both widths are
below ``arena_min_width``, so ``use_arena="auto"`` takes the pytree path
with ``prob.grad``; ``use_arena=True`` with ``prob.oracle()`` takes the
arena and, at these widths, the fused affine inner loop on both sides.

Tolerances, as tests/test_torch_round.py states them: rtol = atol = 1e-5 on
x-level values (the gradient's matvec and the client mean sum in another
order on each side, so the runs differ by rounding).  Duals are rho times
a difference of x-level values, so lam_s and lam_sum_norm get atol =
1e-5 * rho; SCAFFOLD's control variates are (x_s - x_K) / (K eta), so c,
c_i and c_sum_norm get atol = 1e-5 / (K eta).  lam_sum_norm and
c_sum_norm are zero in exact arithmetic; both sides report rounding noise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import fedsplit as ref_fedsplit, make as ref_make, pdmm as ref_pdmm
from repro.core import quadratic as ref_quadratic
from repro.core.softmax import SoftmaxRegression as RefSoftmax
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import fedsplit, make, pdmm, quadratic, resolved_rho, scaffold
from repro_torch.core.softmax import SoftmaxRegression

from _torch_parity import run_trees

R = 4
PATHS = {"arena": True, "pytree": "auto"}


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    ref = ref_quadratic.generate(jax.random.key(0), m=6, n=80, d=request.param)
    return ref, convert.least_squares(ref, "cpu")


def _scales(cfg_kw):
    """(dual scale rho, control-variate scale 1/(K eta)) for the tolerances."""
    cfg = FederatedConfig(**cfg_kw)
    eta = np.mean(cfg.eta) if isinstance(cfg.eta, tuple) else cfg.eta
    return resolved_rho(cfg), 1.0 / (cfg.inner_steps * eta)


def _tol(key, rho, alpha):
    if key in ("lam_s", "lam_sum_norm"):
        return dict(rtol=1e-5, atol=1e-5 * rho)
    if key in ("c", "c_i", "c_sum_norm"):
        return dict(rtol=1e-5, atol=1e-5 * alpha)
    return dict(rtol=1e-5, atol=1e-5)


def compare(rs, rm, ps, pm, kw, used_arena):
    rho, alpha = _scales(kw)
    assert sorted(ps) == sorted(rs)
    for k in rs:
        if k == "round":
            assert int(ps[k]) == int(rs[k])
            continue
        want, got = rs[k], convert.to_numpy(ps[k])
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for leaf in want:
                np.testing.assert_allclose(got[leaf], np.asarray(want[leaf]),
                                           err_msg=f"{k}[{leaf}]", **_tol(k, rho, alpha))
        else:
            np.testing.assert_allclose(got, np.asarray(want), err_msg=k, **_tol(k, rho, alpha))
    assert sorted(pm) == sorted(rm)
    for k in rm:
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), err_msg=k, **_tol(k, rho, alpha))
    assert float(pm["used_arena"]) == float(used_arena)


def run_both(kw, rgrad, pgrad, rbatch, pbatch, params, m, *, per_step=False, rounds=R,
             ref_state=None):
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    if ref_state is None:
        rs, ps = ro.init(jnp.asarray(params), m), po.init(torch.from_numpy(params.copy()), m)
    else:
        rs, ps = ref_state, convert.round_state(ref_state, "cpu")
    for r in range(rounds):
        rb = rbatch(r) if callable(rbatch) else rbatch
        pb = pbatch(r) if callable(pbatch) else pbatch
        rs, rm = ro.round(rs, rgrad, rb, per_step)
        ps, pm = po.round(ps, pgrad, pb, per_step)
        compare(rs, rm, ps, pm, kw, used_arena=kw["use_arena"] is True)
    return rs, ps


def _lsq_run(lsq, kw, rounds=R, ref_state=None):
    ref, prob = lsq
    arena = kw["use_arena"] is True
    return run_both(kw, ref.oracle() if arena else ref.grad,
                    prob.oracle() if arena else prob.grad, ref.batch(), prob.batch(),
                    np.zeros(ref.d, np.float32), ref.m, rounds=rounds, ref_state=ref_state)


BASELINES = {
    "scaffold": dict(algorithm="scaffold"),
    "scaffold_eta_g": dict(algorithm="scaffold", eta_g=0.7),
    "fedavg": dict(algorithm="fedavg"),
    "fedsplit_z": dict(algorithm="fedsplit", fedsplit_init="z"),
    "fedsplit_xs": dict(algorithm="fedsplit", fedsplit_init="xs"),
}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_rounds_match_reference(lsq, name, path):
    ref, _ = lsq
    kw = dict(BASELINES[name], inner_steps=3, eta=0.5 / ref.L, use_arena=PATHS[path])
    _lsq_run(lsq, kw)


@pytest.mark.parametrize("eta_kind", ["scalar", "tuple"])
@pytest.mark.parametrize("algo,use_avg", [("gpdmm", True), ("gpdmm", False),
                                          ("agpdmm", True)])
def test_pytree_gpdmm_rounds_match_reference(lsq, algo, use_avg, eta_kind):
    """The per-leaf path of GPDMM/AGPDMM (one ``fused_update`` per leaf and
    step); a tuple eta rides the kernel as a per-client (m, 1) step."""
    ref, _ = lsq
    eta = 0.5 / ref.L
    if eta_kind == "tuple":
        eta = tuple(float(e) for e in np.linspace(0.3, 0.6, ref.m) / ref.L)
    kw = dict(algorithm=algo, inner_steps=5, eta=eta, use_avg=use_avg, use_arena="auto")
    _lsq_run(lsq, kw)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("algo", ["scaffold", "fedavg"])
def test_per_client_eta_rounds_match_reference(lsq, algo, path):
    """A per-client eta tuple: an (m,) step in the affine kernel, (m, 1) on
    the pytree path, and SCAFFOLD's (m,) alpha = 1/(K eta_i)."""
    ref, _ = lsq
    eta = tuple(float(e) for e in np.linspace(0.3, 0.6, ref.m) / ref.L)
    _lsq_run(lsq, dict(algorithm=algo, inner_steps=3, eta=eta, use_arena=PATHS[path]))


def test_fsdp_layout_rides_the_pytree_path(lsq):
    ref, _ = lsq
    kw = dict(algorithm="gpdmm", inner_steps=3, eta=0.5 / ref.L, use_arena=True,
              layout="fsdp")
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rs, ps = ro.init(jnp.zeros(ref.d), ref.m), po.init(torch.zeros(ref.d), ref.m)
    rs, rm = ro.round(rs, ref.grad, ref.batch())
    ps, pm = po.round(ps, lsq[1].grad, lsq[1].batch())
    compare(rs, rm, ps, pm, kw, used_arena=False)


@pytest.mark.parametrize("algo", ["scaffold", "fedavg", "fedsplit"])
def test_plain_grad_on_arena_matches_reference(lsq, algo):
    """A plain per-client grad on the arena: one ``fused_update_arena`` (or,
    for FedSplit, ``fused_update``) per step, SCAFFOLD's lam = c - c_i."""
    ref, prob = lsq
    kw = dict(algorithm=algo, inner_steps=3, eta=0.5 / ref.L, use_arena=True)
    run_both(kw, ref.grad, prob.grad, ref.batch(), prob.batch(),
             np.zeros(ref.d, np.float32), ref.m)


def _softmax_data(F, C, m, B, K, rounds, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((rounds, K, m, B, F)).astype(np.float32)
    ys = np.broadcast_to(np.arange(m, dtype=np.int32)[None, None, :, None] % C,
                         (rounds, K, m, B)).copy()
    return (lambda r: {"x": jnp.asarray(xs[r]), "y": jnp.asarray(ys[r])},
            lambda r: {"x": torch.from_numpy(xs[r]), "y": torch.from_numpy(ys[r])})


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kw", [dict(algorithm="scaffold"), dict(algorithm="fedavg"),
                                dict(algorithm="fedsplit", fedsplit_init="xs"),
                                dict(algorithm="gpdmm", variance_reduction="svrg"),
                                dict(algorithm="agpdmm", variance_reduction="svrg")],
                         ids=["scaffold", "fedavg", "fedsplit_xs", "gpdmm_svrg",
                              "agpdmm_svrg"])
def test_softmax_per_step_rounds_match_reference(kw, path):
    """Small softmax regression (F=16, C=4, m=4, B=8, K=3) with one
    minibatch per inner step: ``grad_arena`` on the arena, the vmapped
    ``grad`` on the pytree path.  SVRG corrects each step with the round's
    server iterate as snapshot."""
    F, C, m, B, K = 16, 4, 4, 8, 3
    rb, pb = _softmax_data(F, C, m, B, K, R, seed=3)
    rp, pp = RefSoftmax(F, C), SoftmaxRegression(F, C)
    kw = dict(kw, inner_steps=K, eta=0.05, use_arena=PATHS[path])
    run_both(kw, rp.oracle() if path == "arena" else rp.grad,
             pp.oracle() if path == "arena" else pp.grad, rb, pb,
             np.zeros(pp.dim, np.float32), m, per_step=True)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_svrg_rounds_match_reference(algo, path):
    """SVRG through a plain grad on a dict tree (after tests/test_arena.py's
    SVRG parity): on the arena through the tree boundary."""
    m, K = 4, 3
    rng = np.random.default_rng(5)
    w = rng.standard_normal((R, K, m, 16)).astype(np.float32)

    def grad_fn(x, b):
        return {"a": 0.3 * x["a"] + 0.01 * b["w"][:7], "b": 0.2 * x["b"] - 0.01 * b["w"][7:]}

    params = {"a": np.zeros(7, np.float32), "b": np.zeros(9, np.float32)}
    kw = dict(algorithm=algo, inner_steps=K, eta=0.1, variance_reduction="svrg",
              use_arena=PATHS[path])
    ro, po = ref_make(RefConfig(**kw)), make(FederatedConfig(**kw))
    rs = ro.init({k: jnp.asarray(v) for k, v in params.items()}, m)
    ps = po.init({k: torch.from_numpy(v.copy()) for k, v in params.items()}, m)
    for r in range(R):
        rs, rm = ro.round(rs, grad_fn, {"w": jnp.asarray(w[r])}, True)
        ps, pm = po.round(ps, grad_fn, {"w": torch.from_numpy(w[r])}, True)
        compare(rs, rm, ps, pm, kw, used_arena=path == "arena")


def test_svrg_needs_per_step_batches(lsq):
    ref, prob = lsq
    opt = make(FederatedConfig(algorithm="gpdmm", variance_reduction="svrg",
                               eta=0.5 / ref.L))
    with pytest.raises(ValueError, match="per-step"):
        opt.round(opt.init(torch.zeros(ref.d), ref.m), prob.grad, prob.batch())


# ---------------------------------------------------------------------------
# the paper's identities, in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("algo", ["agpdmm", "scaffold", "fedavg"])
def test_k1_reduces_to_gd(lsq, algo, path):
    """Paper (27)/(31): with K = 1, rho = 1/eta (the default) and eta_g = 1,
    AGPDMM, SCAFFOLD and FedAvg are gradient descent with stepsize eta,
    round by round (atol 5e-5, as tests/test_conformance.py)."""
    _, prob = lsq
    eta = 0.5 / prob.L
    arena = PATHS[path] is True
    opt = make(FederatedConfig(algorithm=algo, inner_steps=1, eta=eta, use_arena=PATHS[path]))
    grad = prob.oracle() if arena else prob.grad
    s = opt.init(torch.zeros(prob.d), prob.m)
    xg = torch.zeros(prob.d)
    for r in range(8):
        s, metrics = opt.round(s, grad, prob.batch())
        g = (torch.einsum("mde,e->d", prob.AtA, xg) - prob.Atb.sum(0)) / prob.m
        xg = xg - eta * g
        np.testing.assert_allclose(opt.server_params(s).numpy(), xg.numpy(), atol=5e-5,
                                   err_msg=f"{algo}/{path} leaves GD at round {r}")
    assert float(metrics["used_arena"]) == float(arena)


def test_k1_all_algorithms_identical(lsq):
    _, prob = lsq
    finals = {}
    for algo in ("agpdmm", "scaffold", "fedavg"):
        for path, ua in PATHS.items():
            opt = make(FederatedConfig(algorithm=algo, inner_steps=1, eta=0.5 / prob.L,
                                       use_arena=ua))
            s = opt.init(torch.zeros(prob.d), prob.m)
            for _ in range(8):
                s, _ = opt.round(s, prob.oracle() if ua is True else prob.grad, prob.batch())
            finals[(algo, path)] = s["x_s"].numpy()
    first = finals[("agpdmm", "arena")]
    for key, got in finals.items():
        np.testing.assert_allclose(got, first, atol=5e-5, err_msg=str(key))


@pytest.fixture(scope="module")
def lsq_core():
    """tests/test_core.py's problem: m = 8, n = 120, d = 24."""
    ref = ref_quadratic.generate(jax.random.key(0), m=8, n=120, d=24)
    return ref, convert.least_squares(ref, "cpu")


def test_pdmm_equals_fedsplit_exact(lsq_core):
    """Paper SIII-B: exact PDMM == exact FedSplit on the star graph
    (atol 1e-5, as tests/test_core.py), and both converge."""
    _, prob = lsq_core
    cfg = FederatedConfig(rho=200.0)
    prox = prob.make_client_prox()
    p, f = pdmm.make_exact(cfg), fedsplit.make_exact(cfg)
    x0 = torch.zeros(prob.d)
    sp, sf = p.init(x0, prob.m), f.init(x0, prob.m)
    for r in range(15):
        sp, _ = p.round(sp, prox)
        sf, _ = f.round(sf, prox)
        np.testing.assert_allclose(sp["x_s"].numpy(), sf["x_s"].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"trajectories part at round {r}")
    assert float(prob.gap(sp["x_s"])) < 1e-2


@pytest.mark.parametrize("which", ["pdmm", "fedsplit"])
def test_exact_rounds_match_reference(lsq_core, which):
    """Exact PDMM and exact FedSplit against the reference's, with the
    closed-form prox on both sides: rtol = atol = 1e-5 (x-level), and
    1e-5 * rho on PDMM's duals."""
    ref, prob = lsq_core
    rmod, pmod = (ref_pdmm, pdmm) if which == "pdmm" else (ref_fedsplit, fedsplit)
    rho = 200.0
    ro, po = rmod.make_exact(RefConfig(rho=rho)), pmod.make_exact(FederatedConfig(rho=rho))
    rs, ps = ro.init(jnp.zeros(ref.d), ref.m), po.init(torch.zeros(ref.d), ref.m)
    rprox, pprox = ref.make_client_prox(), prob.make_client_prox()
    for _ in range(5):
        rs, rm = ro.round(rs, rprox)
        ps, pm = po.round(ps, pprox)
        for k in rs:
            if k != "round":
                tol = dict(rtol=1e-5, atol=1e-5 * (rho if k == "lam_s" else 1.0))
                np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]), err_msg=k, **tol)
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5, atol=1e-5 * rho)


def test_client_prox_matches_reference(lsq_core):
    ref, prob = lsq_core
    v = np.random.default_rng(2).standard_normal((ref.m, ref.d)).astype(np.float32)
    rho = np.linspace(1.0, 50.0, ref.m).astype(np.float32)
    for r_ref, r_port in ((7.5, 7.5), (jnp.asarray(rho), torch.from_numpy(rho))):
        np.testing.assert_allclose(
            prob.make_client_prox()(torch.from_numpy(v), r_port).numpy(),
            np.asarray(ref.make_client_prox()(jnp.asarray(v), r_ref)), rtol=1e-5, atol=1e-5)
    idx = np.array([5, 1, 2])
    np.testing.assert_allclose(
        prob.make_client_prox()(torch.from_numpy(v[idx]), 3.0, torch.from_numpy(idx)).numpy(),
        np.asarray(ref.make_client_prox()(jnp.asarray(v[idx]), 3.0, jnp.asarray(idx))),
        rtol=1e-5, atol=1e-5)


def test_inexact_fedsplit_bad_init_stalls(lsq_core):
    """Fig. 1 at test size (tests/test_core.py): with K = 3 the improper
    z init stalls an order of magnitude above the x_s init, which reaches
    the f32 gap floor."""
    _, prob = lsq_core
    gaps = {}
    for init in ("z", "xs"):
        opt = make(FederatedConfig(algorithm="fedsplit", inner_steps=3, eta=1.0 / prob.L,
                                   fedsplit_init=init, rho=prob.L / 10))
        s = opt.init(torch.zeros(prob.d), prob.m)
        for _ in range(200):
            s, _ = opt.round(s, prob.grad, prob.batch())
        gaps[init] = float(prob.gap(s["x_s"]))
    assert gaps["xs"] < 1e-2, gaps
    assert gaps["z"] > 10 * max(gaps["xs"], 1e-6), gaps


# ---------------------------------------------------------------------------
# refusals, and states carried across
# ---------------------------------------------------------------------------

def test_scaffold_refuses_ef21_with_the_reference_message():
    cfg_kw = dict(algorithm="scaffold", uplink_bits=8)
    with pytest.raises(NotImplementedError) as port_err:
        make(FederatedConfig(**cfg_kw))
    with pytest.raises(NotImplementedError) as ref_err:
        ref_make(RefConfig(**cfg_kw))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(NotImplementedError, match="SCAFFOLD\\+EF21"):
        scaffold.make(FederatedConfig(**cfg_kw))


CARRY = {
    "scaffold_arena": dict(algorithm="scaffold", use_arena=True),
    "scaffold_pytree": dict(algorithm="scaffold", use_arena="auto"),
    "fedsplit_arena": dict(algorithm="fedsplit", use_arena=True),
    "fedsplit_pytree": dict(algorithm="fedsplit", use_arena="auto"),
    "gpdmm_pytree": dict(algorithm="gpdmm", use_arena="auto"),
    "agpdmm_pytree": dict(algorithm="agpdmm", use_arena="auto"),
}


@pytest.mark.parametrize("name", CARRY)
def test_reference_state_carries_across(lsq, name):
    """Two reference rounds, the state carried across by
    ``convert.round_state``, then two more rounds on each side."""
    ref, _ = lsq
    kw = dict(CARRY[name], inner_steps=3, eta=0.5 / ref.L)
    ro = ref_make(RefConfig(**kw))
    grad = ref.oracle() if kw["use_arena"] is True else ref.grad
    rs = ro.init(jnp.zeros(ref.d), ref.m)
    for _ in range(2):
        rs, _ = ro.round(rs, grad, ref.batch())
    _lsq_run(lsq, kw, rounds=2, ref_state=rs)


# ---------------------------------------------------------------------------
# bf16, mixed-dtype and nested parameter trees, SVRG included
# (tests/_torch_parity.py's ``run_trees`` and its tolerances)
# ---------------------------------------------------------------------------

TREE_CASES = [("bf16", "flat"), ("mixed", "flat"), ("f32", "nested"), ("bf16", "nested")]


@pytest.mark.parametrize("dtype,kind", TREE_CASES, ids=[f"{d}-{k}" for d, k in TREE_CASES])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("algo", ["scaffold", "fedavg", "fedsplit"])
def test_baseline_tree_dtype_rounds_match_reference(algo, path, dtype, kind):
    """SCAFFOLD, FedAvg and Inexact FedSplit on bf16, mixed-dtype and
    nested trees, on the arena and on the pytree path."""
    run_trees(dict(algorithm=algo, eta=0.1, use_arena=path == "arena"), kind, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "mixed"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_svrg_tree_dtype_rounds_match_reference(algo, path, dtype):
    """SVRG (per-step batches) in bf16 and on a mixed-dtype tree."""
    run_trees(dict(algorithm=algo, eta=0.1, variance_reduction="svrg",
                   use_arena=path == "arena"), "flat", dtype, per_step=True)
