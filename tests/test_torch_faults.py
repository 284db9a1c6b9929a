"""Fault injection and uplink screening in the port (``repro_torch.core.faults``,
kernel 11's plain version) against the reference (``repro.core.faults``).

The plan and the wire's corruption are integer draws and selects, so they
must agree bit for bit.  ``screen_uplink``'s plain version sums in torch's
order and the reference in XLA's: ``finite`` must agree exactly, ``sq`` to
rtol SQ_RTOL (a sum of W f32 squares in two orders, about eps * sqrt(W)).
The median of the outlier rule is jax's interpolated ``nanmedian``, held
bitwise.  Rounds are compared with the reference round by round at the
tolerances of tests/_torch_parity.py, on the least-squares problem of
tests/test_torch_participation.py (m = 8, n = 60, d = 24 and d = 130).

The reference's own cohort-vs-masked screening test fails on this tree
(ROADMAP §3): the cohort screens over the cohort's median, the masked round
over the population's.  So each path is held against the reference's same
path, and the port's cohort == masked holds only with finite-only
screening (``screen_mult=0``).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import FederatedConfig as RefConfig
from repro.core import faults as ref_faults
from repro.core import make as ref_make
from repro.core import quadratic as ref_quadratic
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import arena, faults, make, quadratic
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops

from _torch_parity import configs, run_both, tolerance

ALGOS = ["gpdmm", "agpdmm", "scaffold", "fedavg"]
M = 8
D = 24
SQ_RTOL = 2e-6  # times sqrt(W / 128): f32 sums of W squares in two orders


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    ref_prob = ref_quadratic.generate(jax.random.key(0), m=M, n=60, d=request.param)
    return ref_prob, convert.least_squares(ref_prob, "cpu")


def _plan_fields(p):
    return [np.asarray(f) for f in p]


PLAN_CASES = {
    "dropout": dict(faults=dict(dropout=0.3, seed=7)),
    "all_classes": dict(faults=dict(dropout=0.1, straggler=0.1, delay=0.2, corrupt=0.2,
                                    seed=11)),
    "async": dict(faults=dict(delay=0.4, corrupt=0.1, seed=3), max_staleness=2),
    "async_deadline": dict(faults=dict(delay=0.6, delay_max=4, seed=3), max_staleness=3,
                           deadline=2.0),
    "deadline_all": dict(faults=dict(delay=0.6, seed=3), max_staleness=3, deadline=0.5),
    "async_off": dict(faults=dict(delay=0.5, seed=3), async_rounds=False),
    "rate_one": dict(faults=dict(dropout=1.0, corrupt=1.0, seed=5)),
    "corrupt_only": dict(faults=dict(corrupt=1.0, seed=5)),
}


@pytest.mark.parametrize("m", [8, 50])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_matches_reference(case, m):
    """All five fields, integer for integer, over 12 rounds; the port
    folds the round in from an int32 counter tensor, as its rounds do."""
    rcfg, pcfg = configs(dict(algorithm="gpdmm", inner_steps=2, eta=0.02,
                              **PLAN_CASES[case]))
    assert faults.async_on(pcfg) == ref_faults.async_on(rcfg)
    for r in range(12):
        want = ref_faults.plan(rcfg, r, m)
        got = faults.plan(pcfg, torch.tensor(r, dtype=torch.int32), m)
        for name, a, b in zip(faults.FaultPlan._fields, got, _plan_fields(want)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"round {r}: {name}")
            assert a.dtype == (torch.bool if b.dtype == bool else torch.int32), name
        # take: the plan restricted to a cohort
        idx = np.sort(np.random.default_rng(r).choice(m, size=m // 2, replace=False))
        got_c = faults.take(got, torch.from_numpy(idx))
        for a, b in zip(got_c, _plan_fields(ref_faults.take(want, jnp.asarray(idx)))):
            np.testing.assert_array_equal(a.numpy(), b)


def test_plan_none_without_schedule_and_on_the_counter_device():
    assert faults.plan(FederatedConfig(), torch.tensor(0, dtype=torch.int32), M) is None
    cfg = FederatedConfig(faults=FaultConfig(dropout=0.5, delay=0.2), max_staleness=2)
    p = faults.plan(cfg, torch.tensor(3, dtype=torch.int32, device="meta"), M)
    assert all(f.device.type == "meta" for f in p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inject_is_bitwise(dtype):
    """Every corruption class on an arena buffer and on a stacked tree."""
    fk = dict(corrupt=0.6, seed=2, blowup=3.5e5)
    rcfg, pcfg = configs(dict(faults=fk))
    rng = np.random.default_rng(0)
    u = rng.standard_normal((50, 256)).astype(np.float32)
    tree = {"a": rng.standard_normal((50, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((50, 7)).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    for r in range(4):
        rp = ref_faults.plan(rcfg, r, 50)
        pp = faults.plan(pcfg, r, 50)
        kinds = set(np.asarray(rp.kind)[np.asarray(rp.corrupt)].tolist())
        want = ref_faults.inject(rcfg.faults, rp, jnp.asarray(u).astype(jdt))
        got = faults.inject(pcfg.faults, pp, convert.tensor(jnp.asarray(u).astype(jdt), "cpu"))
        np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want, np.float32))
        want_t = ref_faults.inject_tree(rcfg.faults, rp,
                                        {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()})
        got_t = faults.inject_tree(pcfg.faults, pp,
                                   convert.params({k: jnp.asarray(v).astype(jdt)
                                                   for k, v in tree.items()}, "cpu"))
        for k in tree:
            np.testing.assert_array_equal(convert.to_numpy(got_t[k]),
                                          np.asarray(want_t[k], np.float32), err_msg=k)
    assert kinds  # some rows were corrupted
    # no plan, or no corrupt rate: the uplink passes through untouched
    t = torch.ones(4, 128)
    assert faults.inject(pcfg.faults, None, t) is t
    assert faults.inject(None, pp, t) is t


def _screen_inputs(shape, per_row, dtype, seed=0):
    m, w = shape
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((m, w)).astype(np.float32)
    u[1, w // 2] = np.nan
    u[m - 1, 0] = np.inf
    u[m - 2] = -np.inf if m > 3 else u[m - 2]
    u[2 % m] *= 1e4
    r = rng.standard_normal((m, w) if per_row else (w,)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ju, jr = jnp.asarray(u).astype(jdt), jnp.asarray(r).astype(jdt)
    return ju, jr, convert.tensor(ju, "cpu"), convert.tensor(jr, "cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("shape", [(4, 128), (6, 384), (5, 130)],
                         ids=["one_block", "multi", "padded_width"])
def test_screen_uplink_plain_matches_reference(shape, per_row, dtype, impl):
    ju, jr, tu, tr = _screen_inputs(shape, per_row, dtype)
    fin_r, sq_r = ref_ops.screen_uplink(ju, jr, impl=impl)
    fin, sq = ops.screen_uplink(tu, tr)
    assert fin.dtype == torch.bool and sq.dtype == torch.float32
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_r))
    assert not fin[1] and not fin[shape[0] - 1]
    assert bool(torch.isfinite(sq).all())  # non-finite entries add 0
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_r),
                               rtol=SQ_RTOL * math.sqrt(shape[1] / 128))


def test_screen_ragged_width_screens_like_its_zero_padding():
    _, _, tu, tr = _screen_inputs((5, 130), False, "float32")
    pad = torch.nn.functional.pad
    fin, sq = ops.screen_uplink(tu, tr)
    fin_p, sq_p = ops.screen_uplink(pad(tu, (0, 126)), pad(tr, (0, 126)))
    assert torch.equal(fin, fin_p) and torch.equal(sq, sq_p)


@pytest.mark.parametrize("vals", [
    [1.0, 2.0, math.nan, 4.0, 10.0],  # even count of finite values
    [3.0, math.nan, 1.0, 7.0, 5.0, 2.0, 9.0],  # odd
    [math.nan] * 4,  # none finite: NaN
    [5.0], [2.0, 1.0], [1e-20, 3e12, 7.0, 0.5],
], ids=["even", "odd", "all_nan", "one", "two", "wide"])
def test_nanmedian_matches_jnp(vals):
    a = np.asarray(vals, np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(a)))
    got = faults.nanmedian(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    if vals[:5] == [1.0, 2.0, math.nan, 4.0, 10.0]:
        assert float(got) == 3.0 != float(torch.nanmedian(torch.from_numpy(a)))


@pytest.mark.parametrize("mult", [100.0, 3.0, 0.0])
@pytest.mark.parametrize("shape", [(8, 128), (7, 256)])
def test_screen_keep_matches_reference(shape, mult):
    """The keep mask on the arena and on a tree: finite, and not above
    ``screen_mult`` times the median deviation (off at 0)."""
    m, w = shape
    rng = np.random.default_rng(1)
    u = rng.standard_normal((m, w)).astype(np.float32)
    u[0] *= 30.0  # an outlier at mult 100 only past 30^2
    u[3, 5] = np.nan
    u[5] = -u[5] * 40.0
    r = rng.standard_normal(w).astype(np.float32)
    rcfg, pcfg = configs(dict(screen=True, screen_mult=mult))
    want = ref_faults.screen_keep(rcfg, jnp.asarray(u), jnp.asarray(r))
    got = faults.screen_keep(pcfg, torch.from_numpy(u), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tree_u = {"a": u[:, :100].reshape(m, 4, 25), "b": u[:, 100:]}
    tree_r = {"a": r[:100].reshape(4, 25), "b": r[100:]}
    want_t = ref_faults.screen_keep_tree(rcfg, jax.tree.map(jnp.asarray, tree_u),
                                         jax.tree.map(jnp.asarray, tree_r))
    got_t = faults.screen_keep_tree(pcfg, convert.params(tree_u, "cpu"),
                                    convert.params(tree_r, "cpu"))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_screen_tree_matches_packed_arena():
    """The per-leaf screen and the packed-arena screen agree on one state:
    zero padding adds zero deviation and a finite flag."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((5, 130)).astype(np.float32))}
    ref_t = {"a": torch.ones(7), "b": 0.5 * torch.ones(130)}
    tree["a"][2] = math.nan
    tree["b"][4] *= 1e7
    cfg = FederatedConfig(inner_steps=1, eta=0.1, screen=True)
    keep_tree = faults.screen_keep_tree(cfg, tree, ref_t)
    spec = arena.ArenaSpec.from_tree(ref_t)
    keep_arena = faults.screen_keep(cfg, spec.pack_stacked(tree), spec.pack(ref_t))
    assert torch.equal(keep_tree, keep_arena)
    assert not keep_tree[2] and not keep_tree[4]


def test_policies_match_reference():
    for kw in (dict(), dict(screen=True), dict(screen=False, faults=dict(dropout=0.1)),
               dict(faults=dict(delay=0.2)), dict(faults=dict(corrupt=0.1), screen=False)):
        rcfg, pcfg = configs(kw)
        assert faults.screening_on(pcfg) == ref_faults.screening_on(rcfg)
        assert faults.needs_cache(pcfg) == ref_faults.needs_cache(rcfg)


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------

SCREENED = dict(faults=dict(dropout=0.2, corrupt=0.3, seed=7), screen=True)
PATHS = {"arena": dict(use_arena=True), "pytree": dict(use_arena="auto")}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("path", PATHS)
def test_screened_rounds_match_reference(lsq, path, algo):
    """Dropout and corruption, screened: every state entry and metric, the
    fault counters exactly, over 5 rounds."""
    ref_prob, prob = lsq
    kw = dict(PATHS[path], algorithm=algo, inner_steps=3, eta=0.3 / ref_prob.L, **SCREENED)
    _, ps, rows = run_both(kw, ref_prob, prob, 5)
    assert sum(float(r["faults_demoted"]) for r in rows) > 0
    for k, v in ps.items():
        if k != "round":
            assert all(bool(torch.isfinite(x).all()) for x in T.leaves(v)), k


@pytest.mark.parametrize("algo", ALGOS)
def test_cohort_screened_rounds_match_reference(lsq, algo):
    """The cohort round, screened over the cohort with the default
    ``screen_mult``, against the reference's cohort round."""
    ref_prob, prob = lsq
    kw = dict(use_arena=True, cohort=True, participation=0.5, algorithm=algo, inner_steps=3,
              eta=0.3 / ref_prob.L, **SCREENED)
    run_both(kw, ref_prob, prob, 5)


@pytest.mark.parametrize("algo", ["gpdmm", "fedavg"])
def test_ef21_screened_rounds_match_reference(lsq, algo):
    """EF21 then the wire: the corruption hits the integrated view (4 bits,
    a coarse grid, so no element sits on a rounding edge here)."""
    ref_prob, prob = lsq
    kw = dict(use_arena=True, algorithm=algo, inner_steps=3, eta=0.3 / ref_prob.L,
              uplink_bits=4, faults=dict(dropout=0.2, corrupt=0.3, seed=7))
    run_both(kw, ref_prob, prob, 3)


# ---------------------------------------------------------------------------
# contracts inside the port
# ---------------------------------------------------------------------------

def _params():
    return {"w": torch.full((D,), 0.7)}


def _grad(p, b):
    # identical linear clients: every honest uplink is bitwise equal, so the
    # screen's median is exact and demotion is all or nothing
    return T.tmap(lambda x: 0.1 * x, p)


def _batch(m=M):
    return {"d": torch.zeros(m, 1)}


def _run(cfg, rounds, m=M):
    fed = make(cfg)
    s = fed.init(_params(), m)
    rows = []
    for _ in range(rounds):
        s, mx = fed.round(s, _grad, _batch(m))
        rows.append(mx)
    return s, rows


def assert_states_equal(a, b, ignore=("round",)):
    assert sorted(k for k in a if k not in ignore) == sorted(k for k in b if k not in ignore)
    for k in a:
        if k in ignore:
            continue
        for x, y in zip(T.leaves(a[k]), T.leaves(b[k])):
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("use_arena", [True, False], ids=["arena", "pytree"])
@pytest.mark.parametrize("algo", ALGOS)
def test_screened_round_equals_masked_round(algo, use_arena, monkeypatch):
    """A faulted, screened round is bitwise the participation-masked round
    fed the mask a perfect screen gives (active, not silent, not corrupt)."""
    rounds = 4
    cfg_f = FederatedConfig(algorithm=algo, inner_steps=2, eta=0.02, use_arena=use_arena,
                            faults=FaultConfig(dropout=0.25, corrupt=0.3, seed=11),
                            screen=True)
    s_f, rows = _run(cfg_f, rounds)
    masks = []
    for r, mx in enumerate(rows):
        p = faults.plan(cfg_f, r, M)
        masks.append(~(p.silent | p.corrupt))
        assert float(mx["faults_demoted"]) == float(p.corrupt.sum())
        assert float(mx["faults_injected"]) == float((p.silent | p.corrupt).sum())
    it = iter(masks)
    monkeypatch.setattr(T, "participation_mask", lambda key, m, frac, device="cpu": next(it))
    cfg_m = FederatedConfig(algorithm=algo, inner_steps=2, eta=0.02, use_arena=use_arena,
                            participation=0.5, cohort=False)
    s_m, _ = _run(cfg_m, rounds)
    assert_states_equal(s_f, s_m)


@pytest.mark.parametrize("algo", ALGOS)
def test_cohort_equals_masked_with_finite_only_screen(lsq, algo):
    """With ``screen_mult=0`` (finite flags only) the cohort round equals
    the masked full-population round (the cohort contract, at the
    tolerances of tests/_torch_parity.py: SCAFFOLD's cohort means are sums
    of deltas over m, its masked means means of rows); with the outlier
    rule on they differ by design (module docstring)."""
    _, prob = lsq
    common = dict(algorithm=algo, inner_steps=3, eta=0.3 / prob.L, use_arena=True,
                  participation=0.5, screen_mult=0.0,
                  faults=FaultConfig(dropout=0.2, corrupt=0.3, seed=17))
    cfg = FederatedConfig(cohort=False, **common)
    oc, om = make(FederatedConfig(cohort=True, **common)), make(cfg)
    sc, sm = oc.init(torch.zeros(prob.d), M), om.init(torch.zeros(prob.d), M)
    for _ in range(4):
        sc, mc = oc.round(sc, prob.oracle(), prob.batch())
        sm, mm = om.round(sm, prob.oracle(), prob.batch())
        for k in sm:
            if k != "round":
                torch.testing.assert_close(sc[k], sm[k], **tolerance(k, cfg), msg=k)
        assert float(mc["faults_demoted"]) == float(mm["faults_demoted"])


@pytest.mark.parametrize("mode", ["arena", "pytree", "cohort"])
@pytest.mark.parametrize("algo", ALGOS)
def test_all_silent_round_is_noop(algo, mode):
    kw = dict(algorithm=algo, inner_steps=2, eta=0.02, use_arena=mode != "pytree",
              faults=FaultConfig(dropout=1.0, seed=3))
    if mode == "cohort":
        kw.update(participation=0.5, num_clients=4, cohort=True)
    fed = make(FederatedConfig(**kw))
    s = fed.init({"w": torch.full((D,), 0.7)}, 4)
    s, _ = fed.round(s, _grad, _batch(4))
    before = {k: T.tmap(torch.clone, v) for k, v in s.items()}
    s, mx = fed.round(s, _grad, _batch(4))
    assert_states_equal(before, s)
    assert all(bool(torch.isfinite(v).all()) for v in mx.values())


def test_fault_trace_replays_bitwise():
    cfg = FederatedConfig(algorithm="scaffold", inner_steps=2, eta=0.02, use_arena=True,
                          faults=FaultConfig(dropout=0.25, corrupt=0.25, straggler=0.1,
                                             seed=23), screen=True)
    s1, r1 = _run(cfg, 5)
    s2, r2 = _run(cfg, 5)
    assert_states_equal(s1, s2, ignore=())
    for a, b in zip(r1, r2):
        assert float(a["faults_injected"]) == float(b["faults_injected"])
        assert float(a["faults_demoted"]) == float(b["faults_demoted"])


def test_fedsplit_ignores_faults():
    """FedSplit (and exact PDMM) ignore faults in the reference; the
    port's FedSplit rounds are bitwise those without the schedule."""
    kw = dict(algorithm="fedsplit", inner_steps=2, eta=0.02, use_arena=True)
    s_f, rows = _run(FederatedConfig(faults=FaultConfig(dropout=0.5, corrupt=0.5), **kw), 3)
    s_c, _ = _run(FederatedConfig(**kw), 3)
    assert_states_equal(s_f, s_c)
    assert "faults_injected" not in rows[-1]
    ref_fed = ref_make(RefConfig(faults=RefFaultConfig(dropout=0.5), **kw))
    rs = ref_fed.init({"w": jnp.full((D,), 0.7)}, M)
    _, rm = ref_fed.round(rs, lambda p, b: jax.tree.map(lambda x: 0.1 * x, p),
                          {"d": jnp.zeros((M, 1))})
    assert "faults_injected" not in rm


def test_screened_run_tracks_fault_free_run():
    """The reference's acceptance rule on the port: 10% dropout and 5%
    corruption land within 10% of the descent scale of the clean run."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=60, d=D, device="cpu")
    base = dict(algorithm="gpdmm", inner_steps=3, eta=0.5 / prob.L, use_arena=True)

    def obj(cfg):
        opt = make(cfg)
        s = opt.init(torch.zeros(prob.d), prob.m)
        for _ in range(40):
            s, _ = opt.round(s, prob.oracle(), prob.batch())
        return float(prob.F(opt.server_params(s)))

    clean = obj(FederatedConfig(**base))
    faulted = obj(FederatedConfig(faults=FaultConfig(dropout=0.1, corrupt=0.05, seed=7),
                                  **base))
    scale = float(prob.F(torch.zeros(prob.d)) - prob.f_star)
    assert math.isfinite(faulted)
    assert abs(faulted - clean) <= 0.1 * scale


def test_screen_stays_on_the_arena_kernel_path(monkeypatch):
    """An arena round screens through ``ops.screen_keep`` (kernel 11's
    wrapper, the keep rule in its launch) once; a pytree round screens as
    plain tensor code."""
    calls = []
    real = ops.screen_keep
    monkeypatch.setattr(ops, "screen_keep",
                        lambda u, r, mult: calls.append(u.shape) or real(u, r, mult))
    cfg = dict(algorithm="gpdmm", inner_steps=2, eta=0.02,
               faults=FaultConfig(dropout=0.2, corrupt=0.2, seed=1))
    _run(FederatedConfig(use_arena=True, **cfg), 2)
    assert calls == [(M, 128)] * 2
    _run(FederatedConfig(use_arena=False, **cfg), 2)
    assert len(calls) == 2

