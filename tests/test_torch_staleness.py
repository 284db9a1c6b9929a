"""The bounded-staleness async engine in the port (``repro_torch.core.staleness``,
kernel 12's plain version) against the reference (``repro.core.staleness``).

The slot bookkeeping is integer arithmetic and must agree exactly; the
admission weight is f32 ``stale_gamma ** lateness``, bitwise for a gamma
that is a power of two and within one ulp otherwise (XLA's CPU ``pow`` and
torch's may round differently).  ``stale_mix``'s plain version is the
reference's ``"xla"`` branch op for op, so bitwise in f32 and bf16; against
``"pallas_interpret"`` its ``w = 0`` rows and the buffer are bitwise and the
mixed rows within the reference's own kernel-parity tolerance (1e-5).
Rounds are compared with the reference round by round at the tolerances of
tests/_torch_parity.py (gamma 0.5, so the weights are exact).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import faults as ref_faults
from repro.core import make as ref_make
from repro.core import quadratic as ref_quadratic
from repro.core import staleness as ref_staleness
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import api, faults, make, quadratic, staleness
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops

from _torch_parity import configs, run_both

ALGOS = ["gpdmm", "agpdmm", "scaffold", "fedavg"]
M = 8
D = 24
STALE_KEYS = set(staleness.STATE_KEYS)


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    ref_prob = ref_quadratic.generate(jax.random.key(0), m=M, n=60, d=request.param)
    return ref_prob, convert.least_squares(ref_prob, "cpu")


def _cfg(algo="gpdmm", *, delay=0.4, seed=3, **kw):
    return FederatedConfig(algorithm=algo, inner_steps=2, eta=0.02,
                           faults=FaultConfig(delay=delay, seed=seed), **kw)


def test_async_on_policy_and_cohort_pin_match_reference():
    cases = [dict(), dict(max_staleness=2), dict(deadline=3.0), dict(async_rounds=True),
             dict(async_rounds=False, max_staleness=2), dict(async_rounds=True, topology="ring")]
    for kw in cases:
        rcfg, pcfg = configs(dict(faults=dict(delay=0.4, seed=3), **kw))
        assert faults.async_on(pcfg) == ref_faults.async_on(rcfg), kw
    rcfg, pcfg = configs(dict(faults=dict(dropout=0.3), async_rounds=True))
    assert not faults.async_on(pcfg) and not ref_faults.async_on(rcfg)
    # the cohort engine cannot age or deliver an out-of-cohort client's slot
    assert not api.use_cohort(_cfg(max_staleness=2, participation=0.5, cohort=True), M)
    assert api.use_cohort(_cfg(participation=0.5, cohort=True), M)


def _hand_plan(delayed, lateness):
    m = len(delayed)
    z = torch.zeros(m, dtype=torch.bool)
    return faults.FaultPlan(silent=z, corrupt=z, kind=torch.zeros(m, dtype=torch.int32),
                            delayed=torch.tensor(delayed),
                            lateness=torch.tensor(lateness, dtype=torch.int32))


def _ref_plan(p):
    return ref_faults.FaultPlan(*(jnp.asarray(f.numpy()) for f in p))


# slots: empty; in flight age 0 / lat 1; age 0 / lat 2; age 1 / lat 2;
# empty + a new delayed uplink; busy + a new delayed uplink (dropped)
AGE = [-1, 0, 0, 1, -1, 0]
LAT = [0, 1, 2, 2, 0, 3]
HAND = ([False, False, False, False, True, True], [0, 0, 0, 0, 2, 1])


@pytest.mark.parametrize("max_staleness", [1, 2])
@pytest.mark.parametrize("gamma", [0.5, 0.7])
def test_schedule_hand_computed_and_matches_reference(gamma, max_staleness):
    cfg = _cfg(max_staleness=max_staleness, stale_gamma=gamma)
    age, lat = torch.tensor(AGE, dtype=torch.int32), torch.tensor(LAT, dtype=torch.int32)
    fplan = _hand_plan(*HAND)
    got = staleness._schedule(cfg, fplan, age, lat)
    rcfg, _ = configs(dict(faults=dict(delay=0.4, seed=3), inner_steps=2, eta=0.02,
                           max_staleness=max_staleness, stale_gamma=gamma))
    want = ref_staleness._schedule(rcfg, _ref_plan(fplan), jnp.asarray(AGE, jnp.int32),
                                   jnp.asarray(LAT, jnp.int32))
    for name, a, b in zip(("store", "w", "arriving", "admit", "age_new", "lat_new"), got, want):
        if name == "w":  # f32 pow: one ulp apart at most
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1.2e-7, atol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
            assert a.dtype in (torch.bool, torch.int32), name
    store, w, arriving, admit, age_new, lat_new = got
    assert arriving.tolist() == [False, True, False, True, False, False]
    assert store.tolist() == [False, False, False, False, True, False]
    assert age_new.tolist() == [-1, -1, 1, -1, 0, 1]
    assert lat_new.tolist() == [0, 0, 2, 0, 2, 3]
    if max_staleness == 2:
        assert admit.tolist() == [False, True, False, True, False, False]
        if gamma == 0.5:
            assert w.tolist() == [0.0, 0.5, 0.0, 0.25, 0.0, 0.0]
    else:  # lateness 2 arrives past max_staleness: dropped, not admitted
        assert admit.tolist() == [False, True, False, False, False, False]
        assert float(w[3]) == 0.0


def test_step_arena_hand_computed_and_matches_reference():
    cfg = _cfg(max_staleness=2, stale_gamma=0.5)
    m, w_ = 3, 4
    uplink = torch.arange(m * w_, dtype=torch.float32).reshape(m, w_) + 1.0
    cache = -torch.ones(m, w_)
    buf = 10.0 * torch.ones(m, w_)
    # client 0 fresh; client 1 arriving, admitted (age 0 / lat 1); client 2
    # delayed now, into its empty slot
    state = {"stale_buf": buf, "stale_age": torch.tensor([-1, 0, -1], dtype=torch.int32),
             "stale_lat": torch.tensor([0, 1, 0], dtype=torch.int32)}
    fplan = _hand_plan([False, False, True], [0, 0, 2])
    mixed, fresh, upd, mx = staleness.step_arena(cfg, fplan, uplink, cache, None, state)
    assert fresh.tolist() == [True, True, False]
    assert torch.equal(mixed[0], uplink[0])
    assert torch.equal(mixed[1], 0.5 * uplink[1] + 0.5 * buf[1])
    assert torch.equal(mixed[2], cache[2])
    assert torch.equal(upd["stale_buf"][2], uplink[2])
    assert upd["stale_age"].tolist() == [-1, -1, 0] and upd["stale_lat"].tolist() == [0, 0, 2]
    assert [float(mx[k]) for k in ("stale_buffered", "stale_admitted", "stale_dropped")] == [
        1.0, 1.0, 0.0]
    rcfg, _ = configs(dict(faults=dict(delay=0.4, seed=3), inner_steps=2, eta=0.02,
                           max_staleness=2))
    want = ref_staleness.step_arena(
        rcfg, _ref_plan(fplan), jnp.asarray(uplink.numpy()), jnp.asarray(cache.numpy()), None,
        {k: jnp.asarray(v.numpy()) for k, v in state.items()})
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(want[0]))
    for k in upd:
        np.testing.assert_array_equal(upd[k].numpy(), np.asarray(want[2][k]), err_msg=k)


def _mix_inputs(shape, per_row, dtype):
    m, w_ = shape
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    u, c, b = (jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jdt)
               for s in ((m, w_), (m, w_) if per_row else (w_,), (m, w_)))
    b = b.at[3 % m].set(jnp.nan).at[1].set(jnp.inf)  # non-finite buffered rows
    fresh = jnp.arange(m) % 2 == 0
    store = jnp.arange(m) % 3 == 0
    # w = 0 on the even rows (row 0's buffer is finite, the others' NaN or
    # Inf), w > 0 on the odd rows
    w = jnp.where(jnp.arange(m) % 2 == 1, 0.5 ** (1 + jnp.arange(m) % 3), 0.0).astype(
        jnp.float32)
    jargs = (u, c, b, fresh, store, w)
    targs = tuple(convert.tensor(a, "cpu") for a in jargs)
    return jargs, targs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("shape", [(4, 128), (6, 384), (5, 130)],
                         ids=["one_block", "multi", "padded_width"])
def test_stale_mix_plain_matches_reference(shape, per_row, dtype):
    jargs, targs = _mix_inputs(shape, per_row, dtype)
    mixed, buf_new = ops.stale_mix(*targs)
    mx, bx = ref_ops.stale_mix(*jargs, impl="xla")
    # bitwise: the same f32 ops in the same order (NaN == NaN in place)
    np.testing.assert_array_equal(convert.to_numpy(mixed), np.asarray(mx, np.float32))
    np.testing.assert_array_equal(convert.to_numpy(buf_new), np.asarray(bx, np.float32))
    assert mixed.dtype == targs[0].dtype and buf_new.dtype == targs[2].dtype
    mp, bp = ref_ops.stale_mix(*jargs, impl="pallas_interpret")
    guarded = np.asarray(jargs[5]) == 0.0
    np.testing.assert_array_equal(convert.to_numpy(mixed)[guarded],
                                  np.asarray(mp, np.float32)[guarded])
    np.testing.assert_allclose(convert.to_numpy(mixed), np.asarray(mp, np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(convert.to_numpy(buf_new), np.asarray(bp, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_mix_guard_is_bitwise_select(dtype):
    """At w = 0 the mix is the masked select bit for bit, against a buffer
    of Inf and NaN (0 * Inf must never leak in) and with -0.0 kept."""
    m, w_ = 4, 130
    g = torch.Generator().manual_seed(0)
    uplink = torch.randn(m, w_, generator=g).to(dtype)
    cache = torch.randn(m, w_, generator=g).to(dtype)
    uplink[0, :3] = -0.0
    buf = torch.full((m, w_), math.inf, dtype=dtype)
    buf[2] = math.nan
    fresh = torch.tensor([True, False, True, False])
    mixed, _ = ops.stale_mix(uplink, cache, buf, fresh, torch.zeros(m, dtype=torch.bool),
                             torch.zeros(m))
    want = torch.where(fresh[:, None], uplink, cache)
    ity = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(mixed.view(ity), want.view(ity))


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------

ASYNC = {
    "ms0": dict(faults=dict(delay=0.3, seed=9), async_rounds=True, max_staleness=0),
    "ms2": dict(faults=dict(delay=0.3, seed=9), max_staleness=2),
    "ms2_faults": dict(faults=dict(delay=0.3, dropout=0.1, corrupt=0.2, seed=9),
                       max_staleness=2),
}
PATHS = {"arena": dict(use_arena=True), "pytree": dict(use_arena="auto")}


@pytest.mark.parametrize("case", ASYNC)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("path", PATHS)
def test_async_rounds_match_reference(lsq, path, algo, case):
    """Every state entry (the stale slots included, their int32 counters
    exactly) and every metric over 6 rounds."""
    ref_prob, prob = lsq
    kw = dict(PATHS[path], algorithm=algo, inner_steps=3, eta=0.3 / ref_prob.L, **ASYNC[case])
    _, ps, rows = run_both(kw, ref_prob, prob, 6)
    assert STALE_KEYS <= set(ps)
    assert sum(float(r["stale_buffered"]) for r in rows) > 0


def test_async_masked_participation_matches_reference(lsq):
    """Async with partial participation keeps the masked population round
    on both sides (``use_cohort`` is False)."""
    ref_prob, prob = lsq
    kw = dict(use_arena=True, cohort=True, participation=0.5, algorithm="gpdmm",
              inner_steps=3, eta=0.3 / ref_prob.L, **ASYNC["ms2"])
    run_both(kw, ref_prob, prob, 4)


def test_round_state_carries_the_stale_slots(lsq):
    """``convert.round_state`` carries stale_buf and the int32 counters."""
    ref_prob, _ = lsq
    rcfg, _ = configs(dict(use_arena=True, algorithm="gpdmm", inner_steps=3,
                           eta=0.3 / ref_prob.L, **ASYNC["ms2"]))
    ro = ref_make(rcfg)
    rs = ro.init(jnp.zeros(ref_prob.d, jnp.float32), ref_prob.m)
    for _ in range(3):
        rs, _ = ro.round(rs, ref_prob.oracle(), ref_prob.batch())
    ps = convert.round_state(rs, "cpu")
    for k in STALE_KEYS:
        np.testing.assert_array_equal(convert.to_numpy(ps[k]), np.asarray(rs[k]))
    assert ps["stale_age"].dtype == ps["stale_lat"].dtype == torch.int32
    assert ps["stale_buf"].dtype == torch.float32


# ---------------------------------------------------------------------------
# contracts inside the port
# ---------------------------------------------------------------------------

def _params():
    return {"w": torch.full((D,), 0.7)}


def _grad(p, b):
    return T.tmap(lambda x: 0.1 * x, p)


def _run(cfg, rounds, m=M):
    fed = make(cfg)
    s = fed.init(_params(), m)
    rows = []
    for _ in range(rounds):
        s, mx = fed.round(s, _grad, {"d": torch.zeros(m, 1)})
        rows.append(mx)
    return s, rows


def assert_states_equal(a, b, ignore=()):
    keys = sorted(k for k in a if k not in ignore)
    assert keys == sorted(k for k in b if k not in ignore)
    for k in keys:
        for x, y in zip(T.leaves(a[k]), T.leaves(b[k])):
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("use_arena", [True, False], ids=["arena", "pytree"])
@pytest.mark.parametrize("algo", ALGOS)
def test_sync_point_collapses_to_masked_round(algo, use_arena):
    """The engine forced on at ``max_staleness=0`` is bitwise the
    delay-as-silence round; delayed rows buffered, none admitted."""
    kw = dict(delay=0.4, seed=11, use_arena=use_arena)
    s_async, rows = _run(_cfg(algo, async_rounds=True, max_staleness=0, **kw), 5)
    s_sync, _ = _run(_cfg(algo, async_rounds=False, **kw), 5)
    assert STALE_KEYS <= set(s_async) and not STALE_KEYS & set(s_sync)
    assert_states_equal(s_async, s_sync, ignore=STALE_KEYS)
    assert sum(float(r["stale_admitted"]) for r in rows) == 0.0
    assert sum(float(r["stale_buffered"]) for r in rows) > 0.0


@pytest.mark.parametrize("algo", ALGOS)
def test_deadline_demotes_all_collapses(algo):
    s_dead, rows = _run(_cfg(algo, use_arena=True, max_staleness=3, deadline=0.5), 4)
    s_sync, _ = _run(_cfg(algo, use_arena=True, async_rounds=False), 4)
    assert_states_equal(s_dead, s_sync, ignore=STALE_KEYS)
    assert sum(float(r["stale_buffered"]) for r in rows) == 0.0


def test_stale_trace_replays_bitwise():
    cfg = _cfg("gpdmm", use_arena=True, max_staleness=3, stale_gamma=0.7)
    s1, r1 = _run(cfg, 6)
    s2, r2 = _run(cfg, 6)
    assert_states_equal(s1, s2)
    for a, b in zip(r1, r2):
        for k in ("stale_buffered", "stale_admitted", "stale_dropped"):
            assert float(a[k]) == float(b[k])


def test_stale_round_admits_and_covers():
    _, rows = _run(_cfg("gpdmm", use_arena=True, max_staleness=4, stale_gamma=0.7), 12)
    tot = {k: sum(float(r[k]) for r in rows)
           for k in ("stale_buffered", "stale_admitted", "stale_dropped")}
    assert tot["stale_buffered"] > 0 and tot["stale_admitted"] > 0
    assert tot["stale_dropped"] == 0.0  # delay_max = 4 <= max_staleness
    assert tot["stale_admitted"] <= tot["stale_buffered"]


def test_stale_run_converges_on_quadratic():
    """The reference's acceptance rule on the port: delay 0.25 with
    ``max_staleness=3`` lands within 15% of the descent scale of the clean
    run."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=60, d=D, device="cpu")
    base = dict(algorithm="gpdmm", inner_steps=3, eta=0.5 / prob.L, use_arena=True)

    def obj(cfg):
        opt = make(cfg)
        s = opt.init(torch.zeros(prob.d), prob.m)
        for _ in range(40):
            s, _ = opt.round(s, prob.oracle(), prob.batch())
        return float(prob.F(opt.server_params(s)))

    clean = obj(FederatedConfig(**base))
    stale = obj(FederatedConfig(faults=FaultConfig(delay=0.25, seed=7), max_staleness=3,
                                stale_gamma=0.5, **base))
    scale = float(prob.F(torch.zeros(prob.d)) - prob.f_star)
    assert math.isfinite(stale)
    assert abs(stale - clean) <= 0.15 * scale


def test_async_arena_round_mixes_through_the_kernel_wrapper(monkeypatch):
    """An async arena round calls ``ops.stale_mix`` (kernel 12's wrapper)
    once, SCAFFOLD with its (W,) server row as the cache; a pytree round
    mixes as plain tensor code."""
    calls = []
    real = ops.stale_mix
    monkeypatch.setattr(ops, "stale_mix",
                        lambda u, c, *a: calls.append(tuple(c.shape)) or real(u, c, *a))
    for algo in ("gpdmm", "scaffold"):
        _run(_cfg(algo, use_arena=True, max_staleness=2), 2)
    assert calls == [(M, 128)] * 2 + [(128,)] * 2
    _run(_cfg("gpdmm", use_arena=False, max_staleness=2), 2)
    assert len(calls) == 4
