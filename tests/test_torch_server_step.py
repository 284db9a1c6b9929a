"""The arena round's server step (kernels 2-3): ``ops.client_mean``,
``ops.server_dual``, ``ops.server_step`` and ``ops.round_tail_mean`` on the
CPU, where each runs its plain version, against today's composition and
the reference; the rounds' routing to them; the card's summation order.

  * The plain fused ops are today's composition bitwise: ``torch.mean(u,
    0)``, the plain dual, ``torch.sum(lam.to(f32), 0)``; ``round_tail_ref``
    before them.
  * Against the reference on the same numpy inputs (``jnp.mean``,
    ``dual_from_uplink_pallas(interpret=True)``, ``jnp.sum(lam.astype(f32),
    0)``, ``round_tail_pallas(interpret=True)``): x_s' in f32 within 2 m u
    of each column's mean |u| (u = 2^-24; each side adds the m rows in an
    order no deeper than m, and a sum of depth d errs by at most d u of the
    summed magnitudes), in bf16 within one bf16 step (the two f32 sums round
    to neighbours at most); lam' given the same x_s' and the uplink to the
    elementwise tolerance of ``tests/test_torch_kernels.py`` (rtol 1e-6,
    8e-3 in bf16: interpret mode may contract an FMA); the column sum within
    2 m u of each column's sum |lam| (plus the two duals' difference).
  * GPDMM and AGPDMM arena rounds run ``round_tail_mean`` and
    ``server_dual`` exactly when ``needs_cache(cfg)`` is false, and
    ``round_tail`` then ``server_step`` otherwise (calls counted through
    ``monkeypatch``).
  * The card's order: ``round_tail.plan`` and ``depth``, and a numpy
    model of the column walk's additions (a warp's rows, the warps of a
    column group, the slices' partials in runs) within ``depth`` roundings
    of the float64 sum.
  * Rounds against the reference with ``lam_sum_norm``, a norm of sums that
    are zero in exact arithmetic, held to its rounding scale eps (rho m
    ||x_s|| + sqrt(m) ||lam||_F) rather than a fixed atol: the card adds
    lam's columns in its own order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make, quadratic as ref_quadratic
from repro.kernels import round_tail as ref_round_tail
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import gpdmm, make, resolved_rho
from repro_torch.kernels import _build, ops as P, ref
from repro_torch.kernels import round_tail as RT

SHAPES = [(1, 128), (7, 256), (130, 384), (8, 4096)]
UNIT = 2.0 ** -24
F32_EPS = 2.0 ** -23


def _draw(seed, m, w, dtype):
    """(u, x_ref, lam, x_s) as jax arrays and torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) + off
            for s, off in (((m, w), 0.5), ((m, w), 0.0), ((m, w), 0.0), ((w,), 0.0))]
    if dtype == "bf16":
        return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a.copy()) for a in arrs]


def _f64(x):
    if torch.is_tensor(x):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float32), np.float64)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bf16_step(x):
    """One bf16 step at each |x|: 2^(e - 8) for |x| = f 2^e, f in [0.5, 1)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,w", SHAPES)
def test_fused_ops_are_the_composition_bitwise(m, w, dtype):
    _, (u, xr, lam, xs) = _draw(m * w, m, w, dtype)
    rho = 2.5
    x_s = torch.mean(u, dim=0)
    lam_new = ref.dual_from_uplink_ref(u, x_s, rho)
    colsum = torch.sum(lam_new.to(torch.float32), dim=0)
    got = P.server_step(u, rho)
    for a, b in zip(got, (x_s, lam_new, colsum), strict=True):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(P.client_mean(u)), _bits(x_s))
    for a, b in zip(P.server_dual(u, x_s, rho), (lam_new, colsum), strict=True):
        assert torch.equal(_bits(a), _bits(b))
    for with_lam_is in (True, False):
        li, up = ref.round_tail_ref(xr, lam, xs, 3.7, with_lam_is=with_lam_is)
        li_f, up_f, mean_f = P.round_tail_mean(xr, lam, xs, 3.7, with_lam_is=with_lam_is)
        assert torch.equal(_bits(up_f), _bits(up))
        assert torch.equal(_bits(mean_f), _bits(torch.mean(up, dim=0)))
        assert (li_f is None) == (not with_lam_is)
        if with_lam_is:
            assert torch.equal(_bits(li_f), _bits(li))


def _mean_close(got, want, u_abs_mean, m, dtype):
    err = np.abs(_f64(got) - _f64(want))
    if dtype == "f32":
        assert np.all(err <= 2 * m * UNIT * u_abs_mean), float(err.max())
    else:
        step = np.maximum(_bf16_step(_f64(got)), _bf16_step(_f64(want)))
        assert np.all(err <= step), float((err / step).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,w", SHAPES)
def test_server_step_matches_reference(m, w, dtype):
    (uj, _, _, _), (ut, _, _, _) = _draw(m + w, m, w, dtype)
    rho = 2.5
    x_p, lam_p, cs_p = P.server_step(ut, rho)
    x_r = jnp.mean(uj, axis=0)
    assert x_p.dtype == ut.dtype and tuple(x_p.shape) == (w,)
    _mean_close(x_p, x_r, np.abs(_f64(ut)).mean(axis=0), m, dtype)
    # the reference's dual and column sum on the port's x_s'
    xs_j = jnp.asarray(x_p.float().numpy()).astype(uj.dtype)
    lam_r = ref_round_tail.dual_from_uplink_pallas(uj, xs_j, rho, interpret=True)
    rtol = 1e-6 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(_f64(lam_p), _f64(lam_r), rtol=rtol, atol=1e-5)
    cs_r = jnp.sum(lam_r.astype(jnp.float32), axis=0)
    # two orders of depth <= m, plus whatever the two duals differ by
    err = np.abs(_f64(cs_p) - _f64(cs_r))
    tol = (2 * m * UNIT * np.abs(_f64(lam_p)).sum(axis=0)
           + np.abs(_f64(lam_p) - _f64(lam_r)).sum(axis=0))
    assert np.all(err <= tol), float(err.max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,w", SHAPES)
def test_round_tail_mean_matches_reference(m, w, dtype):
    (_, xj, lj, sj), (_, xt, lt, st) = _draw(7 * m + w, m, w, dtype)
    rho = 3.7
    li_p, up_p, mean_p = P.round_tail_mean(xt, lt, st, rho, with_lam_is=True)
    li_r, up_r = ref_round_tail.round_tail_pallas(xj, lj, sj, rho, with_lam_is=True,
                                                  interpret=True)
    rtol = 1e-6 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(_f64(up_p), _f64(up_r), rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(_f64(li_p), _f64(li_r), rtol=rtol, atol=1e-5)
    # the mean of the port's uplink on both sides
    up_j = jnp.asarray(up_p.float().numpy()).astype(xj.dtype)
    _mean_close(mean_p, jnp.mean(up_j, axis=0), np.abs(_f64(up_p)).mean(axis=0), m, dtype)


# ---------------------------------------------------------------------------
# the rounds take the folded tail exactly when nothing needs the cache
# ---------------------------------------------------------------------------

CONFIGS = {
    "full": {},
    "ef21": dict(uplink_bits=8),
    "p50_cohort": dict(participation=0.5),
    "p50_masked": dict(participation=0.5, cohort=False),
    "faulted": dict(faults=dict(dropout=0.25, seed=3), screen=False),
    "screened": dict(screen=True),
    "async": dict(faults=dict(delay=0.3, seed=9), max_staleness=2),
}
TAIL_OPS = ("round_tail", "round_tail_mean", "server_step", "server_dual", "client_mean",
            "dual_from_uplink")


@pytest.fixture(scope="module")
def lsq():
    r = ref_quadratic.generate(jax.random.key(0), m=8, n=60, d=24)
    return r, convert.least_squares(r, "cpu")


def _cfg(cls, fault_cls, kw, algo):
    kw = dict(kw)
    fk = kw.pop("faults", None)
    if fk is not None:
        kw["faults"] = fault_cls(**fk)
    return cls(algorithm=algo, inner_steps=3, use_arena=True, **kw)


def _count_tail_ops(monkeypatch):
    calls = {name: 0 for name in TAIL_OPS}
    for name in TAIL_OPS:
        def counted(*a, _f=getattr(P, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(P, name, counted)
    return calls


@pytest.mark.parametrize("label", sorted(CONFIGS))
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_arena_rounds_fold_the_tail_exactly_without_a_cache(monkeypatch, lsq, algo, label):
    _, prob = lsq
    cfg = _cfg(FederatedConfig, FaultConfig, CONFIGS[label], algo)
    assert gpdmm.needs_cache(cfg) == (label != "full")
    opt = make(cfg)
    state = opt.init(torch.zeros(prob.d), prob.m)
    calls = _count_tail_ops(monkeypatch)
    for _ in range(2):
        state, met = opt.round(state, prob.oracle(), prob.batch())
    want = ({"round_tail_mean": 2, "server_dual": 2} if label == "full"
            else {"round_tail": 2, "server_step": 2})
    assert calls == {name: want.get(name, 0) for name in TAIL_OPS}
    assert float(met["used_arena"]) == 1.0 and math.isfinite(float(met["lam_sum_norm"]))


def test_traced_full_round_folds_and_keeps_lam_is(monkeypatch, lsq):
    _, prob = lsq
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=3, use_arena=True))
    state = opt.init(torch.zeros(prob.d), prob.m)
    calls = _count_tail_ops(monkeypatch)
    state, met = opt.round(state, prob.oracle(), prob.batch(), False, True)
    assert calls["round_tail_mean"] == 1 and calls["server_dual"] == 1
    assert calls["round_tail"] == 0 and calls["server_step"] == 0
    assert met["trace"]["lam_is"] is not None


# ---------------------------------------------------------------------------
# the card's summation order, modelled
# ---------------------------------------------------------------------------

def kernel_order_sum(a: np.ndarray, sms: int = RT.SMS) -> np.ndarray:
    """The column walk's f32 column sums of ``a`` (m, W) in the kernel's
    order (``csrc/round_tail.cu``): each of a column group's rw warps adds
    its rows of a slice (r0 + q, r0 + q + rw, ...) in order, the rw sums in
    warp order make the slice's partial, and the partials go in P
    contiguous runs of slices, each in order, then the runs in order."""
    m, w = a.shape
    s, rows, rw = RT.plan(m, w, a.itemsize, sms)
    tile = (RT.WARPS // rw) * RT.GROUPS * RT.vec(w, a.itemsize)
    runs = max(1, RT.WARPS * 32 // tile)
    parts = []
    for sl in range(s):
        r0, r1 = sl * rows, min(m, (sl + 1) * rows)
        warp_sums = []
        for q in range(rw):
            acc = np.zeros(w, np.float32)
            for r in range(r0 + q, r1, rw):
                acc = acc + a[r]
            warp_sums.append(acc)
        part = warp_sums[0]
        for x in warp_sums[1:]:
            part = part + x
        parts.append(part)
    if s == 1:
        return parts[0]
    total = None
    for q in range(runs):
        q0, q1 = q * s // runs, (q + 1) * s // runs
        if q1 == q0:
            continue
        run = parts[q0]
        for p in parts[q0 + 1:q1]:
            run = run + p
        total = run if total is None else total + run
    return total


def test_plan_rule():
    """S = 1 once the column tiles fill 4 blocks an SM, or when a slice
    would hold fewer than 4 rows a warp (1 for a pass that does not
    reduce); a column group gets 8 warps on a tall arena and 1 on lm_flat's
    8 rows (the block's other warps take other groups); no slice is
    empty."""
    assert RT.plan(8, 1 << 20, 4) == (1, 8, 1)  # lm_flat: 1,024 tiles of 8 warps
    assert RT.plan(10 ** 6, 1024, 4) == (66, 15152, 8)  # 8 tiles x 66 = 528 blocks
    assert RT.plan(10 ** 6, 1024, 2) == (132, 7576, 8)  # bf16: 4 tiles x 132
    assert RT.plan(500, 512, 4) == (16, 32, 8)
    assert RT.plan(500, 512, 4, reduce=False) == (63, 8, 8)
    assert RT.plan(8, 4096, 4) == (2, 4, 1)
    assert RT.plan(20, 1 << 20, 4)[2] == 2
    for m, w, es in [(130001, 128, 4), (500, 512, 4), (7, 256, 2), (5, 130, 4), (0, 128, 4),
                     (8, 1 << 20, 2), (31, 512, 4)]:
        for reduce in (True, False):
            s, rows, rw = RT.plan(m, w, es, reduce=reduce)
            assert s >= 1 and rows >= 1 and (s - 1) * rows < max(m, 1) <= s * rows
            tiles = RT.column_tiles(w, es, rw)
            assert (s - 1) * tiles < RT.SMS * RT.BLOCKS_PER_SM
            # no more column groups a block than the width has
            warp_cols = -(-(w // RT.vec(w, es)) // RT.GROUPS)
            assert RT.WARPS // rw <= warp_cols and RT.WARPS % rw == 0
    assert RT.vec(130, 4) == 1 and RT.vec(128, 2) == 8 and RT.vec(4096, 4) == 4


@pytest.mark.parametrize("m,w", [(5000, 128), (3000, 1024), (700, 130), (9, 4096),
                                 (8, 1 << 14)])
def test_modelled_order_is_within_its_depth(m, w):
    """The kernel's order errs by at most ``depth`` roundings of each
    column's sum |a| from the float64 sum (S > 1 with runs of slices at
    (5000, 128); one warp a column group at (8, 2^14))."""
    rng = np.random.default_rng(m + w)
    a = (rng.standard_normal((m, w)) + 0.5).astype(np.float32)
    got = kernel_order_sum(a)
    exact = a.astype(np.float64).sum(axis=0)
    bound = RT.depth(m, w, 4) * UNIT * np.abs(a.astype(np.float64)).sum(axis=0)
    assert np.all(np.abs(got.astype(np.float64) - exact) <= bound)
    if (m, w) == (5000, 128):
        assert RT.plan(m, w, 4)[0] > 2


def test_launchers_take_the_plan_the_wrappers_give():
    """The C launchers' grid is the wrapper's: 8 warps of 256 threads, 32
    groups of 16 bytes a warp, 8 / rw of them a block, S and rw passed
    from ``plan``."""
    src = (_build.CSRC / RT.CLIENT_MEAN.source).read_text()
    assert "constexpr int kThreads = 256;" in src and RT.WARPS * 32 == 256
    assert "a.G = a.W / V;" in src and "((a.G + 31) / 32 + cw - 1) / cw" in src
    assert RT.GROUPS == 32
    assert "__launch_bounds__(kThreads, 4)" in src and RT.BLOCKS_PER_SM == 4
    assert "const int rwi = warp % rw, cwi = warp / rw;" in src


# ---------------------------------------------------------------------------
# rounds against the reference, the invariant held to its rounding scale
# ---------------------------------------------------------------------------

ROUND_CONFIGS = {
    "full": {},
    "p50": dict(participation=0.5),
    "screened": dict(faults=dict(dropout=0.2, corrupt=0.2, seed=7), screen=True),
}


def _invariant_scale(state, rho, m):
    x_s = convert.to_numpy(state["x_s"]).astype(np.float64)
    lam = convert.to_numpy(state["lam_s"]).astype(np.float64)
    return F32_EPS * (rho * m * max(1.0, float(np.linalg.norm(x_s)))
                      + math.sqrt(m) * float(np.linalg.norm(lam)))


@pytest.mark.parametrize("label", sorted(ROUND_CONFIGS))
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_arena_rounds_match_reference_with_the_invariant_scaled(lsq, algo, label):
    """Three rounds: x_s, lam_s, x_c and u_hat at rtol 1e-5 (atol 1e-5,
    1e-5 rho for lam_s), the round counter exactly, ``client_drift`` at rtol
    1e-5, and ``lam_sum_norm`` on each side below 16 of its rounding scale
    and within 16 of it of the other side's."""
    ref_prob, prob = lsq
    rcfg = _cfg(RefConfig, RefFaultConfig, ROUND_CONFIGS[label], algo)
    pcfg = _cfg(FederatedConfig, FaultConfig, ROUND_CONFIGS[label], algo)
    rho = resolved_rho(pcfg)
    ro, po = ref_make(rcfg), make(pcfg)
    rs = ro.init(jnp.zeros(ref_prob.d, jnp.float32), ref_prob.m)
    ps = po.init(torch.zeros(prob.d), prob.m)
    for _ in range(3):
        rs, rm = ro.round(rs, ref_prob.oracle(), ref_prob.batch())
        ps, pm = po.round(ps, prob.oracle(), prob.batch())
        assert sorted(ps) == sorted(rs) and int(ps["round"]) == int(rs["round"])
        for k in ("x_s", "lam_s", "x_c", "u_hat"):
            if k in rs:
                atol = 1e-5 * (rho if k == "lam_s" else 1.0)
                np.testing.assert_allclose(convert.to_numpy(ps[k]), np.asarray(rs[k]),
                                           rtol=1e-5, atol=atol, err_msg=k)
        np.testing.assert_allclose(float(pm["client_drift"]), float(rm["client_drift"]),
                                   rtol=1e-5, atol=1e-5)
        scale = _invariant_scale(ps, rho, prob.m)
        lp, lr = float(pm["lam_sum_norm"]), float(rm["lam_sum_norm"])
        assert lp <= 16 * scale and lr <= 16 * scale, (lp, lr, scale)
        assert abs(lp - lr) <= 16 * scale

