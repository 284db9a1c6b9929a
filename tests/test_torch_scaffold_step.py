"""SCAFFOLD's full-arena server step (kernel 5 redesigned, ``ops.scaffold_step``)
on the CPU, where it runs its plain version, against the composition it
replaces and against the reference's rounds.

  * The plain route is the old composition op for op, bitwise: the
    control-variate refresh (``scaffold_cv``), the mask's two selects, the
    two ``torch.mean``s with the server-row arithmetic (``T.weak`` for
    eta_g) and ``_arena_state``'s column sum; f32 and bf16, scalar and
    per-client alpha, with and without a mask, eta_g 1 and 0.7.
  * The routing: a full-arena round that is neither a cohort nor an async
    round calls ``scaffold_step`` once and ``scaffold_cv`` never; the cohort
    and the async rounds keep ``scaffold_cv`` and their plain means.
  * Rounds against the reference (``run_both``: the full round, the masked
    round at participation 0.5, faulted without and with screening) at the
    tolerances of ``tests/_torch_parity.py`` (c_i and c_sum_norm atol
    1e-5 / (K eta)).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import quadratic as ref_quadratic
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops, ref

from _torch_parity import run_both

SHAPES = [(1, 128), (7, 130), (8, 256), (33, 512)]


def _old_tail(c_i, x_t, c_row, x_s_row, alpha, eta_g, mask):
    """SCAFFOLD's arena tail as ``core/scaffold.py`` wrote it before the
    server step: (c_i', x_s', c', the column sum of c_i' - c')."""
    c_i_new = ops.scaffold_cv(c_i, x_t, c_row, x_s_row, alpha)
    x_up = x_t
    if mask is not None:
        c_i_new = torch.where(mask[:, None], c_i_new, c_i)
        x_up = torch.where(mask[:, None], x_t, x_s_row[None])
    x_s_new = x_s_row + T.weak(eta_g, x_s_row) * (torch.mean(x_up, dim=0) - x_s_row)
    c_new = c_row + torch.mean(c_i_new - c_i, dim=0)
    colsum = torch.sum((c_i_new - c_new[None]).to(torch.float32), dim=0)
    return c_i_new, x_s_new, c_new, colsum


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("eta_g", [1.0, 0.7])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("per_client", [False, True], ids=["scalar", "per_client"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,w", SHAPES)
def test_plain_route_is_the_old_composition_bitwise(m, w, dtype, per_client, masked, eta_g):
    rng = np.random.default_rng(m * w)
    arr = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)  # noqa: E731
    c_i, x_t, c_row, x_s = arr(m, w), arr(m, w), arr(w), arr(w)
    alpha = (torch.from_numpy((1.0 + 40.0 * rng.random(m)).astype(np.float32)) if per_client
             else 2.5)
    mask = torch.from_numpy(rng.random(m) < 0.5) if masked else None
    got = ops.scaffold_step(c_i, x_t, c_row, x_s, alpha, eta_g, mask)
    want = _old_tail(c_i, x_t, c_row, x_s, alpha, eta_g, mask)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    assert got[3].dtype == torch.float32
    assert torch.equal(_bits(got[0]), _bits(ref.scaffold_step_ref(c_i, x_t, c_row, x_s, alpha,
                                                                  eta_g, mask)[0]))


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    ref_prob = ref_quadratic.generate(jax.random.key(0), m=8, n=60, d=request.param)
    return ref_prob, convert.least_squares(ref_prob, "cpu")


ROUND_CASES = {
    "full": dict(),
    "full_eta_g": dict(eta_g=0.7),
    "masked": dict(participation=0.5, cohort=False),
    "faulted": dict(faults=dict(dropout=0.25, corrupt=0.2, seed=3), screen=False),
    "screened": dict(faults=dict(dropout=0.1, corrupt=0.3, seed=7), screen=True),
    # finite-only screening lets a blown-up row through; scaled by 1 (as
    # chip_smoke.py's FINITE_ONLY) the state stays at the problem's scale,
    # where c_sum_norm's rounding noise is within its atol
    "screened_finite_only": dict(faults=dict(dropout=0.1, corrupt=0.3, seed=7, blowup=1.0),
                                 screen=True, screen_mult=0.0),
    "per_client_eta": dict(eta=(0.002, 0.003, 0.004, 0.002, 0.003, 0.004, 0.002, 0.003)),
}


@pytest.mark.parametrize("label", sorted(ROUND_CASES))
def test_full_arena_rounds_match_reference(lsq, label):
    """Four SCAFFOLD arena rounds of the port (its server step's plain
    route) against the reference, state and metrics round by round."""
    ref_prob, prob = lsq
    kw = dict(algorithm="scaffold", inner_steps=3, eta=0.5 / float(ref_prob.L),
              use_arena=True) | ROUND_CASES[label]
    run_both(kw, ref_prob, prob, 4)


def _count(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        def counted(*a, _f=getattr(ops, n), _n=n, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, n, counted)
    return calls


ROUTES = {
    "full": (dict(), "scaffold_step"),
    "masked": (dict(participation=0.5, cohort=False), "scaffold_step"),
    "faulted": (dict(faults=FaultConfig(dropout=0.25, corrupt=0.2, seed=3), screen=False),
                "scaffold_step"),
    "screened": (dict(faults=FaultConfig(dropout=0.1, corrupt=0.3, seed=7), screen=True),
                 "scaffold_step"),
    "cohort": (dict(participation=0.5), "scaffold_cv"),
    "async": (dict(faults=FaultConfig(delay=0.3, seed=9), max_staleness=2), "scaffold_cv"),
}


@pytest.mark.parametrize("label", sorted(ROUTES))
def test_arena_rounds_route_the_tail(monkeypatch, lsq, label):
    """``scaffold_step`` once a round on the full arena (full, masked,
    faulted, screened), ``scaffold_cv`` once on the cohort and the async
    rounds (out of the server step's scope)."""
    _, prob = lsq
    kw, want = ROUTES[label]
    calls = _count(monkeypatch, ("scaffold_step", "scaffold_cv"))
    opt = make(FederatedConfig(algorithm="scaffold", inner_steps=3, eta=0.5 / prob.L,
                               use_arena=True, **kw))
    s = opt.init(torch.zeros(prob.d), prob.m)
    for _ in range(2):
        s, met = opt.round(s, prob.oracle(), prob.batch())
        assert "c_sum_norm" in met
    other = "scaffold_cv" if want == "scaffold_step" else "scaffold_step"
    assert calls[want] == 2 and calls[other] == 0
