"""The screen's keep mask (kernel 11 with the rule of ``_keep_from`` in its
launch, ``ops.screen_keep``) on the CPU, where it runs its plain version,
against the reference's ``repro.core.faults.screen_keep``.

  * The keep mask bitwise the reference's under ``impl="xla"`` and
    ``"pallas_interpret"`` (the reference's default impl switched for the
    test), on numpy inputs from a seed: NaN, +Inf and Inf-entry rows, every
    row non-finite, an even and an odd count of finite rows, ties, one
    client, a NaN in the reference row (finite rows whose sq is NaN),
    screen_mult 0, 3 and 100, a (W,) and an (m, W) reference, f32 and bf16.
    The two sides sum sq in other orders (``tests/test_torch_faults.py``:
    rtol 2e-6 sqrt(W / 128)); no row of these inputs lies within that of
    the rule's bound, so the masks agree bit for bit.
  * The CPU route is the old composition bitwise: ``screen_uplink``, then
    ``_keep_from``; ``faults.screen_keep`` goes through ``ops.screen_keep``.
  * The launch plan: ``keep_route`` and the constants the wrapper shares
    with ``csrc/screen.cu``.
  * The card's median: a numpy model of the kernel's radix select (four
    passes of 8-bit digits of sq's bits, both ranks) gives the order
    statistics of a sort, so its interpolation is ``nanmedian``'s bitwise.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro.kernels import ops as R
from repro_torch import convert
from repro_torch.core import faults
from repro_torch.kernels import ops
from repro_torch.kernels import screen as SC

from _torch_parity import configs

CASES = ("faulted", "even", "odd", "ties", "all_non_finite", "one_client", "nan_ref")
SHAPES = {"faulted": (8, 256), "even": (9, 128), "odd": (9, 128), "ties": (6, 130),
          "all_non_finite": (5, 128), "one_client": (1, 384), "nan_ref": (7, 128)}


def _case(label, per_row, seed=0):
    """(u, ref) f32 numpy arrays of one case."""
    m, w = SHAPES[label]
    rng = np.random.default_rng(seed + m * w)
    u = rng.standard_normal((m, w)).astype(np.float32)
    r = rng.standard_normal((m, w) if per_row else (w,)).astype(np.float32)
    if label in ("faulted", "even", "odd", "nan_ref"):
        u[1, w // 2] = np.nan          # a NaN entry
        u[2, 0] = np.inf               # an Inf entry
        u[m - 1] = -np.inf             # a -Inf row
        u[3] *= 1e3                    # a blown-up row: an outlier at 3 and 100
        u[4] *= 3.0                    # about 5x the median sq: out at 3, in at 100
    if label == "even":
        u[5] = np.nan                  # 9 - 4 = 5 finite rows: odd; one more NaN row
    if label == "ties":
        u[:] = u[np.arange(m) % 2]     # two distinct rows, each three times
        if per_row:
            r[:] = r[0]
    if label == "all_non_finite":
        u[::2] = np.nan
        u[1::2] = np.inf
    if label == "nan_ref":
        if per_row:
            r[: m // 2, 3] = np.nan    # the first rows' sq is NaN
        else:
            r[3] = np.nan              # every finite row's sq is NaN
    return u, r


@pytest.fixture(params=["xla", "pallas_interpret"])
def impl(request):
    prev = R._DEFAULT_IMPL
    R.set_default_impl(request.param)
    try:
        yield request.param
    finally:
        R.set_default_impl(prev)


@pytest.mark.parametrize("mult", [0.0, 3.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("label", CASES)
def test_screen_keep_matches_reference(impl, label, per_row, dtype, mult):
    u, r = _case(label, per_row)
    jdt = jnp.dtype(dtype)
    ju, jr = jnp.asarray(u).astype(jdt), jnp.asarray(r).astype(jdt)
    rcfg, pcfg = configs(dict(screen=True, screen_mult=mult))
    want = np.asarray(ref_faults.screen_keep(rcfg, ju, jr))
    tu, tr = convert.tensor(ju, "cpu"), convert.tensor(jr, "cpu")
    got = faults.screen_keep(pcfg, tu, tr)
    assert got.dtype == torch.bool and tuple(got.shape) == (u.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.screen_keep(tu, tr, mult), got)
    if label == "all_non_finite" or (label == "nan_ref" and not per_row and mult > 0):
        assert not got.any()
    if label == "faulted":
        assert not got[1] and not got[2] and not got[u.shape[0] - 1]
        assert bool(got[3]) == (mult == 0.0) and bool(got[4]) == (mult != 3.0)


@pytest.mark.parametrize("mult", [0.0, 3.0, 100.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label", CASES)
def test_cpu_route_is_the_old_composition_bitwise(label, dtype, mult):
    """``ops.screen_keep`` on the CPU is ``screen_uplink`` then the rule of
    ``_keep_from``, and the parts ``keep_parts`` gives the checks are
    those of the composition."""
    u, r = (torch.from_numpy(a).to(dtype) for a in _case(label, False, seed=3))
    _, cfg = configs(dict(screen=True, screen_mult=mult))
    fin, sq = ops.screen_uplink(u, r)
    want = faults._keep_from(cfg, fin, sq)
    assert torch.equal(ops.screen_keep(u, r, mult), want)
    assert torch.equal(faults.screen_keep(cfg, u, r), want)
    keep, fin_p, sq_p, med = SC.keep_parts(u, r, mult)
    assert torch.equal(keep, want) and torch.equal(fin_p, fin)
    assert torch.equal(sq_p.view(torch.int32), sq.view(torch.int32))
    if mult > 0:
        want_med = faults.nanmedian(torch.where(fin, sq, math.nan))
        assert torch.equal(med.isnan(), want_med.isnan())
        assert bool(med.isnan()) or torch.equal(med.view(torch.int32), want_med.view(torch.int32))
    else:
        assert med is None


def test_faults_screen_goes_through_the_keep_kernel(monkeypatch):
    """``faults.screen_keep`` is one ``ops.screen_keep`` call: the kernel's
    wrapper, with the config's screen_mult."""
    calls = []
    real = ops.screen_keep
    monkeypatch.setattr(ops, "screen_keep",
                        lambda u, r, mult: calls.append((tuple(u.shape), mult)) or real(u, r, mult))
    _, cfg = configs(dict(screen=True, screen_mult=7.0))
    u, r = (torch.from_numpy(a) for a in _case("faulted", True))
    faults.screen_keep(cfg, u, r)
    assert calls == [(SHAPES["faulted"], 7.0)]


@pytest.mark.parametrize("m,chunks,rule,route", [
    (500, 1, True, "last"), (500, 1, False, "last"), (8, 128, True, "last"),
    (8, 128, False, "last"), (8192, 1, True, "last"), (8193, 1, True, "select"),
    (8193, 1, False, "last"), (10 ** 6, 1, True, "select"), (1, 1, True, "last")])
def test_keep_route(m, chunks, rule, route):
    """One launch ("last", at any count of chunks a row) unless the rule
    must select over more rows than the last block holds ("select": the
    per-row pass, then a cooperative launch)."""
    assert SC.keep_route(m, rule) == route


def test_constants_match_the_cuda_source():
    """The wrapper's launch constants are the kernel's."""
    src = (Path(SC.__file__).parent / "csrc" / "screen.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr [a-z ]+{name} = (\d+);", src).group(1))

    assert SC.SELECT_ROWS == const("kSelectRows")
    assert SC.THREADS == const("kThreads")
    assert SC.WS_INTS == const("kHist") + 4 * 2 * const("kBins")
    params = re.search(r'extern "C" int launch_screen_keep\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(SC.SCREEN_KEEP.argtypes)


# ---------------------------------------------------------------------------
# the card's median: the radix select of csrc/screen.cu, modelled in numpy
# ---------------------------------------------------------------------------

INVALID = 0xFFFFFFFF


def _radix_select(keys, ranks):
    """The kernel's select: for each wanted rank, four passes over 8-bit
    digits from the top; pass 0 one histogram of every key, later passes
    one a rank over the keys sharing its prefix; the digit whose bin holds
    the rank (``pick``: before <= k < before + count), its bins below taken
    off the rank."""
    valid = keys[keys != INVALID].astype(np.uint64)
    prefix, k = [0, 0], list(ranks)
    for p in range(4):
        shift = 8 * (3 - p)
        for r in range(2):
            sel = valid if p == 0 else valid[(valid >> (shift + 8)) == (prefix[r] >> (shift + 8))]
            hist = np.bincount(((sel >> shift) & 255).astype(np.int64), minlength=256)
            before = np.concatenate([[0], np.cumsum(hist)[:-1]])
            d = int(np.nonzero((before <= k[r]) & (k[r] < before + hist))[0][0])
            prefix[r] |= d << shift
            k[r] -= int(before[d])
    return [np.uint32(x).view(np.float32) for x in prefix]


def _model_median(sq, fin):
    """``nanmedian`` of the finite rows' sq as the kernel forms it: the
    count, the ranks and the interpolation in f32, the order statistics by
    ``_radix_select``."""
    f32 = np.float32
    keys = np.where(fin & ~np.isnan(sq), sq.view(np.uint32), INVALID)
    count = int((keys != INVALID).sum())
    if count == 0:
        return f32(np.nan)
    cf = f32(count)
    q = f32(0.5) * (cf - f32(1.0))
    top = cf - f32(1.0)
    ranks = [int(max(min(np.floor(q), top), 0)), int(max(min(np.ceil(q), top), 0))]
    lo, hi = _radix_select(keys, ranks)
    hw = q - f32(np.floor(q))
    lw = f32(1.0) - hw
    with np.errstate(invalid="ignore"):  # Inf * 0 is NaN, as on the card
        return f32(lo * lw) + f32(hi * hw)


@pytest.mark.parametrize("case", ["random", "ties", "wide", "inf", "nan", "one", "two",
                                  "none", "large"])
def test_radix_select_model_is_nanmedian(case):
    """The model of the kernel's select gives ``faults.nanmedian`` bit for
    bit: random and tied sums, sums over many octaves, +Inf sums (an odd
    count's Inf median times 0 is NaN, as the plain f32 ops give it), NaN
    sums and non-finite rows left out, one and two rows, no row, and a
    population past the shared-memory bound."""
    rng = np.random.default_rng(11)
    n = {"one": 1, "two": 2, "large": SC.SELECT_ROWS + 1000}.get(case, 501)
    sq = (rng.random(n) * 1000).astype(np.float32)
    fin = rng.random(n) > 0.1
    if case == "ties":
        sq = np.round(sq / 250).astype(np.float32) * 250
    if case == "wide":
        sq = (10.0 ** rng.uniform(-20, 30, n)).astype(np.float32)
    if case == "inf":
        sq[: n // 2 + 3] = np.inf
    if case == "nan":
        sq[::3] = np.nan
    if case == "none":
        fin[:] = False
    got = _model_median(sq, fin)
    want = faults.nanmedian(torch.where(torch.from_numpy(fin), torch.from_numpy(sq),
                                        math.nan)).numpy()
    assert (np.isnan(got) and np.isnan(want)) or np.float32(got).view(np.uint32) == \
        np.float32(want).view(np.uint32), (got, want)
