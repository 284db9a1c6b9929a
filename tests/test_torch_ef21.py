"""The EF21 uplink as one pass (``ops.ef21_update``, ``csrc/ef21.cu``).

On the CPU ``ops.ef21_update`` is the plain composition (the row max, the
per-(client, leaf) scales, the apply pass), which the card's kernel is held
to bit for bit.  Here:

* the route (``round_tail.ef21_route``) at Fig. 2's, the softmax arena's,
  ``lm_flat``'s and ``lm_tree``'s layouts and at each route's limits, and
  the launch plan built from ``leaf_rows`` (the leaf table the kernel
  searches), with its refusals;
* a model of the kernel's walk over that plan -- each group's span found by
  the kernel's binary search, a span's max-abs stored or combined as
  ``atomicMax`` combines the bits of |d|, the apply pass in either order --
  bitwise the plain composition, every 16-byte chunk written once;
* the plain composition against the reference's ``ops.ef21_update``
  (``"xla"`` bitwise; ``"pallas_interpret"`` at the elementwise tolerance
  of ``tests/test_torch_kernels.py``: interpret mode may fuse u_hat + q s
  into one FMA) on inputs drawn with numpy from a seed: ``lm_tree``'s six
  leaves packed on the arena, a +-Inf element, an all-zero leaf, and
  ``bits=2`` (lo = 1).
"""
import bisect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R
from repro_torch.kernels import ops as P
from repro_torch.kernels import ref
from repro_torch.kernels import round_tail as RT

F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(RT.__file__).resolve().parent / "csrc" / "ef21.cu"
# lm_tree (benchmarks/round_bench.py:62-72) packed on the arena, leaves in
# sorted key order: bias (768,), blk0_w1, blk0_w2, blk1_w1, blk1_w2
# (393,216 each), embed (196,608), in 128-lane rows
LM_TREE_ROWS = (6, 3072, 3072, 3072, 3072, 1536)


def _const(name):
    m = re.search(r"constexpr (?:int|size_t) " + name + r" = ([^;]+);", CSRC.read_text())
    assert m, name
    return m.group(1)


def test_plan_constants_match_the_kernel():
    """The host's modes, group sizes and chunks a thread are the kernel's;
    the large leaf table fits the parameter limit of either toolkit."""
    text = CSRC.read_text()
    assert "enum Mode : int { kMax = 0, kApply = 1, kFused = 2 };" in text
    assert (RT.EF21_MAX, RT.EF21_APPLY_MODE, RT.EF21_FUSED) == (0, 1, 2)
    assert int(_const("kThreads")) == RT.EF21_THREADS["block"] == RT.EF21_THREADS["wide"] == 256
    assert RT.EF21_THREADS["warp"] == 32
    assert int(_const("kMaxChunks")) == RT.RESIDENT_CHUNKS == 8
    assert int(_const("kWideChunks")) == RT.WIDE_CHUNKS == 4
    assert int(_const("kSmallLeaves")) == 8
    assert _const("kMaxLeaves") == "(int)((kParamLimit - kHeader) / 8) - 1"
    assert [(lim - 72) // 8 - 1 for lim in (32764, 4096)] == [4085, 502]


@pytest.mark.parametrize("leaf_rows,dtype,route", [
    ((4,), F32, "warp"),                 # Fig. 2 (m = d = 500, W = 512)
    ((4,), BF16, "warp"),
    ((3, 1), F32, "warp"),
    ((62,), F32, "block"),               # the softmax arena (W = 7,936)
    ((62,), BF16, "block"),
    ((8192,), F32, "wide"),              # lm_flat (2^20 values a client)
    ((8192,), BF16, "wide"),
    (LM_TREE_ROWS, F32, "wide"),         # lm_tree's six leaves
    ((8,), F32, "warp"), ((9,), F32, "block"), ((64,), F32, "block"), ((65,), F32, "wide"),
    ((16,), BF16, "warp"), ((17,), BF16, "block"), ((128,), BF16, "block"),
    ((129,), BF16, "wide"),
    ((1, 1, 1, 70), F32, "wide"),        # the longest leaf decides
], ids=lambda c: str(c))
def test_ef21_route(leaf_rows, dtype, route):
    """Warp while the longest leaf fits 32 x 8 16-byte chunks (8 f32 rows,
    16 bf16), block while it fits 256 x 8 (64 f32 rows, 128 bf16), else
    wide."""
    assert RT.ef21_route(leaf_rows, dtype) == route
    plan = RT.ef21_plan(leaf_rows, 128 * sum(leaf_rows), dtype)
    assert plan.route == route and plan.threads == RT.EF21_THREADS[route]


def test_ef21_plan_tables():
    """The leaf table at the main paths' layouts: each leaf's first chunk
    of a client row (32 a row in f32, 16 in bf16), and its first span --
    one a leaf on the resident routes (chunks a thread: the power of two
    that holds the longest leaf), ceil(chunks / 1,024) on the wide route."""
    assert RT.ef21_plan((4,), 512, F32) == ("warp", 32, 4, (0, 128), (0, 1))
    assert RT.ef21_plan((4,), 512, BF16) == ("warp", 32, 2, (0, 64), (0, 1))
    assert RT.ef21_plan((3, 1), 512, F32) == ("warp", 32, 4, (0, 96, 128), (0, 1, 2))
    assert RT.ef21_plan((62,), 7936, F32) == ("block", 256, 8, (0, 1984), (0, 1))
    assert RT.ef21_plan((62,), 7936, BF16) == ("block", 256, 4, (0, 992), (0, 1))
    assert RT.ef21_plan((8192,), 1 << 20, F32) == ("wide", 256, 4, (0, 262144), (0, 256))
    tree = RT.ef21_plan(LM_TREE_ROWS, 128 * sum(LM_TREE_ROWS), F32)
    assert tree.chunk0 == (0, 192, 98496, 196800, 295104, 393408, 442560)
    assert tree.span0 == (0, 1, 97, 193, 289, 385, 433)
    # forced: the wide route takes any layout, a resident one only what it holds
    assert RT.ef21_plan((4,), 512, F32, "wide") == ("wide", 256, 4, (0, 128), (0, 1))
    assert RT.ef21_plan((3, 1), 512, F32, "block").chunks == 1
    with pytest.raises(ValueError, match="does not fit the warp route"):
        RT.ef21_plan((62,), 7936, F32, "warp")
    with pytest.raises(ValueError, match="does not fit the block route"):
        RT.ef21_plan((8192,), 1 << 20, F32, "block")
    with pytest.raises(ValueError, match="route 'cluster'"):
        RT.ef21_plan((4,), 512, F32, "cluster")


@pytest.mark.parametrize("leaf_rows,width", [((4,), 640), ((3,), 512), ((2, 3), 512), ((), 128),
                                             ((5, -1), 512)])
def test_ef21_plan_refuses_leaves_that_miss_the_width(leaf_rows, width):
    with pytest.raises(ValueError, match="leaf_rows"):
        RT.ef21_plan(leaf_rows, width, F32)


def test_ef21_update_refuses_leaves_that_miss_the_width_on_the_cpu():
    """The plain composition refuses them too, as the reference asserts."""
    x = torch.zeros(2, 512)
    with pytest.raises(ValueError, match="leaf_rows"):
        P.ef21_update(x, x, 8, (3,))


# ---------------------------------------------------------------------------
# the kernel's walk over the plan, modelled
# ---------------------------------------------------------------------------

def _bits_max(a: float, b: float) -> float:
    """atomicMax on the bits of two non-negative floats (a NaN above +Inf)."""
    ia, ib = (int(torch.tensor(v, dtype=F32).view(torch.int32)) for v in (a, b))
    return a if ia >= ib else b


def kernel_model(u, u_hat, bits, plan, reverse=True):
    """u_hat' as csrc/ef21.cu computes it from ``plan``: the groups in
    launch order (the wide route's apply pass reversed when ``reverse``),
    each finding its leaf by the kernel's binary search over span0; the
    arithmetic the plain version's, element for element.  Also returns
    how often each 16-byte chunk was written."""
    m, w = u.shape
    vec = 16 // u.element_size()
    uf = u.to(F32).reshape(m, w // vec, vec)
    hf = u_hat.to(F32).reshape(m, w // vec, vec)
    nleaf, spans = len(plan.chunk0) - 1, plan.span0[-1]
    cap = plan.threads * plan.chunks
    lo = float(2 ** (bits - 1) - 1)
    lo_t = torch.tensor(lo, dtype=F32)
    out = torch.empty(m, w // vec, vec, dtype=u.dtype)
    writes = torch.zeros(m, w // vec, dtype=torch.int64)

    def span(gid):
        i, j = divmod(gid, spans)
        k = bisect.bisect_right(plan.span0, j, 0, nleaf) - 1
        c0 = plan.chunk0[k] + (j - plan.span0[k]) * cap
        return i, k, c0, min(plan.chunk0[k + 1], c0 + cap)

    def span_max(i, c0, c1):
        d = uf[i, c0:c1] - hf[i, c0:c1]
        return float(torch.amax(torch.abs(d))) if c1 > c0 else 0.0

    def scale(mx):
        return torch.clamp(torch.tensor(mx, dtype=F32) / lo_t, min=1e-12)

    def apply(i, c0, c1, s):
        d = uf[i, c0:c1] - hf[i, c0:c1]
        q = torch.clamp(torch.round(d / s), -lo, lo)
        out[i, c0:c1] = (hf[i, c0:c1] + q * s).to(u.dtype)
        writes[i, c0:c1] += 1

    groups = range(m * spans)
    if plan.route != "wide":
        for gid in groups:
            i, _, c0, c1 = span(gid)
            apply(i, c0, c1, scale(span_max(i, c0, c1)))
    else:
        table = [[0.0] * nleaf for _ in range(m)]
        for gid in groups:
            i, k, c0, c1 = span(gid)
            whole = plan.span0[k + 1] - plan.span0[k] == 1
            mx = span_max(i, c0, c1)
            table[i][k] = mx if whole else _bits_max(table[i][k], mx)
        for gid in (reversed(groups) if reverse else groups):
            i, k, c0, c1 = span(gid)
            apply(i, c0, c1, scale(table[i][k]))
    return out.reshape(m, w), writes


def _inputs(m, leaf_rows, dtype, seed, *, inf=None, zero=None, nan=True):
    """u = u_hat + a delta of mixed scale per client; a NaN in client 1's
    first leaf, a +-Inf at ``inf`` (client, column), client 0's leaf
    ``zero`` with u == u_hat."""
    w = 128 * sum(leaf_rows)
    rng = np.random.default_rng(seed)
    u_hat = rng.standard_normal((m, w)).astype(np.float32)
    u = u_hat + rng.standard_normal((m, w)).astype(np.float32) * np.linspace(
        0.01, 3.0, m, dtype=np.float32)[:, None]
    if nan and m > 1:
        u[1, 5] = np.nan
    if inf is not None:
        u[inf] = -np.inf if inf[1] % 2 else np.inf
    if zero is not None:
        c0 = 128 * sum(leaf_rows[:zero])
        u[0, c0:c0 + 128 * leaf_rows[zero]] = u_hat[0, c0:c0 + 128 * leaf_rows[zero]]
    return u, u_hat


def _same_bits(got, want):
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    ity = torch.int32 if got.element_size() == 4 else torch.int16
    assert torch.equal(got[~nan].view(ity), want[~nan].view(ity))


MODEL_CASES = [  # (m, leaf_rows, dtype, route): every route, one span and many a leaf
    (3, (4,), F32, None), (3, (3, 1), F32, None), (3, (4,), BF16, None),
    (2, (62,), F32, None), (2, (61, 1), BF16, None),
    (3, (4,), F32, "wide"), (3, (3, 1), BF16, "wide"), (2, (62,), F32, "wide"),
    (2, (40, 1, 70), F32, None), (2, (40, 1, 70), BF16, "wide"), (2, (3, 1), F32, "block"),
]


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: f"{c[1]}-{c[2]}-{c[3]}")
def test_kernel_walk_matches_plain_composition(case, bits):
    """The kernel's walk over its plan gives the plain composition's bits
    (a NaN leaf, an Inf leaf and an all-zero leaf among them), with every
    chunk written once; the wide route's apply pass in either order."""
    m, leaf_rows, dtype, route = case
    w = 128 * sum(leaf_rows)
    u, u_hat = _inputs(m, leaf_rows, dtype, seed=w + bits, inf=(m - 1, w - 3),
                       zero=len(leaf_rows) - 1)
    ut, ht = torch.from_numpy(u).to(dtype), torch.from_numpy(u_hat).to(dtype)
    want = ref.ef21_update_ref(ut, ht, bits, leaf_rows)
    plan = RT.ef21_plan(leaf_rows, w, dtype, route)
    for reverse in ((True, False) if plan.route == "wide" else (True,)):
        got, writes = kernel_model(ut, ht, bits, plan, reverse)
        assert torch.equal(writes, torch.ones_like(writes))
        _same_bits(got, want)


# ---------------------------------------------------------------------------
# the plain composition against the reference
# ---------------------------------------------------------------------------

def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x.astype(jnp.float32))


REFERENCE_CASES = {
    # name: (m, leaf_rows, inf (client, column) or None, all-zero leaf or None)
    "lm_tree_six_leaves": (2, LM_TREE_ROWS, None, None),
    "inf_element": (3, (3, 1), (2, 130), None),
    "neg_inf_element": (3, (62,), (0, 7001), None),
    "all_zero_leaf": (3, (2, 1, 1), None, 1),
}


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(REFERENCE_CASES))
def test_ef21_update_matches_reference(name, dtype, bits, impl):
    """``ops.ef21_update`` on the CPU against the reference's: the six-leaf
    layout, an Inf or -Inf turning only its (client, leaf) to NaN, an
    all-zero leaf whose scale is 1e-12 (u_hat' = u_hat there), and
    lo = 1 at two bits."""
    m, leaf_rows, inf, zero = REFERENCE_CASES[name]
    u, u_hat = _inputs(m, leaf_rows, dtype, seed=sum(leaf_rows) + bits, inf=inf, zero=zero,
                       nan=name != "lm_tree_six_leaves")
    tdt, jdt = (BF16, jnp.bfloat16) if dtype == "bf16" else (F32, jnp.float32)
    ut, ht = torch.from_numpy(u).to(tdt), torch.from_numpy(u_hat).to(tdt)
    got = P.ef21_update(ut, ht, bits, leaf_rows)
    want = R.ef21_update(jnp.asarray(u).astype(jdt), jnp.asarray(u_hat).astype(jdt), bits,
                         leaf_rows, impl=impl)
    assert got.dtype == tdt and tuple(got.shape) == u.shape
    a, b = _np(want), _np(got)
    if impl == "xla":
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=8e-3 if dtype == "bf16" else 1e-6, atol=1e-5)
    bounds = np.cumsum((0,) + leaf_rows) * 128
    nan_leaves = {(i, k) for i in range(m) for k in range(len(leaf_rows))
                  if np.isnan(b[i, bounds[k]:bounds[k + 1]]).any()}
    want_nan = {(i, int(np.searchsorted(bounds, c, side="right")) - 1)
                for i, c in ([(1, 5)] if name != "lm_tree_six_leaves" else []) + ([inf] if inf
                                                                                 else [])}
    assert nan_leaves == want_nan
    for i, k in nan_leaves:
        assert np.isnan(b[i, bounds[k]:bounds[k + 1]]).all()
    if zero is not None:
        c = slice(bounds[zero], bounds[zero + 1])
        np.testing.assert_array_equal(b[0, c], _np(ht)[0, c])
        scales = ref.ef21_row_scales_ref(ref.ef21_rowmax_ref(ut, ht), leaf_rows,
                                         float(2 ** (bits - 1) - 1))
        r0 = sum(leaf_rows[:zero])
        assert torch.all(scales[0, r0:r0 + leaf_rows[zero]] == torch.tensor(1e-12, dtype=F32))
