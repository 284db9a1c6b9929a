"""Graph-PDMM in the port (``repro_torch.core.topology``,
``repro_torch.core.pdmm_graph`` and kernels 14-15's plain versions) against
the reference (``repro.core.topology``, ``repro.core.pdmm_graph``).

Tolerances:
  * the topology tables are integer tables: equal entry for entry;
  * ``neighbor_reduce`` and ``edge_flip`` against ``"xla"``: bitwise in f32
    and bf16 (the same f32 operations in the same order, one cast back; the
    segment sum adds each node's slots in slot order on both sides);
  * against ``"pallas_interpret"``: ``neighbor_reduce`` bitwise in f32; in
    bf16 within (deg + 1) 2^-8 times the node's sum of |z|, elementwise:
    the reference's Pallas kernel rounds to the output dtype after every
    slot (``src/repro/kernels/neighbor_reduce.py`` lines 58-61), its
    ``"xla"`` branch and the port once (ROADMAP §3), and each of its
    roundings errs by at most half an ulp of a partial sum.  ``edge_flip``
    at tests/test_torch_kernels.py's elementwise tolerance (f32 rtol 1e-6,
    atol 1e-5; bf16 rtol 8e-3, atol 2e-2): interpret mode may contract the
    multiply and the add into one FMA, one rounding fewer, a few f32 ulps
    apart, which can flip the final bf16 rounding by one ulp;
  * rounds, round by round, at tests/_torch_parity.py's tolerances: rtol =
    atol = 1e-5 on node rows, atol 1e-5 c on the edge duals (their scale is
    the penalty c), the consensus error to rtol 1e-3 (a sum of squared
    differences of nearly equal rows, so f32 rounding of the rows is
    amplified by their ratio to the differences) -- the matvec and the
    sums run in another order on each side;
  * on the rank-deficient ``d130_odd`` problem (n = 60 < d = 130) the
    reference's own convergence claims fail on this tree (ROADMAP §3), so
    the port is held to the reference's iterates there, not to x*;
  * star graph == the port's centralised GPDMM / exact PDMM: atol = rtol =
    1e-4, the reference's own contract (tests/test_topology.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make
from repro.core import pdmm_graph as ref_graph
from repro.core import quadratic as ref_quadratic
from repro.core import topology as ref_topology
from repro.core.api import make_oracle as ref_make_oracle
from repro.core.api import make_scan_rounds as ref_scan
from repro.kernels import ops as R
from repro_torch import convert
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, make_scan_rounds, pdmm, pdmm_graph, topology
from repro_torch.core.api import make_oracle
from repro_torch.kernels import ops, ref

from _torch_parity import compare, configs

BF16 = jnp.bfloat16
M = 6

FAMILIES = {
    "star": lambda t: t.star(5),
    "ring": lambda t: t.ring(6),
    "complete": lambda t: t.complete(5),
    "torus": lambda t: t.torus2d(3, 4),
    "er": lambda t: t.erdos_renyi(9, 0.3, seed=2),
}

TABLE_CASES = (
    [("star", m) for m in (1, 5, 8)] + [("ring", m) for m in (3, 6, 8)]
    + [("complete", m) for m in (2, 5, 8)] + [("torus", m) for m in (4, 12, 16)]
    + [("er", m) for m in (5, 9)] + [("er:0.3", m) for m in (6, 9)]
    + [("er:0.7", m) for m in (4, 8)])


def _problem(d):
    ref_prob = ref_quadratic.generate(jax.random.key(0), m=M, n=60, d=d)
    return ref_prob, convert.least_squares(ref_prob, "cpu")


@pytest.fixture(scope="module")
def lsq():
    """The reference's topology problem (m = 6, n = 60, d = 20: W = 128)."""
    return _problem(20)


@pytest.fixture(scope="module")
def lsq130():
    """Its ``d130_odd`` form: W = 256 with 126 padded columns, and
    rank-deficient (n = 60 < d = 130)."""
    return _problem(130)


def _tables(t):
    return dict(src=t.src, nbr=t.nbr, sgn=t.sgn, indptr=t.indptr, rev=t.rev,
                first=t.first_flags(), deg=t.deg)


# ---------------------------------------------------------------------------
# the topology tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("spec, m", TABLE_CASES)
def test_tables_match_reference(spec, m, seed):
    want = ref_topology.make(spec, m, seed=seed)
    got = topology.make(spec, m, seed=seed)
    assert (got.name, got.n, got.n_data) == (want.name, want.n, want.n_data)
    for k, v in _tables(want).items():
        g = _tables(got)[k]
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    assert len(got.colors) == len(want.colors)
    for a, b in zip(got.colors, want.colors):
        np.testing.assert_array_equal(a, b)
    assert got.edges() == want.edges()
    assert got.data_degree_constant() == want.data_degree_constant()
    assert got.max_degree == want.max_degree


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_constructors_match_reference(family):
    want, got = FAMILIES[family](ref_topology), FAMILIES[family](topology)
    for k, v in _tables(want).items():
        np.testing.assert_array_equal(_tables(got)[k], v, err_msg=k)
    i, j = got.edges()[0]
    assert got.slot(i, j) == want.slot(i, j)


@pytest.mark.parametrize("spec, m", [("moebius", 4), ("torus", 7), ("ring:3", 5), ("ring", 2),
                                     ("star", 0), ("complete", 1)])
def test_bad_specs_raise_as_the_reference(spec, m):
    with pytest.raises(ValueError) as want:
        ref_topology.make(spec, m)
    with pytest.raises(ValueError) as got:
        topology.make(spec, m)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# kernels 14-15: the plain versions against "xla" and "pallas_interpret"
# ---------------------------------------------------------------------------

def _pair(a, dtype):
    if dtype == "bf16":
        return jnp.asarray(a).astype(BF16), torch.from_numpy(a.copy()).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_neighbor_reduce_plain_matches_reference(family, dtype, impl):
    t = FAMILIES[family](topology)
    rng = np.random.default_rng(3)
    z_np = rng.standard_normal((t.n_slots, 384)).astype(np.float32)
    z_np[1] = -0.0  # a signed zero row
    zj, zt = _pair(z_np, dtype)
    kw = dict(seg=t.src, first=t.first_flags(), sgn=t.sgn, n=t.n)
    want = _np(R.neighbor_reduce(zj, **kw, impl=impl))
    got = ops.neighbor_reduce(zt, **kw)
    assert got.dtype == zt.dtype and tuple(got.shape) == (t.n, 384)
    if impl == "pallas_interpret" and dtype == "bf16":
        # each of the kernel's roundings errs by at most half a bf16 ulp
        # (2^-9 relative) of a partial sum, which is at most the node's sum
        # of |z|: so |got - want| <= (deg + 1) 2^-8 sum |z| elementwise
        abs_sum = ref.neighbor_reduce_ref(torch.from_numpy(np.abs(_np(zt))),
                                          torch.from_numpy(t.indptr.astype(np.int64)),
                                          torch.ones(t.n_slots, dtype=torch.int64), t.n)
        bound = (t.max_degree + 1) * 2.0 ** -8 * abs_sum.numpy()
        assert np.all(np.abs(_np(got) - want) <= bound)
    else:
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_edge_flip_plain_matches_reference(family, masked, dtype, impl):
    t = FAMILIES[family](topology)
    rng = np.random.default_rng(4)
    z_np = rng.standard_normal((t.n_slots, 256)).astype(np.float32)
    x_np = rng.standard_normal((t.n, 256)).astype(np.float32)
    mask = (np.arange(t.n_slots) % 3 == 0).astype(np.int32) if masked else None
    (zj, zt), (xj, xt) = _pair(z_np, dtype), _pair(x_np, dtype)
    want = _np(R.edge_flip(zj, xj, 1.7, rev=t.rev, nbr=t.nbr, sgn=t.sgn, mask=mask, impl=impl))
    got = ops.edge_flip(zt, xt, 1.7, rev=t.rev, nbr=t.nbr, sgn=t.sgn,
                        mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == zt.dtype
    if impl == "xla":
        np.testing.assert_array_equal(_np(got), want)
    elif dtype == "f32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=8e-3, atol=2e-2)


def test_neighbor_reduce_gives_zeros_to_a_node_without_slots():
    """``segment_sum``'s contract: a segment id that owns no slot sums to
    zero (the plain version keeps it; the reference's Pallas kernel leaves
    such a row undefined)."""
    seg = np.array([0, 0, 2], np.int32)
    first = np.array([1, 0, 1], np.int32)
    sgn = np.array([1, -1, 1], np.int32)
    z = np.arange(6, dtype=np.float32).reshape(3, 2)
    got = ops.neighbor_reduce(torch.from_numpy(z), seg=seg, first=first, sgn=sgn, n=4).numpy()
    want = np.asarray(R.neighbor_reduce(jnp.asarray(z), seg=seg, first=first, sgn=sgn, n=4,
                                        impl="xla"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 3]], 0.0)


def test_slot_tables_are_checked():
    t = topology.ring(5)
    z = torch.zeros(t.n_slots, 4)
    with pytest.raises(ValueError, match="first"):
        ops.neighbor_reduce(z, seg=t.src, first=np.zeros(t.n_slots, np.int32),
                            sgn=np.array(t.sgn), n=t.n)
    with pytest.raises(ValueError, match="sorted"):
        ops.neighbor_reduce(z, seg=t.src[::-1].copy(), first=t.first_flags(), sgn=t.sgn,
                            n=t.n)
    with pytest.raises(ValueError, match="permutation"):
        ops.edge_flip(z, torch.zeros(t.n, 4), 1.0, rev=np.zeros(t.n_slots, np.int32),
                      nbr=t.nbr, sgn=t.sgn)


def test_device_tables_are_built_once_per_topology():
    t = topology.complete(4)
    a = ops.neighbor_reduce(torch.ones(t.n_slots, 8), seg=t.src, first=t.first_flags(),
                            sgn=t.sgn, n=t.n)
    from repro_torch.kernels import neighbor_reduce as nr

    first = nr.reduce_tables(t.src, t.first_flags(), t.sgn, t.n, torch.device("cpu"))
    again = nr.reduce_tables(t.src, t.first_flags(), t.sgn, t.n, torch.device("cpu"))
    assert first[0] is again[0] and first[1] is again[1]
    assert torch.equal(a, torch.zeros_like(a) + torch.tensor(
        [float(np.sum(t.sgn[t.src == i])) for i in range(t.n)])[:, None])


# ---------------------------------------------------------------------------
# graph rounds against the reference, round by round
# ---------------------------------------------------------------------------

TOPOLOGIES = ["star", "ring", "complete", "torus", "er:0.5"]


def run_graph(kw, lsq, rounds, *, oracle="affine", **tol):
    """``rounds`` graph rounds of the reference and the port from the zero
    init, compared after each (``tol``: ``compare``'s ``scale`` and
    ``of_max``); returns the port's state."""
    ref_prob, prob = lsq
    rcfg, pcfg = configs(kw)
    if oracle == "affine":
        rgrad, pgrad = ref_prob.oracle(), prob.oracle()
    elif oracle == "grad_arena":
        rgrad = ref_make_oracle(ref_prob.grad, grad_arena=ref_prob.oracle().grad_arena)
        pgrad = make_oracle(prob.grad, grad_arena=prob.oracle().grad_arena)
    elif oracle == "plain":
        rgrad, pgrad = ref_prob.grad, prob.grad
    else:  # exact
        rgrad, pgrad = ref_prob.make_client_prox(), prob.make_client_prox()
        if oracle == "exact_plain":
            rbase, pbase = rgrad, pgrad
            rgrad, pgrad = (lambda v, r: rbase(v, r)), (lambda v, r: pbase(v, r))
    exact = oracle.startswith("exact")
    rb, pb = (None, None) if exact else (ref_prob.batch(), prob.batch())
    ro, po = ref_make(rcfg), make(pcfg)
    assert po.name == ro.name
    rs = ro.init(jnp.zeros(ref_prob.d, jnp.float32), ref_prob.m)
    ps = po.init(torch.zeros(prob.d), prob.m)
    compare(rs, {}, ps, {}, pcfg)
    ref_round = jax.jit(lambda st: ro.round(st, rgrad, rb))  # as the reference's tests run it
    for _ in range(rounds):
        rs, rm = ref_round(rs)
        ps, pm = po.round(ps, pgrad, pb)
        compare(rs, rm, ps, pm, pcfg, **tol)
    return ps


@pytest.mark.parametrize("sched", ["color", "sync"])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_graph_rounds_match_reference(lsq, topo, sched):
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, graph_schedule=sched,
                   inner_steps=3, eta=0.5 / lsq[0].L), lsq, 8)


@pytest.mark.parametrize("topo, sched", [(t, "color") for t in TOPOLOGIES] + [("ring", "sync")])
def test_partial_participation_graph_rounds_match_reference(lsq, topo, sched):
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, graph_schedule=sched,
                   inner_steps=3, eta=0.5 / lsq[0].L, participation=0.5, seed=11), lsq, 8)


FAULTS = {
    "screened": dict(faults=dict(dropout=0.1, corrupt=0.2, seed=7), screen=True),
    "finite_only": dict(faults=dict(corrupt=0.3, seed=5), screen=True, screen_mult=0.0),
    "silence": dict(faults=dict(dropout=0.3, straggler=0.1, seed=3), screen=False),
    "partial_screened": dict(faults=dict(corrupt=0.2, seed=9), screen=True,
                             participation=0.5),
}


@pytest.mark.parametrize("topo, case", [("ring", c) for c in sorted(FAULTS)]
                         + [("star", "screened"), ("er:0.5", "screened")])
def test_faulted_graph_rounds_match_reference(lsq, topo, case):
    """Corrupted transmissions that pass the screen (a negated row, or the
    1e6 blow-up under finite-only screening) grow the state to 1e5-1e8, so
    each array is held at rtol 1e-5 of its largest value (``of_max``)."""
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, inner_steps=2,
                   eta=0.5 / lsq[0].L, **FAULTS[case]), lsq, 8, of_max=True)


@pytest.mark.parametrize("oracle", ["affine", "grad_arena", "plain"])
@pytest.mark.parametrize("topo", ["star", "ring", "er:0.5"])
def test_gradient_forms_match_reference(lsq, topo, oracle):
    """The affine kernel branch, the constant-degree ``fused_update_arena``
    branch (``grad_arena``, and the plain grad through the tree boundary)
    and, on er, the irregular-degree column branch."""
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, inner_steps=3,
                   eta=0.5 / lsq[0].L, use_avg=oracle != "plain"), lsq, 6, oracle=oracle)


@pytest.mark.parametrize("topo", ["ring", "complete"])
def test_per_node_eta_takes_the_column_branch_as_the_reference(lsq, topo):
    ref_prob = lsq[0]
    eta = tuple(float(e) for e in np.linspace(0.3, 0.6, M) / ref_prob.L)
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, inner_steps=3, eta=eta), lsq, 6,
              oracle="grad_arena")


@pytest.mark.parametrize("topo, oracle, sched", [
    ("star", "exact", "color"), ("ring", "exact", "color"), ("er:0.5", "exact", "color"),
    ("er:0.5", "exact", "sync"), ("ring", "exact_plain", "color"),
    ("ring", "exact_plain", "sync")])
def test_exact_graph_rounds_match_reference(lsq, topo, oracle, sched):
    """The idx-aware prox (the firing subset only) and a plain 2-argument
    prox (the full stacking, firing rows kept).  Tolerances 10x the rounds'
    (x atol 1e-4, the reference's own star contract): the prox solves
    through the eigenbasis, V^T (Atb + rho v) / (evals + rho), where |Atb| /
    rho is O(100), so the f32 rounding of the two products (summed in
    another order on each side) reaches 2e-5 on the rank-deficient d130."""
    run_graph(dict(algorithm="pdmm_graph", topology=topo, graph_schedule=sched, rho=2.0), lsq,
              6, oracle=oracle, scale=10.0)


@pytest.mark.parametrize("sched", ["color", "sync"])
@pytest.mark.parametrize("topo", ["ring", "complete", "er:0.5"])
def test_rank_deficient_rounds_match_reference(lsq130, topo, sched):
    """On d130_odd the reference's convergence tests fail (ROADMAP §3); the
    port is held to its iterates, round by round."""
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, graph_schedule=sched,
                   inner_steps=3, eta=0.5 / lsq130[0].L), lsq130, 8)


@pytest.mark.parametrize("topo", ["star", "ring"])
def test_rank_deficient_exact_and_faulted_rounds_match_reference(lsq130, topo):
    run_graph(dict(algorithm="pdmm_graph", topology=topo, rho=2.0), lsq130, 6,
              oracle="exact", scale=10.0)
    run_graph(dict(algorithm="gpdmm_graph", topology=topo, inner_steps=2,
                   eta=0.5 / lsq130[0].L, participation=0.5, **FAULTS["screened"]), lsq130, 6,
              of_max=True)


def test_whole_round_holds_against_the_interpret_mode_kernels(lsq):
    """One ring round of the reference through its Pallas kernels in
    interpret mode against the port's."""
    ref_prob, prob = lsq
    kw = dict(algorithm="gpdmm_graph", topology="ring", inner_steps=2, eta=0.5 / ref_prob.L)
    rcfg, pcfg = configs(kw)
    prev = R._DEFAULT_IMPL
    R.set_default_impl("pallas_interpret")
    try:
        ro = ref_make(rcfg)
        rs, rm = ro.round(ro.init(jnp.zeros(ref_prob.d), M), ref_prob.oracle(),
                          ref_prob.batch())
    finally:
        R.set_default_impl(prev)
    po = make(pcfg)
    ps, pm = po.round(po.init(torch.zeros(prob.d), M), prob.oracle(), prob.batch())
    compare(rs, rm, ps, pm, pcfg)


# ---------------------------------------------------------------------------
# the star graph is the centralised algorithm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("participation", [1.0, 0.5], ids=["full", "partial"])
@pytest.mark.parametrize("use_avg", [True, False], ids=["avg", "last"])
def test_star_graph_equals_centralised_gpdmm(lsq, use_avg, participation):
    _, prob = lsq
    kw = dict(inner_steps=3, eta=0.5 / prob.L, use_avg=use_avg, participation=participation)
    g = make(FederatedConfig(algorithm="gpdmm_graph", **kw))
    cen = make(FederatedConfig(algorithm="gpdmm", use_arena=True, cohort=False, **kw))
    sg, sc = g.init(torch.zeros(prob.d), M), cen.init(torch.zeros(prob.d), M)
    for r in range(15):
        sg, _ = g.round(sg, prob.oracle(), prob.batch())
        sc, _ = cen.round(sc, prob.oracle(), prob.batch())
        torch.testing.assert_close(g.server_params(sg), cen.server_params(sc), atol=1e-4,
                                   rtol=1e-4, msg=f"x_s at round {r}")
        torch.testing.assert_close(sg["x"][:M, :prob.d], sc["x_c"][:, :prob.d], atol=1e-4,
                                   rtol=1e-4, msg=f"carry at round {r}")


@pytest.mark.parametrize("d", [20, 130], ids=["d20", "d130_odd"])
def test_exact_star_graph_equals_centralised_pdmm(lsq, lsq130, d):
    """Exact graph-PDMM on the star == the port's exact PDMM, and the dual
    map z_{i|s} = lam_{s|i} - rho x_s."""
    _, prob = lsq if d == 20 else lsq130
    cfg = FederatedConfig(algorithm="pdmm_graph", inner_steps=1, eta=0.1, rho=2.0)
    g, cen = pdmm_graph.make_exact(cfg), pdmm.make_exact(cfg)
    prox = prob.make_client_prox()
    topo = pdmm_graph.topo_for(cfg, M)
    sg, sc = g.init(torch.zeros(prob.d), M), cen.init(torch.zeros(prob.d), M)
    for r in range(12):
        sg, _ = g.round(sg, prox, None)
        sc, _ = cen.round(sc, prox, None)
        torch.testing.assert_close(g.server_params(sg), sc["x_s"], atol=1e-4, rtol=1e-4)
        slots = [topo.slot(i, M) for i in range(M)]
        torch.testing.assert_close(sg["z"][slots, :prob.d], sc["lam_s"] - 2.0 * sc["x_s"],
                                   atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# routing, rejections, make_scan_rounds, conversion, padding, the example
# ---------------------------------------------------------------------------

def test_make_routes_topology_as_the_reference():
    assert make(FederatedConfig(algorithm="gpdmm", topology="ring")).name == "gpdmm_graph"
    assert make(FederatedConfig(algorithm="gpdmm")).name == "gpdmm"
    assert make(FederatedConfig(algorithm="gpdmm_graph")).name == "gpdmm_graph"
    assert make(FederatedConfig(algorithm="pdmm_graph")).name == "pdmm_graph"
    for algo in ("scaffold", "fedavg", "agpdmm", "fedsplit"):
        with pytest.raises(ValueError, match="no decentralized analogue") as got:
            make(FederatedConfig(algorithm=algo, topology="ring"))
        with pytest.raises(ValueError) as want:
            ref_make(RefConfig(algorithm=algo, topology="ring"))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(algorithm="gpdmm_graph", uplink_bits=8),
                                dict(algorithm="pdmm_graph", uplink_bits=8),
                                dict(algorithm="gpdmm", topology="ring", uplink_bits=8),
                                dict(algorithm="gpdmm_graph", variance_reduction="svrg")])
def test_graph_rejects_what_the_reference_rejects(kw):
    with pytest.raises(NotImplementedError) as got:
        make(FederatedConfig(**kw))
    with pytest.raises(NotImplementedError) as want:
        ref_make(RefConfig(**kw))
    assert str(got.value) == str(want.value)


def test_unknown_schedule_raises_in_the_round():
    g = make(FederatedConfig(algorithm="gpdmm_graph", graph_schedule="bogus"))
    s = g.init(torch.zeros(4), 3)
    with pytest.raises(ValueError, match="graph_schedule"):
        g.round(s, lambda x, b: x, None)


def test_scan_rounds_match_the_loop_of_rounds(lsq):
    ref_prob, prob = lsq
    cfg = FederatedConfig(algorithm="gpdmm_graph", topology="ring", inner_steps=2,
                          eta=0.5 / prob.L)
    g = make(cfg)
    R_ = 4
    batches = {k: v[None].expand((R_,) + tuple(v.shape)) for k, v in prob.batch().items()}
    s0 = g.init(torch.zeros(prob.d), M)
    s_scan, metrics = make_scan_rounds(g, prob.oracle())(s0, batches)
    assert tuple(metrics["consensus_err"].shape) == (R_,)
    s_loop = s0
    for _ in range(R_):
        s_loop, _ = g.round(s_loop, prob.oracle(), prob.batch())
    for k in ("x", "z", "x_s", "round"):
        assert torch.equal(s_scan[k], s_loop[k]), k
    # and the reference's make_scan_rounds lands on the same state
    rg = ref_make(configs(dict(algorithm="gpdmm_graph", topology="ring", inner_steps=2,
                               eta=0.5 / prob.L))[0])
    rb = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (R_,) + a.shape), ref_prob.batch())
    rs, rm = ref_scan(rg, ref_prob.oracle())(rg.init(jnp.zeros(ref_prob.d), M), rb)
    compare(rs, {}, s_scan, {}, cfg)
    np.testing.assert_allclose(metrics["consensus_err"].numpy(),
                               np.asarray(rm["consensus_err"]), rtol=1e-3)


def test_round_state_carries_a_graph_state_across(lsq):
    ref_prob, prob = lsq
    kw = dict(algorithm="gpdmm_graph", topology="ring", inner_steps=2, eta=0.5 / prob.L)
    rcfg, pcfg = configs(kw)
    ro, po = ref_make(rcfg), make(pcfg)
    rs = ro.init(jnp.zeros(ref_prob.d), M)
    for _ in range(3):
        rs, _ = ro.round(rs, ref_prob.oracle(), ref_prob.batch())
    ps = convert.round_state(rs, "cpu")
    assert sorted(ps) == ["round", "x", "x_s", "z"]
    for k in ("x", "z", "x_s"):
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(rs[k]))
    assert int(ps["round"]) == 3 and ps["round"].dtype == torch.int32
    rs2, rm2 = ro.round(rs, ref_prob.oracle(), ref_prob.batch())
    ps2, pm2 = po.round(ps, prob.oracle(), prob.batch())
    compare(rs2, rm2, ps2, pm2, pcfg)


def test_padding_stays_zero(lsq130):
    _, prob = lsq130
    g = make(FederatedConfig(algorithm="gpdmm_graph", topology="ring", inner_steps=3,
                             eta=0.5 / prob.L))
    s = g.init(torch.zeros(prob.d), M)
    for _ in range(3):
        s, _ = g.round(s, prob.oracle(), prob.batch())
    assert not bool((s["x"][:, :prob.d] == 0).all())
    assert bool((s["x"][:, prob.d:] == 0).all()) and bool((s["z"][:, prob.d:] == 0).all())


def test_silent_nodes_keep_their_rows_and_duals(lsq):
    _, prob = lsq
    cfg = FederatedConfig(algorithm="gpdmm_graph", topology="ring", graph_schedule="sync",
                          inner_steps=3, eta=0.5 / prob.L, participation=0.5, seed=11)
    g = make(cfg)
    topo = pdmm_graph.topo_for(cfg, M)
    from repro_torch.core import tree_util as T
    from repro_torch.core.gpdmm import participation_key

    s = g.init(torch.zeros(prob.d), M)
    mask = T.participation_mask(participation_key(cfg, s["round"]), M, 0.5)
    s1, _ = g.round(s, prob.oracle(), prob.batch())
    for i in range(M):
        if bool(mask[i]):
            assert not torch.equal(s["x"][i], s1["x"][i])
        else:
            assert torch.equal(s["x"][i], s1["x"][i])
            for t in range(topo.n_slots):
                if topo.nbr[t] == i:
                    assert torch.equal(s["z"][t], s1["z"][t])


def test_ring_example_converges_on_cpu():
    """The port of examples/ring_pdmm.py: every node within 1e-2 of x*."""
    ref_prob = ref_quadratic.generate(jax.random.key(0), m=8, n=400, d=64)
    prob = convert.least_squares(ref_prob, "cpu")
    opt = make(FederatedConfig(algorithm="gpdmm", topology="ring", inner_steps=5,
                               eta=0.5 / prob.L))
    assert opt.name == "gpdmm_graph"
    state = opt.init(torch.zeros(prob.d), prob.m)
    for _ in range(300):
        state, metrics = opt.round(state, prob.oracle(), prob.batch())
    worst = float(torch.max(torch.linalg.vector_norm(
        state["x"][:, :prob.d] - prob.x_star[None], dim=1)))
    assert worst < 1e-2, worst
    assert float(metrics["consensus_err"]) < 1e-6
