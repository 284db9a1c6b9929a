"""Kernels 9 and 10 over a table of buffers, and the rounds' ownership
contract: ``fed.round`` writes none of the caller's tensors, a donated
round (``fed.round_``, ``make_scan_rounds`` after its first round) writes
the cohort's rows of its population buffers in place.

On the CPU the wrappers run their plain versions (``index_select``,
``index_copy_``); those are held bitwise to the reference's
``ops.row_gather``/``ops.row_scatter`` under ``"xla"`` and
``"pallas_interpret"`` (a copy rounds nothing).  The CUDA kernel's walk
over its grid (buffer, cohort row, chunk) is modelled here from the
constants of ``csrc/gather.cu`` and must copy every 16-byte vector of the
cohort's rows exactly once.  Donated and functional rounds run the same
operations on the same values, so they are compared bitwise.
``tests/test_torch_cuda.py`` holds the kernels to these plain versions on
the card.
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as R
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import api, autotune, make, make_oracle, make_scan_rounds, quadratic
from repro_torch.core import tree_util as T
from repro_torch.kernels import _args, _build, gather, ops as P

BF16 = jnp.bfloat16
# (dtype, width) of each buffer of a table: one dtype, and a mixed table of
# the widths and dtypes a round's lam, x_c, u_hat and c_i could have
TABLES = {
    "f32": [("f32", 128), ("f32", 128)],
    "bf16": [("bf16", 256), ("bf16", 256), ("bf16", 256)],
    "mixed": [("f32", 128), ("bf16", 384), ("f32", 256), ("bf16", 128)],
}


def _pair(a, dtype):
    if dtype == "bf16":
        return jnp.asarray(a).astype(BF16), torch.from_numpy(a.copy()).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _bits(x):
    """The raw bits of a torch tensor or a jax array, as numpy."""
    if torch.is_tensor(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _table(table, m, mc, seed):
    rng = np.random.default_rng(seed)
    pops = [_pair(rng.standard_normal((m, w)).astype(np.float32), dt) for dt, w in table]
    rows = [_pair(rng.standard_normal((mc, w)).astype(np.float32), dt) for dt, w in table]
    return pops, rows


@pytest.fixture(params=["xla", "pallas_interpret"])
def impl(request):
    prev = R._DEFAULT_IMPL
    try:
        R.set_default_impl(request.param)
        yield request.param
    finally:
        R.set_default_impl(prev)


@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("m,ids", [(10, [0, 3, 4, 9]), (7, [6]), (5, [0, 1, 2, 3, 4])])
def test_buffer_table_matches_reference(impl, table, m, ids, idx_dtype):
    """One gather and one in-place scatter over a table of buffers against
    the reference's per-buffer gather and scatter, bitwise: the in-place
    route writes the cohort's rows and leaves every other row's bits as
    they were; the functional route writes nothing of its input."""
    pops, rows = _table(TABLES[table], m, len(ids), seed=m + len(ids))
    idx = np.asarray(ids, np.int32)
    it = torch.from_numpy(idx).to(getattr(torch, idx_dtype))
    got = P.row_gather_buffers(tuple(p for _, p in pops), it)
    assert len(got) == len(pops)
    for (pj, pt), g in zip(pops, got):
        assert g.shape == (len(ids), pt.shape[1]) and g.dtype == pt.dtype
        np.testing.assert_array_equal(_bits(g), _bits(R.row_gather(pj, jnp.asarray(idx))))

    before = [p.clone() for _, p in pops]
    fresh = P.row_scatter_buffers(tuple(p for _, p in pops), it, tuple(r for _, r in rows))
    for (_, pt), b, f in zip(pops, before, fresh):
        assert torch.equal(pt, b) and f.data_ptr() != pt.data_ptr()
    done = P.row_scatter_buffers_(tuple(p for _, p in pops), it, tuple(r for _, r in rows))
    silent = np.setdiff1d(np.arange(m), idx)
    for (pj, pt), (rj, rt), b, d, f in zip(pops, rows, before, done, fresh):
        assert d is pt
        want = _bits(R.row_scatter(pj, jnp.asarray(idx), rj))
        np.testing.assert_array_equal(_bits(pt), want)
        np.testing.assert_array_equal(_bits(f), want)
        np.testing.assert_array_equal(_bits(pt)[silent], _bits(b)[silent])


@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_single_buffer_forms_match_reference(impl, dtype, idx_dtype):
    """``row_gather``, ``row_scatter`` (a new tensor) and ``row_scatter_``
    (in place, returning its input) on one buffer."""
    (pop, rows), = zip(*_table([(dtype, 384)], 9, 3, seed=4))
    (pj, pt), (rj, rt) = pop, rows
    idx = np.asarray([1, 4, 8], np.int32)
    it = torch.from_numpy(idx).to(getattr(torch, idx_dtype))
    np.testing.assert_array_equal(_bits(P.row_gather(pt, it)),
                                  _bits(R.row_gather(pj, jnp.asarray(idx))))
    want = _bits(R.row_scatter(pj, jnp.asarray(idx), rj))
    before = pt.clone()
    np.testing.assert_array_equal(_bits(P.row_scatter(pt, it, rt)), want)
    assert torch.equal(pt, before)
    assert P.row_scatter_(pt, it, rt) is pt
    np.testing.assert_array_equal(_bits(pt), want)


def test_plain_scatter_checks_the_ids():
    """The CPU's plain scatter refuses an id out of range (the card's
    kernel trusts ``cohort_indices``)."""
    with pytest.raises((IndexError, RuntimeError)):
        P.row_scatter_(torch.zeros(4, 128), torch.tensor([4]), torch.ones(1, 128))


# ---------------------------------------------------------------------------
# the CUDA kernel's walk over its grid, modelled from its source
# ---------------------------------------------------------------------------

def _constants():
    text = (_build.CSRC / "gather.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr \w+(?: \w+)? {name} = (\d+);", text).group(1))
    return {k: get(k) for k in ("kThreads", "kUnroll", "kMaxBufs", "kDescWords")}


def test_buffer_limit_and_descriptor_match_the_source():
    c = _constants()
    assert gather.MAX_BUFFERS == c["kMaxBufs"] >= 4  # lam, x_c, u_hat, c_i
    assert c["kDescWords"] == 3
    assert gather.ROW_GATHER.argtypes == gather.ROW_SCATTER.argtypes
    assert len(gather.ROW_GATHER.argtypes) == 7


def _model(pops, cohorts, idx, scatter):
    """The kernel's grid walked block by block (as ``row_copy_kernel``
    and ``launch_rows`` compute it): returns the copies and how often each
    16-byte vector of the destination was written."""
    c = _constants()
    chunk = c["kThreads"] * c["kUnroll"]
    bufs, blocks = [], 0
    for p, q in zip(pops, cohorts):
        rv = p.shape[1] * p.itemsize // 16
        chunks = -(-rv // chunk)
        bufs.append((p.view(np.uint8).reshape(p.shape[0], rv, 16),
                     q.view(np.uint8).reshape(q.shape[0], rv, 16), rv, chunks, blocks))
        blocks += len(idx) * chunks
    hits = [np.zeros((b[0] if scatter else b[1]).shape[:2], np.int64) for b in bufs]
    for blk in range(blocks):
        s = 0
        while s + 1 < len(bufs) and bufs[s + 1][4] <= blk:
            s += 1
        pop, coh, rv, chunks, block0 = bufs[s]
        t, ch = divmod(blk - block0, chunks)
        for th in range(c["kThreads"]):
            for u in range(c["kUnroll"]):
                j = ch * chunk + th + u * c["kThreads"]
                if j < rv:
                    if scatter:
                        pop[idx[t], j] = coh[t, j]
                        hits[s][idx[t], j] += 1
                    else:
                        coh[t, j] = pop[idx[t], j]
                        hits[s][t, j] += 1
    return hits


@pytest.mark.parametrize("widths", [(128, 512), (6144, 2048, 128), (1024,) * 8])
def test_kernel_walk_copies_each_vector_once(widths):
    """Buffers whose rows take part of a 16 KiB chunk, one and a half
    (6,144 f32 values), and a full table: every vector of each cohort row
    is copied once, in both directions, and nothing else is written."""
    rng = np.random.default_rng(len(widths))
    m, idx = 6, np.array([0, 2, 5])
    pops = [rng.standard_normal((m, w)).astype(np.float32) for w in widths]
    cohorts = [np.zeros((len(idx), w), np.float32) for w in widths]
    hits = _model(pops, cohorts, idx, scatter=False)
    for p, q, h in zip(pops, cohorts, hits):
        np.testing.assert_array_equal(q, p[idx])
        assert np.all(h == 1)
    fresh = [rng.standard_normal(q.shape).astype(np.float32) for q in cohorts]
    want = [p.copy() for p in pops]
    for w, f in zip(want, fresh):
        w[idx] = f
    hits = _model(pops, fresh, idx, scatter=True)
    for p, w, h in zip(pops, want, hits):
        np.testing.assert_array_equal(p, w)
        assert np.all(h[idx] == 1) and np.all(np.delete(h, idx, axis=0) == 0)


# ---------------------------------------------------------------------------
# the rounds: one gather and one scatter a cohort round; donated == functional
# ---------------------------------------------------------------------------

M = 8
SCREENED = dict(faults=FaultConfig(dropout=0.2, corrupt=0.2, seed=7), screen=True)
# (algorithm, extra config, problem): "lsq" the least-squares arena oracle
# (one inner-loop kernel), "bf16" a bf16 tree with the 0.3 x arena gradient
ROUNDS = {
    "gpdmm": ("gpdmm", {}, "lsq"),
    "gpdmm_ef21": ("gpdmm", dict(uplink_bits=8), "lsq"),
    "gpdmm_screened": ("gpdmm", SCREENED, "lsq"),
    "gpdmm_ef21_screened": ("gpdmm", dict(uplink_bits=8, **SCREENED), "lsq"),
    "gpdmm_tile": ("gpdmm", dict(cohort_tile=2), "lsq"),
    "gpdmm_bf16": ("gpdmm", {}, "bf16"),
    "agpdmm": ("agpdmm", {}, "lsq"),
    "agpdmm_ef21": ("agpdmm", dict(uplink_bits=8), "lsq"),
    "agpdmm_bf16": ("agpdmm", dict(uplink_bits=8), "bf16"),
    "scaffold": ("scaffold", {}, "lsq"),
    "scaffold_screened": ("scaffold", SCREENED, "lsq"),
    "scaffold_tile": ("scaffold", dict(cohort_tile=2), "lsq"),
    "fedavg": ("fedavg", {}, "lsq"),
    "fedavg_ef21": ("fedavg", dict(uplink_bits=8), "lsq"),
    "fedavg_screened": ("fedavg", SCREENED, "bf16"),
}
# the population buffers each algorithm's cohort round writes
WRITTEN = {"gpdmm": ("x_c", "u_hat"), "agpdmm": ("u_hat",), "scaffold": ("c_i",),
           "fedavg": ("u_hat",)}
# one gather and one scatter a round; the gather reads the cached u_hat rows
# too when the uplink reads them (EF21, faults), and FedAvg gathers only then
GATHERS = {"gpdmm": 1, "agpdmm": 1, "scaffold": 1, "fedavg": 0}


def _problem(kind):
    """(params, oracle, batch) for the round tests."""
    if kind == "lsq":
        prob = quadratic.generate(torch.Generator().manual_seed(0), m=M, n=40, d=24,
                                  device="cpu")
        return torch.zeros(prob.d), prob.oracle(), prob.batch()
    rng = np.random.default_rng(3)
    params = {"a": torch.from_numpy(rng.standard_normal(200).astype(np.float32)).bfloat16(),
              "b": torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32)).bfloat16()}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    return params, grad, {"d": torch.zeros(M, 1)}


def _setup(name, **kw):
    algo, extra, kind = ROUNDS[name]
    params, grad, batch = _problem(kind)
    cfg = FederatedConfig(algorithm=algo, inner_steps=3, eta=0.05, use_arena=True,
                          participation=0.5, **extra, **kw)
    fed = make(cfg)
    return fed, fed.init(params, M), grad, batch


def _clone(state):
    return {k: T.tmap(lambda t: t.clone(), v) for k, v in state.items()}


def _assert_same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        for x, y in zip(T.leaves(a[k]), T.leaves(b[k]), strict=True):
            assert x.dtype == y.dtype and torch.equal(
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                y.view(torch.int16) if y.dtype == torch.bfloat16 else y), f"{what}: {k}"


@pytest.mark.parametrize("name", ROUNDS)
def test_donated_scan_equals_functional_rounds(name):
    """``make_scan_rounds`` over R = 4 rounds (the first functional, the
    others donated) equals 4 ``fed.round`` calls state for state and
    metric for metric, bitwise, and leaves the caller's state as it was;
    so do 4 ``fed.round_`` calls on a state the caller gives up."""
    fed, state, grad, batch = _setup(name)
    R = 4
    batches = T.tmap(lambda x: torch.stack([x] * R), batch)
    want_s, want_m = state, []
    for _ in range(R):
        want_s, mt = fed.round(want_s, grad, batch)
        want_m.append(mt)
    caller = _clone(state)
    got_s, got_m = make_scan_rounds(fed, grad)(state, batches)
    _assert_same(state, caller, "the caller's state")
    _assert_same(got_s, want_s, "scan state")
    for k in want_m[0]:
        assert torch.equal(got_m[k], torch.stack([mt[k] for mt in want_m])), k
    s = _clone(caller)
    for _ in range(R):
        s, _ = fed.round_(s, grad, batch)
    _assert_same(s, want_s, "donated rounds")


@pytest.mark.parametrize("name", ["gpdmm", "agpdmm_ef21", "scaffold", "fedavg_ef21"])
def test_donated_round_writes_the_cohort_rows_in_place(name, monkeypatch):
    """``fed.round_`` returns the caller's own population buffers, written
    in the cohort's rows only; ``fed.round`` returns new ones and writes
    none.  Each cohort round makes one gather and one scatter call (none
    for FedAvg's gather without EF21)."""
    fed, state, grad, batch = _setup(name)
    state, _ = fed.round(state, grad, batch)  # rows that differ from row to row
    algo = ROUNDS[name][0]
    calls = {}
    on_cpu = _args.on_cpu

    def counting(kname, t):
        calls[kname] = calls.get(kname, 0) + 1
        return on_cpu(kname, t)

    monkeypatch.setattr(_args, "on_cpu", counting)
    before = _clone(state)
    want, _ = fed.round(state, grad, batch)
    _assert_same(state, before, "functional round")
    for k in WRITTEN[algo]:
        assert want[k].data_ptr() != state[k].data_ptr()
    got, _ = fed.round_(state, grad, batch)
    _assert_same(got, want, "donated round")
    for k in WRITTEN[algo]:
        assert got[k] is state[k]
        changed = torch.any(got[k] != before[k], dim=1)
        assert 0 < int(changed.sum()) <= M // 2, k
    reads = ROUNDS[name][1].get("uplink_bits") is not None
    n_gather = GATHERS[algo] + (algo == "fedavg" and reads)
    assert calls.get("row_gather", 0) == 2 * n_gather
    assert calls.get("row_scatter", 0) == 2


def test_residual_chunks_stay_functional():
    """``tol > 0`` reads the state before each round: its chunk runs every
    round functionally and gives the residuals of the functional rounds,
    bitwise, and the same states as the donated chunk."""
    fed, state, grad, batch = _setup("gpdmm_ef21")
    R = 3
    batches = T.tmap(lambda x: torch.stack([x] * R), batch)
    caller = _clone(state)
    got_s, got_m = make_scan_rounds(fed, grad, tol=1e-6)(state, batches)
    _assert_same(state, caller, "the caller's state")
    s, res = state, []
    for _ in range(R):
        new, _ = fed.round(s, grad, batch)
        res.append(autotune.state_residual(s, new))
        s = new
    _assert_same(got_s, s, "tol > 0 state")
    for k in ("res_dx2", "res_x2"):
        assert torch.equal(got_m[k], torch.stack([r[k] for r in res])), k
    donated_s, _ = make_scan_rounds(fed, grad)(state, batches)
    _assert_same(donated_s, s, "donated chunk")


def test_scan_donates_only_the_states_it_made(monkeypatch):
    """Of R rounds, ``make_scan_rounds`` gives the first the caller's state
    through ``fed.round`` and the R - 1 others through ``fed.round_``; with
    ``tol > 0`` every round is functional."""
    fed, state, grad, batch = _setup("gpdmm")
    used, plain = [], fed
    fed = fed._replace(round=lambda *a: (used.append("round"), plain.round(*a))[1],
                       round_=lambda *a: (used.append("round_"), plain.round_(*a))[1])
    batches = T.tmap(lambda x: torch.stack([x] * 3), batch)
    make_scan_rounds(fed, grad)(state, batches)
    assert used == ["round", "round_", "round_"]
    used.clear()
    make_scan_rounds(fed, grad, tol=1e-6)(state, batches)
    assert used == ["round"] * 3


@pytest.mark.parametrize("how", ["same_tensor", "view", "strided"])
def test_aliased_state_buffer_is_copied_not_written_through(how):
    """A donated GPDMM round on a state whose x_c is u_hat itself, a view of
    it, or a non-contiguous tensor: the round copies that buffer before its
    first in-place write, so its result equals the functional round on an
    unaliased copy of the state."""
    fed, state, grad, batch = _setup("gpdmm")
    state, _ = fed.round(state, grad, batch)
    state["x_c"] = state["u_hat"].clone()  # equal values, so the rounds agree
    want, _ = fed.round(_clone(state), grad, batch)
    if how == "same_tensor":
        state["x_c"] = state["u_hat"]
    elif how == "view":
        state["x_c"] = state["u_hat"][:]
    else:
        state["x_c"] = state["u_hat"].t().contiguous().t()
    got, _ = fed.round_(state, grad, batch)
    _assert_same(got, want, how)
    assert got["x_c"].untyped_storage().data_ptr() != got["u_hat"].untyped_storage().data_ptr()
    assert got["x_c"].is_contiguous()


def test_owned_copies_only_what_it_must():
    """``api.owned``: an unaliased contiguous buffer is kept as it is; an
    alias of another entry, or a non-contiguous buffer, is copied once."""
    a, b = torch.randn(4, 128), torch.randn(4, 128)
    st = {"x_c": a, "u_hat": b, "round": torch.zeros((), dtype=torch.int32)}
    out = api.owned(st, ("x_c", "u_hat"))
    assert out["x_c"] is a and out["u_hat"] is b
    out = api.owned({"x_c": a, "u_hat": a, "lam_s": b}, ("x_c", "u_hat"))
    assert out["x_c"] is not a and torch.equal(out["x_c"], a) and out["u_hat"] is a
    out = api.owned({"c_i": b.t().contiguous().t(), "x_s": {"w": a}}, ("c_i", "u_hat"))
    assert out["c_i"].is_contiguous() and torch.equal(out["c_i"], b)
    assert "u_hat" not in out
