"""The eq. (20) client step of a whole tree in one launch, with x_bar's
running sum in the same pass (``ops.fused_update_leaves`` and the ``acc``
of ``ops.fused_update_arena``), against the reference's per-leaf step and
its separate sum passes; and whole rounds on the reference benchmark's
``lm_tree`` (``benchmarks/round_bench.py:62-72``) on the pytree path.

On the CPU the wrappers run their plain versions (``kernels/ref.py``), the
arithmetic the CUDA kernel is held to on the card
(``tests/test_torch_cuda.py``).  Inputs come from numpy with a seed.

Tolerances, as ``tests/test_torch_kernels.py::test_fused_update_matches_reference``
states them: bitwise against ``"xla"`` (the same f32 operations in the
same order, cast back at the same points, the sums ``tree_add`` and ``*
(1/K)`` as JAX's weak type rounds them); against ``"pallas_interpret"``
rtol 1e-6 and atol 1e-6 (its body may contract a multiply and an add into
one FMA), rtol 8e-3 (one bf16 ulp) on bf16 leaves.  Each step starts both
sides from the reference's iterate, so a difference of one step does not
carry into the next.  Whole rounds: ``tests/_torch_parity.py``'s
``compare_trees`` (rtol = atol = 1e-5 on x-level values).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import tree_util as RT
from repro.kernels import ops as R
from repro_torch import convert
from repro_torch.core import make
from repro_torch.kernels import _args, ops as P, ref

from _torch_parity import compare, configs, run_trees

# per-leaf shapes behind the client dim m: test_torch_kernels.LEAF_SHAPES'
# family (a scalar per client, ragged sizes, the Fig. 2 leaf's), lm_tree's
# six leaves, and a tree of bf16 and f32 leaves
LM_TREE = [(512, 384), (768, 512), (512, 768), (768, 512), (512, 768), (768,)]
TREES = {
    "leaf_shapes": (5, [((), "f32"), ((7,), "f32"), ((3, 50), "f32"), ((130,), "f32")]),
    "lm_tree": (2, [(s, "f32") for s in LM_TREE]),
    "mixed": (4, [((7,), "bf16"), ((3, 5), "f32"), ((13,), "bf16"), ((), "f32")]),
}


@pytest.fixture(params=["xla", "pallas_interpret"])
def impl(request):
    prev = R._DEFAULT_IMPL
    try:
        R.set_default_impl(request.param)
        yield request.param
    finally:
        R.set_default_impl(prev)


def _pair(a, dt):
    """The same numbers as a jax array and a torch tensor."""
    if dt == "bf16":
        j = jnp.asarray(a).astype(jnp.bfloat16)
        return j, convert.tensor(j, "cpu")
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _same(want, got, impl):
    a, b = _np(want), _np(got)
    if impl == "xla":
        np.testing.assert_array_equal(a, b)
    elif got.dtype == torch.bfloat16:
        np.testing.assert_allclose(b, a, rtol=8e-3, atol=1e-6)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("per_client_step", [False, True])
@pytest.mark.parametrize("has_lam", [True, False])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_leaves_step_and_running_sum_match_reference(impl, tree, has_lam, per_client_step, K):
    """K steps of ``fused_update_leaves`` with ``accs`` in the modes
    ``acc_mode_at`` gives ("only" at K = 1; "first", "add", "last" at
    K = 3) against K per-leaf reference steps, ``tree_add`` into zeros and
    ``tree_scale(1/K)``.  Even leaves take the server leaf without the
    client dim (broadcast), odd ones a full one."""
    m, leaves = TREES[tree]
    rng = np.random.default_rng(len(leaves) * 7 + K)
    draw = lambda s: rng.standard_normal((m,) + s).astype(np.float32)  # noqa: E731
    x = [_pair(draw(s), dt) for s, dt in leaves]
    srv = [_pair(np.asarray(draw(s)[0]) if i % 2 == 0 else draw(s), dt)
           for i, (s, dt) in enumerate(leaves)]
    lam = [_pair(0.1 * draw(s), dt) if has_lam else (None, None) for s, dt in leaves]
    step_np = np.linspace(0.01, 0.3, m).astype(np.float32)
    rho = 1.7
    xj, xsum = [a for a, _ in x], RT.tree_zeros_like([a for a, _ in x])
    accs = [torch.empty_like(t) for _, t in x]
    for k in range(K):
        g = [_pair(draw(s), dt) for s, dt in leaves]
        new = []
        for (s, _), xx, gg, ss, ll in zip(leaves, xj, g, srv, lam):
            lead = (m,) + (1,) * len(s)
            st = step_np.reshape(lead) if per_client_step else 0.13
            sj = ss[0] if ss[0].shape == xx.shape else jnp.broadcast_to(ss[0], xx.shape)
            new.append(R.fused_update(xx, gg[0], sj, ll[0], st, rho, impl=impl))
        xsum = RT.tree_add(xsum, new)
        # the port's step from the reference's iterate
        xt = [convert.tensor(a, "cpu") for a in xj]
        got = P.fused_update_leaves(
            xt, [t for _, t in g], [t for _, t in srv], [t for _, t in lam],
            torch.from_numpy(step_np) if per_client_step else 0.13, rho, accs=accs,
            acc_mode=P.acc_mode_at(k, K), acc_scale=1.0 / K)
        for want, out, (_, dt) in zip(new, got, leaves):
            assert out.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
            _same(want, out, impl)
        xj = new
    for want, acc in zip(RT.tree_scale(xsum, 1.0 / K), accs):
        _same(want, acc, impl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 3])
def test_arena_running_sum_matches_reference(K, dtype):
    """``fused_update_arena`` with ``acc`` over K steps: the step bitwise
    the reference's ``"xla"`` branch, the sum bitwise ``xsum + x`` from
    zeros and ``xsum * (1/K)`` (JAX's weak type in bf16)."""
    m, w = 3, 384
    rng = np.random.default_rng(K)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xj, xt = _pair(draw(m, w), dtype)
    sj, st = _pair(draw(w), dtype)
    lj, lt = _pair(draw(m, w), dtype)
    xsum, acc = jnp.zeros_like(xj), torch.empty_like(xt)
    for k in range(K):
        gj, gt = _pair(draw(m, w), dtype)
        xj = R.fused_update_arena(xj, gj, sj, lj, 0.2, 2.5, impl="xla")
        xsum = xsum + xj
        xt = P.fused_update_arena(xt, gt, st, lt, 0.2, 2.5, acc=acc,
                                  acc_mode=P.acc_mode_at(k, K), acc_scale=1.0 / K)
        _same(xj, xt, "xla")
    _same(xsum * (1.0 / K), acc, "xla")


def test_bf16_last_mode_takes_jax_weak_scale():
    """In bf16 the sum is rounded before the product, and 1/3 meets it as
    a bf16 scalar: bitwise ``(xsum + x) * (1/3)`` in JAX; the f32 1/3
    rounds otherwise in some of these elements."""
    a = np.linspace(-9.0, 9.0, 2 * 515, dtype=np.float32).reshape(2, 515)
    (sj, st), (xj, xt) = _pair(a, "bf16"), _pair(a[::-1].copy(), "bf16")
    acc = st.clone()
    ref.accumulate_ref(acc, xt, "last", 1.0 / 3)
    _same((sj + xj) * (1.0 / 3), acc, "xla")
    plain = ((st + xt).float() * (1.0 / 3)).to(torch.bfloat16)
    assert torch.sum(plain != acc) > 0


def test_first_mode_turns_negative_zero_positive():
    """0 + x' gives +0.0 for x' = -0.0, as the plain ``zeros + x`` does."""
    x = torch.tensor([[-0.0, 1.0, -2.0, 0.0]])
    acc = torch.full_like(x, 7.0)
    ref.accumulate_ref(acc, x, "first", 1.0)
    assert not torch.signbit(acc[0, 0]) and acc.tolist() == [[0.0, 1.0, -2.0, 0.0]]
    with pytest.raises(ValueError, match="acc_mode"):
        ref.accumulate_ref(acc, x, "sum", 1.0)


def test_acc_mode_at_covers_every_step():
    assert [P.acc_mode_at(k, 1) for k in range(1)] == ["only"]
    assert [P.acc_mode_at(k, 4) for k in range(4)] == ["first", "add", "add", "last"]
    assert [P.acc_mode_at(k, 2) for k in range(2)] == ["first", "last"]


# ---------------------------------------------------------------------------
# whole rounds on lm_tree's tree, and the softmax arena
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg", "fedsplit"])
def test_lm_tree_pytree_rounds_match_reference(algo):
    """Two rounds (K = 3, m = 2) on the reference benchmark's lm_tree
    (six f32 leaves, 1.77 M values a client) on the pytree path, the
    elementwise gradient of ``_torch_parity``, every state entry and
    metric compared."""
    run_trees(dict(algorithm=algo, eta=0.1, use_arena=False), "lm_tree", "f32", m=2,
              rounds=2)


@pytest.mark.parametrize("use_avg", [True, False])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_softmax_arena_rounds_match_reference(algo, K, use_avg):
    """Softmax regression on the arena (the ``grad_arena`` path, one
    ``fused_update_arena`` a step, x_bar's sum in its pass) against the
    reference for 3 rounds, each from the reference's state."""
    from repro.core import make as ref_make
    from repro.core.softmax import SoftmaxRegression as RefSoftmax
    from repro_torch.core.softmax import SoftmaxRegression

    F, C, m, B = 16, 4, 4, 8
    rng = np.random.default_rng(K)
    xs = rng.standard_normal((3, m, B, F)).astype(np.float32)
    ys = np.broadcast_to(np.arange(m, dtype=np.int32)[None, :, None], (3, m, B)).copy()
    rp, pp = RefSoftmax(F, C), SoftmaxRegression(F, C)
    rcfg, pcfg = configs(dict(algorithm=algo, inner_steps=K, eta=0.05, use_arena=True,
                              use_avg=use_avg))
    ro, po = ref_make(rcfg), make(pcfg)
    rs = ro.init(jnp.zeros(pp.dim, jnp.float32), m)
    for r in range(3):
        ps = convert.round_state(rs, "cpu")
        rs, rm = ro.round(rs, rp.oracle(), {"x": jnp.asarray(xs[r]), "y": jnp.asarray(ys[r])})
        ps, pm = po.round(ps, pp.oracle(), {"x": torch.from_numpy(xs[r]),
                                            "y": torch.from_numpy(ys[r])})
        compare(rs, rm, ps, pm, pcfg)


# ---------------------------------------------------------------------------
# no x_bar where nothing reads it
# ---------------------------------------------------------------------------

def _count_round(monkeypatch, cfg_kw, tree, arena, rounds=2, trace=False):
    """Kernel wrapper calls (the ``on_cpu`` hook, by name) and running-sum
    updates (``ref.accumulate_ref``) over ``rounds`` rounds of a small
    problem: the pytree path on ``tree`` shapes, or the arena with a
    ``grad_arena`` oracle."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make_oracle

    calls, sums = {}, []
    on_cpu = _args.on_cpu

    def counting(name, t):
        calls[name] = calls.get(name, 0) + 1
        return on_cpu(name, t)

    accumulate = ref.accumulate_ref
    monkeypatch.setattr(_args, "on_cpu", counting)
    monkeypatch.setattr(ref, "accumulate_ref",
                        lambda *a: (sums.append(a[2]), accumulate(*a))[1])
    m = 3
    params = {f"p{i}": torch.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s)
              for i, s in enumerate(tree)}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    opt = make(FederatedConfig(use_arena=arena, **cfg_kw))
    state = opt.init(params, m)
    for _ in range(rounds):
        extra = dict(return_trace=True) if trace else {}
        state, metrics = opt.round(state, grad, {"d": torch.zeros(m, 1)}, **extra)
    return calls, sums, (metrics["trace"] if trace else None)


ROUNDS_KW = {
    "gpdmm": dict(algorithm="gpdmm"),
    "gpdmm_last": dict(algorithm="gpdmm", use_avg=False),
    "agpdmm": dict(algorithm="agpdmm"),
    "scaffold": dict(algorithm="scaffold"),
    "fedavg": dict(algorithm="fedavg"),
}


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "pytree"])
@pytest.mark.parametrize("label", sorted(ROUNDS_KW))
def test_one_step_launch_a_round_step_and_x_bar_only_where_read(monkeypatch, label, arena):
    """K = 3 rounds of a three-leaf tree: one step kernel call per step
    (``fused_update_arena`` on the arena, ``fused_update`` for every leaf
    on the pytree path), and x_bar's running sum (3 updates a leaf and
    round, in the modes first, add, last) only for GPDMM with
    ``use_avg=True``: AGPDMM and GPDMM with ``use_avg=False`` ask for none,
    and SCAFFOLD and FedAvg keep none."""
    tree = [(5,), (2, 3), (4,)]
    calls, sums, _ = _count_round(monkeypatch, dict(ROUNDS_KW[label], inner_steps=3, eta=0.1),
                                  tree, arena)
    step = "fused_update_arena" if arena else "fused_update"
    assert calls[step] == 2 * 3
    assert "fused_update" not in calls if arena else "fused_update_arena" not in calls
    if label == "gpdmm":
        leaves = 1 if arena else len(tree)
        assert sums == (["first"] * leaves + ["add"] * leaves + ["last"] * leaves) * 2
    else:
        assert sums == []


def test_trace_keeps_x_bar_without_use_avg(monkeypatch):
    """``return_trace=True`` reports x_bar, so GPDMM with ``use_avg=False``
    keeps the running sum for a traced round: the trace's x_bar is the
    mean of the round's iterates."""
    calls, sums, trace = _count_round(
        monkeypatch, dict(algorithm="gpdmm", use_avg=False, inner_steps=2, eta=0.1),
        [(5,), (4,)], False, rounds=1, trace=True)
    assert sums == ["first", "first", "last", "last"]
    assert trace["x_bar"] is not None and calls["fused_update"] == 2
