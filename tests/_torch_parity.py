"""Round-by-round comparison of the port with the reference, shared by
tests/test_torch_faults.py, tests/test_torch_staleness.py,
tests/test_torch_topology.py and tests/test_torch_autotune.py, and (the
bf16, mixed-dtype and nested trees below) by tests/test_torch_round.py,
test_torch_baselines.py and test_torch_participation.py.

Tolerances, as tests/test_torch_participation.py states them: rtol = atol =
1e-5 on x-level values (the matvec and the client mean sum in another order
on each side); duals (graph-PDMM's edge duals ``z`` among them) get atol
1e-5 * rho, SCAFFOLD's control variates atol 1e-5 / (K eta).
graph-PDMM's ``consensus_err`` gets rtol 1e-3: a sum of squared
differences of nearly equal node rows, which amplifies the rows' rounding.  Integer entries (the round counter, the stale slots' age
and lateness) and the fault and stale counters are compared exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make, resolved_rho
from repro_torch.core import tree_util as T

EXACT = ("round", "stale_age", "stale_lat", "faults_injected", "faults_demoted",
         "stale_buffered", "stale_admitted", "stale_dropped")


def configs(kw):
    """(reference config, port config) from one keyword dict whose
    ``faults`` entry, if any, is a dict of FaultConfig fields."""
    kw = dict(kw)
    fk = kw.pop("faults", None)
    ref_kw, port_kw = dict(kw), dict(kw)
    if fk is not None:
        ref_kw["faults"], port_kw["faults"] = RefFaultConfig(**fk), FaultConfig(**fk)
    return RefConfig(**ref_kw), FederatedConfig(**port_kw)


def tolerance(key, cfg):
    """The rtol/atol of state entry or metric ``key`` under ``cfg``."""
    eta = np.mean(cfg.eta) if isinstance(cfg.eta, tuple) else cfg.eta
    rho, alpha = resolved_rho(cfg), 1.0 / (cfg.inner_steps * eta)
    if key in ("lam_s", "lam_sum_norm", "z"):
        return dict(rtol=1e-5, atol=1e-5 * rho)
    if key == "consensus_err":
        return dict(rtol=1e-3, atol=0.0)
    if key in ("c", "c_i", "c_sum_norm"):
        return dict(rtol=1e-5, atol=1e-5 * alpha)
    return dict(rtol=1e-5, atol=1e-5)


def compare(rs, rm, ps, pm, cfg, *, scale=1.0, of_max=False):
    """Every state entry and every metric of one round.  ``scale``
    multiplies each tolerance; ``of_max`` takes each array's atol relative
    to its largest magnitude (a state that has grown large rounds at its
    own scale, so f32 cancellation errs relative to the largest value, not
    to the element)."""

    def close(got, want, k, msg):
        tol = {n: v * scale for n, v in tolerance(k, cfg).items()}
        want = np.asarray(want)
        if of_max and want.size:
            tol["atol"] = max(tol["atol"], tol["rtol"] * float(np.nanmax(np.abs(want))))
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)

    assert sorted(ps) == sorted(rs)
    for k in rs:
        want = rs[k]
        got = convert.to_numpy(ps[k]) if k != "round" else int(ps[k])
        if k in EXACT:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=k)
            if k in ("stale_age", "stale_lat"):
                assert ps[k].dtype == torch.int32, (k, ps[k].dtype)
            continue
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for leaf in want:
                close(got[leaf], want[leaf], k, f"{k}[{leaf}]")
        else:
            close(got, want, k, k)
    assert sorted(pm) == sorted(rm)
    for k in rm:
        if k in EXACT:
            assert float(pm[k]) == float(rm[k]), k
        else:
            close(float(pm[k]), float(rm[k]), k, k)


def run_both(kw, ref_prob, prob, rounds, *, oracle=None):
    """``rounds`` rounds of the reference and the port on one least-squares
    problem from the zero init, compared after each.  ``oracle`` picks the
    fused affine oracle (default: on the arena) or the plain grad."""
    rcfg, pcfg = configs(kw)
    if oracle is None:
        oracle = kw.get("use_arena") is True
    rgrad, pgrad = ((ref_prob.oracle(), prob.oracle()) if oracle
                    else (ref_prob.grad, prob.grad))
    ro, po = ref_make(rcfg), make(pcfg)
    rs = ro.init(jnp.zeros(ref_prob.d, jnp.float32), ref_prob.m)
    ps = po.init(torch.zeros(prob.d), prob.m)
    rows = []
    for _ in range(rounds):
        rs, rm = ro.round(rs, rgrad, ref_prob.batch())
        ps, pm = po.round(ps, pgrad, prob.batch())
        compare(rs, rm, ps, pm, pcfg)
        rows.append(pm)
    return rs, ps, rows


# ---------------------------------------------------------------------------
# bf16, mixed-dtype and nested parameter trees (tests/test_torch_round.py,
# test_torch_baselines.py, test_torch_participation.py)
# ---------------------------------------------------------------------------
#
# The gradient is elementwise, a (x - t) with per-client a >= 0 and t, taken
# in f32 whatever the leaf's dtype (bf16 parameters, f32 gradients), so both
# sides compute it with the same f32 ops.  The trees:
#   flat    {"a": (7,), "b": (3, 5)}
#   nested  a dict inside a dict, a list of leaves and an empty dict
#   lm_tree the reference benchmark's six leaves (1.77 M values a client)
# In "f32" and "bf16" every leaf has that dtype; in "mixed" the first leaf of
# each group is bf16 and the second f32 (mixed-dtype trees take the pytree
# path on both sides).
#
# Comparison.  The reference runs the K client steps inside ``lax.scan``,
# and XLA's CPU compiler contracts and reorders the f32 arithmetic of a
# fused loop body (``ops.fused_update_arena`` under ``jax.jit`` differs from
# its eager self in 7,563 of 24,576 f32 elements, and in 1 of 24,576 once
# rounded to bf16); the port runs each op on its own.  So a bf16 leaf agrees
# bitwise except for rare elements where that f32 difference lands on a
# rounding boundary, and a flip in x_K moves that column of the round's
# mean and every client's dual with it: at most ``FLIP_FRAC`` (2%) of the
# bf16 elements of the round's state (at least one) may differ, each by at most
# ``BF16_ULPS`` (4) ulps of bf16 (2^-8 relative) of its leaf's largest
# magnitude.  The weak-type defect this pins moved most elements (6 of 7 in
# the first round's x_s).  An f32 leaf gets ``tolerance``.  Each metric is an
# f32 reduction over bf16 values, x_K among them, which not every state
# holds: with bf16 leaves it gets ``tolerance`` widened from 1e-5 to
# ``BF16_ULPS`` ulps of bf16.  Measured: 52 of the 60 bf16, mixed and nested
# round cases agree bitwise in all four rounds; the arena SVRG rounds, whose
# scan also sums the bf16 gradient corrections, flip the most (68-80 elements
# over four rounds, under 2% in each).

BF16_ULPS, FLIP_FRAC = 4, 0.02

TREES = {
    "flat": lambda d1, d2: {"a": ((7,), d1), "b": ((3, 5), d2)},
    "nested": lambda d1, d2: {"enc": {"w": ((3, 5), d1), "b": ((4,), d2)},
                              "lst": [((6,), d1), ((2, 3), d2)], "empty": {},
                              "top": ((7,), d1)},
    # the reference benchmark's lm_tree (benchmarks/round_bench.py:62-72)
    "lm_tree": lambda d1, d2: {"embed": ((512, 384), d1), "blk0_w1": ((768, 512), d1),
                               "blk0_w2": ((512, 768), d1), "blk1_w1": ((768, 512), d1),
                               "blk1_w2": ((512, 768), d1), "bias": ((768,), d1)},
}
DTYPES = {"f32": ("f32", "f32"), "bf16": ("bf16", "bf16"), "mixed": ("bf16", "f32")}


def _is_shape(t):
    return isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], tuple)


def tree_data(rng, kind, dtype, lead=()):
    """A numpy tree of ``kind`` with leaves of shape ``lead + shape``, bf16
    leaves as ``ml_dtypes.bfloat16`` (exactly the values JAX holds)."""
    def leaf(sd):
        shape, dt = sd
        a = rng.standard_normal(lead + shape).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) if dt == "bf16" else a

    return jax.tree.map(leaf, TREES[kind](*DTYPES[dtype]), is_leaf=_is_shape)


def ref_grad(x, b):
    f32 = jnp.float32
    return jax.tree.map(lambda xx, a, t: a.astype(f32) * (xx.astype(f32) - t.astype(f32)),
                        x, b["a"], b["t"])


def port_grad(x, b):
    f32 = torch.float32
    return T.tmap(lambda xx, a, t: a.to(f32) * (xx.to(f32) - t.to(f32)), x, b["a"], b["t"])


def compare_trees(rs, rm, ps, pm, cfg):
    """Every state entry, leaf by leaf in flattening order, and every
    metric of one round (see the comment above)."""
    assert sorted(ps) == sorted(rs)
    flips = n_bf16 = 0
    for k in rs:
        if k in EXACT:
            np.testing.assert_array_equal(np.asarray(ps[k]), np.asarray(rs[k]), err_msg=k)
            continue
        assert jax.tree.structure(rs[k]) == jax.tree.structure(convert.to_numpy(ps[k])), k
        for path, want, got in zip(T.paths(ps[k]), jax.tree.leaves(rs[k]), T.leaves(ps[k])):
            msg = f"{k}{path}"
            if got.dtype == torch.bfloat16:
                assert np.asarray(want).dtype.name == "bfloat16", msg
                w = np.asarray(want).astype(np.float32)
                g = convert.to_numpy(got)
                flips += int(np.sum(g != w))
                n_bf16 += w.size
                atol = BF16_ULPS * 2.0 ** -8 * float(np.max(np.abs(w), initial=0.0))
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=msg)
            else:
                np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                                           err_msg=msg, **tolerance(k, cfg))
    assert flips <= max(1.0, FLIP_FRAC * n_bf16), f"{flips} of {n_bf16} bf16 elements differ"
    assert sorted(pm) == sorted(rm)
    for k in rm:
        tol = tolerance(k, cfg)
        if n_bf16:
            tol = {n: v * BF16_ULPS * 2.0 ** -8 / 1e-5 for n, v in tol.items()}
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), err_msg=k, **tol)


def run_trees(kw, kind, dtype, *, m=6, K=3, rounds=4, per_step=False, seed=0):
    """``rounds`` rounds of the reference and the port from one numpy tree
    of ``kind``/``dtype``, with ``ref_grad``/``port_grad`` on per-round
    batches {a, t} of the same tree (client dim m, or (K, m) per step),
    compared after each (``compare_trees``).  The first round runs from each side's own
    init, every later one from the reference's state carried across.
    Returns both final states."""
    rng = np.random.default_rng(seed)
    p0 = tree_data(rng, kind, dtype)
    lead = (rounds, K, m) if per_step else (rounds, m)
    a = jax.tree.map(np.abs, tree_data(rng, kind, dtype, lead))
    t = tree_data(rng, kind, dtype, lead)
    rcfg, pcfg = configs(dict(kw, inner_steps=K))
    ro, po = ref_make(rcfg), make(pcfg)
    rs = ro.init(jax.tree.map(jnp.asarray, p0), m)
    ps = po.init(convert.params(p0, "cpu"), m)
    for r in range(rounds):
        if r:
            # each round from the reference's state, so one round's rare
            # flips (above) do not carry into the next
            ps = convert.round_state(rs, "cpu")
        b = {"a": jax.tree.map(lambda x: x[r], a), "t": jax.tree.map(lambda x: x[r], t)}
        rs, rm = ro.round(rs, ref_grad, jax.tree.map(jnp.asarray, b), per_step)
        ps, pm = po.round(ps, port_grad, convert.params(b, "cpu"), per_step)
        compare_trees(rs, rm, ps, pm, pcfg)
    return rs, ps
