"""Round-by-round comparison of the port with the reference, shared by
tests/test_torch_faults.py, tests/test_torch_staleness.py,
tests/test_torch_topology.py and tests/test_torch_autotune.py.

Tolerances, as tests/test_torch_participation.py states them: rtol = atol =
1e-5 on x-level values (the matvec and the client mean sum in another order
on each side); duals (graph-PDMM's edge duals ``z`` among them) get atol
1e-5 * rho, SCAFFOLD's control variates atol 1e-5 / (K eta).
graph-PDMM's ``consensus_err`` gets rtol 1e-3: a sum of squared
differences of nearly equal node rows, which amplifies the rows' rounding.  Integer entries (the round counter, the stale slots' age
and lateness) and the fault and stale counters are compared exactly.
"""
import numpy as np
import jax.numpy as jnp
import torch

from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import FederatedConfig as RefConfig
from repro.core import make as ref_make
from repro_torch import convert
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make, resolved_rho

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
