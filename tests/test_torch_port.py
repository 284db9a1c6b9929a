"""The port as a package: it imports neither JAX nor the reference (the
modules of every slice, autotune and graph-PDMM included), it rejects the
branches it does not run yet (the host-resident population store) and
those the reference rejects (EF21 and variance reduction over a graph), it
runs the fault, topology and early-exit branches, its configuration copy
matches the reference's, its per-leaf pytree path runs, and its quickstart
converges on the CPU."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro_torch.configs import base as port_base
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make, quadratic

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        "repro_torch" + "".join("." + p for p in f.relative_to(PKG).with_suffix("").parts)
        .replace(".__init__", "")
        for f in PKG.rglob("*.py"))


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    mods = _modules()
    for name in ("repro_torch.core.autotune", "repro_torch.core.topology",
                 "repro_torch.core.pdmm_graph", "repro_torch.kernels.residual",
                 "repro_torch.kernels.neighbor_reduce"):
        assert name in mods, name
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_config_copy_matches_reference_fields_and_defaults():
    for ref_cls, port_cls in [(ref_base.FederatedConfig, port_base.FederatedConfig),
                              (ref_base.FaultConfig, port_base.FaultConfig)]:
        ref_f = [(f.name, f.default) for f in dataclasses.fields(ref_cls)]
        port_f = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
        assert port_f == ref_f
    assert FaultConfig.parse("dropout=0.1,seed=7") == FaultConfig(dropout=0.1, seed=7)
    with pytest.raises(ValueError, match="cohort_tile"):
        FederatedConfig(num_clients=100, participation=0.07, cohort_tile=3)
    FederatedConfig(num_clients=100, participation=0.07, cohort_tile=7)  # 7 clients


@pytest.mark.parametrize("kw", [
    dict(algorithm="gpdmm", topology="ring", uplink_bits=8),
    dict(algorithm="pdmm_graph", uplink_bits=8),
    dict(algorithm="gpdmm_graph", variance_reduction="svrg"),
])
def test_unported_branches_raise(kw):
    """EF21 and variance reduction over a graph are refused with the
    reference's own messages (plain ``gpdmm`` on a ring routes to
    graph-PDMM and meets the same refusal).  Graph algorithms, other
    topologies and ``tol > 0`` (refused here before they were ported) now
    build: ``test_ported_branches_build``."""
    with pytest.raises(NotImplementedError, match="EF21|variance reduction"):
        make(FederatedConfig(**{"use_arena": True, **kw}))


@pytest.mark.parametrize("kw, name", [
    (dict(algorithm="pdmm_graph"), "pdmm_graph"), (dict(topology="ring"), "gpdmm_graph"),
    (dict(algorithm="gpdmm_graph", topology="torus"), "gpdmm_graph"),
    (dict(tol=1e-6), "gpdmm"),
])
def test_ported_branches_build(kw, name):
    assert make(FederatedConfig(**{"use_arena": True, **kw})).name == name


@pytest.mark.parametrize("kw", [
    dict(faults=FaultConfig(dropout=0.1), participation=0.5),
    dict(faults=FaultConfig(dropout=0.1)), dict(screen=True),
    dict(async_rounds=True, faults=FaultConfig(delay=0.3)),
])
def test_fault_branches_build_and_run_a_round(kw):
    """Faults, screening and async rounds (once refused) build and run one
    round on the CPU; their parity with the reference is in
    tests/test_torch_faults.py and tests/test_torch_staleness.py."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=4, n=32, d=16, device="cpu")
    opt = make(FederatedConfig(**{"use_arena": True, "inner_steps": 2, "eta": 0.5 / prob.L,
                                  **kw}))
    state, metrics = opt.round(opt.init(torch.zeros(prob.d), prob.m), prob.oracle(),
                               prob.batch())
    assert int(state["round"]) == 1
    assert bool(torch.isfinite(state["x_s"]).all())
    assert "faults_demoted" in metrics


def test_scaffold_partial_participation_raises():
    """SCAFFOLD runs partial participation, but with EF21 it is refused with
    the reference's own message, participating or not."""
    with pytest.raises(NotImplementedError, match="SCAFFOLD\\+EF21"):
        make(FederatedConfig(algorithm="scaffold", participation=0.5, uplink_bits=8))


@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_pytree_path_runs_rounds(algo):
    """W = 128 under the default use_arena="auto" selects the reference's
    per-leaf pytree path: the state stays a stacked tree (no arena) and
    ||x - x*|| falls over 20 rounds of plain grad."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=4, n=96, d=64,
                              device="cpu")
    opt = make(FederatedConfig(algorithm=algo, inner_steps=3, eta=0.5 / prob.L))
    state = opt.init(torch.zeros(prob.d), prob.m)
    assert tuple(state["lam_s"].shape) == (prob.m, prob.d)  # not padded to 128
    d0 = float(prob.dist(state["x_s"]))
    for _ in range(20):
        state, metrics = opt.round(state, prob.grad, prob.batch())
    assert float(metrics["used_arena"]) == 0.0
    assert float(prob.dist(opt.server_params(state))) < 0.1 * d0


def test_eta_auto_is_rejected():
    with pytest.raises(ValueError, match="auto"):
        make(FederatedConfig(eta="auto"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quadratic.generate(torch.Generator().manual_seed(0), m=2, n=4, d=3)


def test_quickstart_converges_on_cpu():
    """The port of examples/quickstart.py on the fused affine path
    (``use_arena=True``, ``oracle()``): ||x - x*|| < 1e-3 in 100 rounds."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=400, d=64,
                              device="cpu")
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=5, eta=0.5 / prob.L,
                          use_arena=True)
    opt = make(cfg)
    state = opt.init(torch.zeros(prob.d), prob.m)
    grad, batch = prob.oracle(), prob.batch()
    for _ in range(100):
        state, metrics = opt.round(state, grad, batch)
    dist = float(prob.dist(opt.server_params(state)))
    assert dist < 1e-3, dist
    assert np.isfinite(float(metrics["lam_sum_norm"]))
