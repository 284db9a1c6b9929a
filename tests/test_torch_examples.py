"""The port's examples (``examples/torch_*.py``) run on the CPU at a small
size (fewer rounds than the scripts' defaults, enough for their checks),
with their own checks: each draws the reference's problem
(``generate_from_key(prng.key(0), ...)`` is ``generate(jax.random.key(0),
...)``) and keeps the reference script's printed checks and asserts."""
import importlib.util
import math
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs six workers on a
    few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_converges(capsys):
    dist = _load("torch_quickstart").main(["--device", "cpu", "--rounds", "60"])
    assert dist < 1e-3
    assert "converged" in capsys.readouterr().out


def test_fedsplit_vs_pdmm_story():
    """Exact PDMM and exact FedSplit take the same trajectory; every gap is
    finite (at 20 rounds, a cut of the script's 300)."""
    out = _load("torch_fedsplit_vs_pdmm").main(["--device", "cpu", "--rounds", "20"])
    assert out["exact_diff"] < 1e-3
    assert all(math.isfinite(v) for v in out.values())


@pytest.mark.parametrize("algo,bits", [("gpdmm", 4), ("agpdmm", 8)])
def test_quantized_uplink_preserves_convergence(algo, bits, capsys):
    d_exact, d_quant = _load("torch_quantized_uplink").main(
        ["--device", "cpu", "--algo", algo, "--bits", str(bits), "--rounds", "60"])
    assert d_quant < 50 * d_exact + 1e-3
    assert "preserves convergence" in capsys.readouterr().out


def test_ring_pdmm_every_node_converges():
    assert _load("torch_ring_pdmm").main(["--device", "cpu", "--rounds", "100"]) < 1e-2


def test_train_federated_lm_runs_tiny():
    res = _load("torch_train_federated_lm").main(
        ["--device", "cpu", "--preset", "tiny", "--algos", "gpdmm,fedavg"])
    assert sorted(res) == ["fedavg", "gpdmm"]
    assert all(math.isfinite(loss) for c in res.values() for _, loss in c)
