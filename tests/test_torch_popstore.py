"""The host-resident population store of the port (``core.popstore``)
against the port's own device cohort round and against the reference's
``popstore.Runner``, on problems carried across by ``repro_torch.convert``
(tests/test_popstore.py's sizes: m = 8, n = 60, d = 24 and d = 130).

Tolerances, as tests/test_popstore.py states them: each array is scaled by
max(1, max |a|) and held to atol 1e-5.  Against the device cohort round the
popstore differs only in rounding: its server mean is the float64 running
sum read at f32 (the device round's is an f32 mean of the scattered cache),
and its dual rows are rebuilt from that mean (the lazy dual), so every
state entry moves by a few f32 roundings of the largest value.  Against
the reference's store, the same host arithmetic runs on rows that the two
bodies computed in other summation orders.

EF21 rounds against the reference start each round from the reference's
store (carried across before every round), as tests/test_torch_participation.py
does: the quantiser rounds to a grid, and a free-running comparison would
carry a rounding flip on.  None happens here; a flip fails the test.

The checkpoint round trips and the train launcher of tests/test_popstore.py
are mirrored in tests/test_torch_ckpt.py and tests/test_torch_train.py."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FaultConfig as RefFaultConfig
from repro.configs.base import FederatedConfig as RefConfig
from repro.core import popstore as ref_popstore
from repro.core import quadratic as ref_quadratic
from repro.core.api import use_popstore as ref_use_popstore
from repro_torch import convert, telemetry
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make, popstore, resolved_rho
from repro_torch.core import tree_util as T
from repro_torch.core.api import use_popstore
from repro_torch.core.gpdmm import participation_key

M = 8
R = 4


@pytest.fixture(scope="module", params=[24, 130], ids=["d24", "d130_odd"])
def lsq(request):
    # d=24 -> width 128; d=130 -> width 256 with 126 zero-padded columns
    ref = ref_quadratic.generate(jax.random.key(0), m=M, n=60, d=request.param)
    return ref, convert.least_squares(ref, "cpu")


def _kw(ref, algo, **kw):
    return dict(algorithm=algo, inner_steps=3, eta=0.3 / ref.L, use_arena=True,
                participation=0.5, cohort=True, **kw)


def _configs(kw):
    kw = dict(kw)
    fk = kw.pop("faults", None)
    rk, pk = dict(kw), dict(kw)
    if fk is not None:
        rk["faults"], pk["faults"] = RefFaultConfig(**fk), FaultConfig(**fk)
    return RefConfig(**rk), FederatedConfig(**pk)


def _close(a, b, *, msg, atol=1e-5):
    a = convert.to_numpy(a) if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = convert.to_numpy(b) if torch.is_tensor(b) else np.asarray(b, np.float32)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=msg)


def _carry(rs):
    """The reference's popstore state as the port's (host arrays copied)."""
    return {"x_s": convert.params(rs["x_s"], "cpu"), "round": int(rs["round"]),
            "pop": {k: np.array(v) for k, v in rs["pop"].items()},
            "pop_sum": np.array(rs["pop_sum"]), "pop_sum_comp": np.array(rs["pop_sum_comp"]),
            **({"c": convert.params(rs["c"], "cpu")} if "c" in rs else {})}


VARIANTS = [("gpdmm", {}), ("agpdmm", {}), ("scaffold", {}), ("fedavg", {}),
            ("gpdmm", {"uplink_bits": 8}), ("agpdmm", {"uplink_bits": 8}),
            ("fedavg", {"uplink_bits": 8}),
            ("gpdmm", {"faults": dict(dropout=0.1, seed=3), "screen": True})]
IDS = ["gpdmm-plain", "agpdmm-plain", "scaffold-plain", "fedavg-plain", "gpdmm-ef21",
       "agpdmm-ef21", "fedavg-ef21", "gpdmm-faults"]


@pytest.mark.parametrize("algo,extra", VARIANTS, ids=IDS)
def test_popstore_matches_device_cohort_and_reference(lsq, algo, extra):
    """R rounds of the port's store against the port's device cohort round
    from the same start (x_s, every store buffer against the device arena,
    GPDMM's lazy dual against lam_s) and against the reference's store
    (x_s, every buffer, the running sum and every metric)."""
    ref, prob = lsq
    rcfg, pcfg = _configs(_kw(ref, algo, **extra))
    x0 = torch.zeros(prob.d)
    opt = make(pcfg)
    dev = opt.init(x0, prob.m)
    runner = popstore.Runner(pcfg, prob.oracle(), device="cpu")
    pop = runner.init(x0, prob.m)
    rrun = ref_popstore.Runner(rcfg, ref.oracle())
    rs = rrun.init(jnp.zeros(ref.d), ref.m)
    rho = resolved_rho(pcfg)
    ef21 = "uplink_bits" in extra
    for r in range(R):
        tag = f"{algo} {extra} round {r}"
        dev, _ = opt.round(dev, prob.oracle(), prob.batch())
        pop, met = runner.round(pop, prob.batch())
        _close(runner.server_params(pop), dev["x_s"], msg=f"{tag}: x_s vs device")
        for name in popstore.POP_BUFFERS[algo]:
            _close(pop["pop"][name], dev[name], msg=f"{tag}: {name} vs device")
        if algo == "gpdmm":
            # no (m, width) dual exists in the store; rho (u_hat - x_s)
            # rebuilds the device round's lam_s rows
            x_row = convert.to_numpy(runner._spec.pack(runner.server_params(pop)))
            _close(rho * (pop["pop"]["u_hat"] - x_row[None]), dev["lam_s"],
                   msg=f"{tag}: lazy dual vs lam_s")
        assert float(met["used_popstore"]) == 1.0
        # the reference's store, from its own state (EF21: carried across)
        if ef21:
            pop_r = _carry(rs)
            ps, pm = popstore.Runner(pcfg, prob.oracle(), device="cpu").round(
                pop_r, prob.batch())
        else:
            ps, pm = pop, met
        rs, rm = rrun.round(rs, ref.batch())
        _close(ps["x_s"], rs["x_s"], msg=f"{tag}: x_s vs reference")
        for name in popstore.POP_BUFFERS[algo]:
            _close(ps["pop"][name], rs["pop"][name], msg=f"{tag}: {name} vs reference")
        _close(ps["pop_sum"], rs["pop_sum"], msg=f"{tag}: pop_sum vs reference")
        if "c" in rs:
            _close(ps["c"], rs["c"], msg=f"{tag}: c vs reference")
        assert sorted(pm) == sorted(rm)
        for k in rm:
            if k.startswith("faults_"):
                assert float(pm[k]) == float(rm[k]), (tag, k)
            elif k.endswith("_sum_norm"):
                # norms of sums that are zero in exact arithmetic: the
                # rounding scale of m x_s (tests/_torch_parity.py's atol)
                np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5,
                                           atol=1e-5 * rho * M, err_msg=f"{tag}: {k}")
            else:
                np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{tag}: {k}")


def test_scaffold_ef21_is_refused(lsq):
    """SCAFFOLD's two-variable uplink has no EF21 (``scaffold.make``'s
    message), in the store as on the device."""
    ref, prob = lsq
    with pytest.raises(NotImplementedError, match="SCAFFOLD\\+EF21"):
        popstore.Runner(FederatedConfig(**_kw(ref, "scaffold", uplink_bits=8)),
                        prob.oracle(), device="cpu")


def test_popstore_metrics_expose_kkt_invariant(lsq):
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, "gpdmm"))
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    for _ in range(3):
        s, met = runner.round(s, prob.batch())
    # eq. (25): sum_i lam_{s|i} = rho (sum_i u_hat_i - m x_s), off the f64
    # running sum; it matches a dense recomputation over the store
    dense = resolved_rho(cfg) * np.linalg.norm(
        popstore._col_sum64(s["pop"]["u_hat"])
        - prob.m * convert.to_numpy(runner._spec.pack(s["x_s"])).astype(np.float64))
    np.testing.assert_allclose(float(met["lam_sum_norm"]), dense, rtol=1e-5)


def test_popstore_requires_cohort_engine(lsq):
    _, prob = lsq
    runner = popstore.Runner(FederatedConfig(algorithm="gpdmm", participation=1.0),
                             prob.oracle(), device="cpu")
    with pytest.raises(ValueError, match="cohort"):
        runner.init(torch.zeros(prob.d), prob.m)
    with pytest.raises(ValueError, match="popstore supports"):
        popstore.Runner(FederatedConfig(algorithm="fedsplit"), prob.oracle(), device="cpu")


def _bf16_words(a) -> np.ndarray:
    """A bf16 store buffer's 16-bit words: the port's CPU tensor or the
    reference's ``ml_dtypes`` array."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_bf16_arena_matches_reference_runner(lsq):
    """A bf16 arena: the store keeps the rows as 16-bit words (numpy has no
    bfloat16) and runs as the reference's bf16 store does, 3 GPDMM rounds
    at participation 0.5 from a bf16 server row.  The store's
    words are bitwise the reference's where the bodies round alike; they are
    held to one bf16 rounding (2^-8 of max |a|) since the two bodies sum in
    other orders, the f64 running sums to the f32 rounding of that scale."""
    ref, prob = lsq
    rcfg, pcfg = _configs(_kw(ref, "gpdmm"))
    runner = popstore.Runner(pcfg, prob.oracle(), device="cpu")
    pop = runner.init(torch.zeros(prob.d, dtype=torch.bfloat16), prob.m)
    rrun = ref_popstore.Runner(rcfg, ref.oracle())
    rs = rrun.init(jnp.zeros(ref.d, jnp.bfloat16), ref.m)
    assert pop["pop"]["u_hat"].dtype == torch.bfloat16
    for r in range(3):
        pop, met = runner.round(pop, prob.batch())
        rs, rm = rrun.round(rs, ref.batch())
        assert runner.server_params(pop).dtype == torch.bfloat16
        for name in popstore.POP_BUFFERS["gpdmm"]:
            a = popstore._wide(_bf16_words(pop["pop"][name]))
            b = popstore._wide(_bf16_words(rs["pop"][name]))
            _close(a, b, atol=2.0 ** -8, msg=f"round {r}: {name}")
        _close(pop["x_s"].float(), np.asarray(rs["x_s"], np.float32), atol=2.0 ** -8,
               msg=f"round {r}: x_s")
        _close(pop["pop_sum"], rs["pop_sum"], atol=2.0 ** -8, msg=f"round {r}: pop_sum")
        assert sorted(met) == sorted(rm)


def test_runner_defaults_to_the_card():
    """The store's body runs on the card unless the caller asks for the
    CPU; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        popstore.Runner(FederatedConfig(participation=0.5), lambda p, b: p)


@pytest.mark.parametrize("m", [8, 100, 10 ** 6])
@pytest.mark.parametrize("kw", [
    dict(participation=0.5, popstore=True),
    dict(participation=0.5, popstore="auto", popstore_min_clients=100),
    dict(participation=0.5, popstore=False),
    dict(participation=1.0, popstore=True),
    dict(participation=0.5, popstore=True, algorithm="fedsplit"),
    dict(participation=0.5, popstore=True, async_rounds=True),
    dict(participation=0.5, popstore="auto"),
], ids=["on", "auto100", "off", "full", "fedsplit", "async", "auto"])
def test_use_popstore_policy_matches_reference(kw, m):
    """The policy word for word: on, auto (at and below its threshold),
    off, full participation (no cohort engine), an algorithm without a
    cohort round, async rounds."""
    assert use_popstore(FederatedConfig(**kw), m) == ref_use_popstore(RefConfig(**kw), m)


def test_use_popstore_policy():
    on = FederatedConfig(participation=0.5, popstore=True)
    auto = FederatedConfig(participation=0.5, popstore="auto", popstore_min_clients=100)
    off = FederatedConfig(participation=0.5, popstore=False)
    full = FederatedConfig(participation=1.0, popstore=True)
    assert use_popstore(on, 8)
    assert not use_popstore(auto, 8) and use_popstore(auto, 100)
    assert not use_popstore(off, 10 ** 6)
    assert not use_popstore(full, 10 ** 6)  # rides the cohort engine


# ---------------------------------------------------------------------------
# prefetch ring + incremental sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["gpdmm", "scaffold"])
def test_prefetch_ring_matches_restage(lsq, algo):
    """The overlapped next-round gather (with the intersect1d reconcile of
    rows the current round scattered) is a pure scheduling choice: bitwise
    the same as throwing the prefetch away and restaging."""
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, algo))
    ra = popstore.Runner(cfg, prob.oracle(), device="cpu")
    rb = popstore.Runner(cfg, prob.oracle(), device="cpu")
    sa = ra.init(torch.zeros(prob.d), prob.m)
    sb = rb.init(torch.zeros(prob.d), prob.m)
    for r in range(5):
        sa, _ = ra.round(sa, prob.batch())
        rb._next = None  # kill the ring: force a from-scratch restage
        sb, _ = rb.round(sb, prob.batch())
        for name in popstore.POP_BUFFERS[algo]:
            np.testing.assert_array_equal(sa["pop"][name], sb["pop"][name],
                                          err_msg=f"prefetch vs restage: {name} round {r}")
        assert torch.equal(ra.server_params(sa), rb.server_params(sb)), r
    assert (ra.ring_hits, ra.ring_misses) == (4, 1)
    assert (rb.ring_hits, rb.ring_misses) == (0, 5)


def test_prefetch_overlaps_consecutive_cohorts():
    """The reconcile actually fires: consecutive draws at p = 0.5 on m = 8
    overlap within a few rounds (seeded, so deterministic)."""
    cfg = FederatedConfig(participation=0.5)
    overlaps = 0
    for r in range(5):
        a, _ = T.cohort_indices(participation_key(cfg, r), M, 0.5)
        b, _ = T.cohort_indices(participation_key(cfg, r + 1), M, 0.5)
        overlaps += np.intersect1d(a.numpy(), b.numpy()).size
    assert overlaps > 0


def test_runner_draws_the_device_rounds_cohort(lsq):
    """The store's host ids are the device cohort round's for the same seed
    and round (the draw with a host round number equals the draw folded
    from the round counter tensor)."""
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, "gpdmm", seed=5))
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    for r in range(4):
        staged = runner._take_prefetch(r, s["pop"]) or runner._stage_host(r, s["pop"])
        want, _ = T.cohort_indices(participation_key(cfg, torch.tensor(r, dtype=torch.int32)),
                                   prob.m, cfg.participation)
        np.testing.assert_array_equal(staged.idx_np, want.numpy())
        runner._next = staged
        s, _ = runner.round(s, prob.batch())


def test_incremental_sum_tracks_dense(lsq):
    """The Kahan-compensated running sum equals a dense chunked f64 column
    sum of the store after many rounds, and x_s is that sum read at f32."""
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, "gpdmm"))
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    for _ in range(8):
        s, _ = runner.round(s, prob.batch())
    dense = popstore._col_sum64(s["pop"]["u_hat"])
    scale = max(1.0, float(np.abs(dense).max()))
    np.testing.assert_allclose(s["pop_sum"] / scale, dense / scale, atol=1e-10,
                               err_msg="incremental vs dense sum")
    x_row = convert.to_numpy(runner._spec.pack(s["x_s"])).astype(np.float64)
    np.testing.assert_allclose(x_row, (dense / prob.m).astype(np.float32).astype(np.float64),
                               rtol=0, atol=0, err_msg="x_s vs dense mean at f32")


@pytest.mark.parametrize("how", ["read_only", "f32_sums", "tensors"])
def test_normalize_repairs_a_handed_back_state(lsq, how):
    """A state handed back read-only, with f32 running sums or with tensor
    buffers continues exactly as the original: the store becomes writable
    numpy, the sums exact f64 (recomputed densely), and any prefetch staged
    off the old arrays is dropped."""
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, "gpdmm"))
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    for _ in range(2):
        s, _ = runner.round(s, prob.batch())
    back = {"x_s": s["x_s"].clone(), "round": s["round"],
            "pop": {k: v.copy() for k, v in s["pop"].items()},
            "pop_sum": s["pop_sum"].copy(), "pop_sum_comp": s["pop_sum_comp"].copy()}
    if how == "read_only":
        for v in back["pop"].values():
            v.flags.writeable = False
    elif how == "f32_sums":
        back["pop_sum"] = back["pop_sum"].astype(np.float32)
        back["pop_sum_comp"] = back["pop_sum_comp"].astype(np.float32)
    else:
        back["pop"] = {k: torch.from_numpy(v) for k, v in back["pop"].items()}
    r2 = popstore.Runner(cfg, prob.oracle(), device="cpu")
    for _ in range(2):
        s, _ = runner.round(s, prob.batch())
        back, _ = r2.round(back, prob.batch())
    for name in popstore.POP_BUFFERS["gpdmm"]:
        assert isinstance(back["pop"][name], np.ndarray) and back["pop"][name].flags.writeable
        np.testing.assert_array_equal(back["pop"][name], s["pop"][name], err_msg=name)
    assert back["pop_sum"].dtype == np.float64
    scale = max(1.0, float(np.abs(s["pop_sum"]).max()))
    np.testing.assert_allclose(back["pop_sum"] / scale, s["pop_sum"] / scale, atol=1e-12)
    _close(back["x_s"], s["x_s"], msg="x_s after the repair")


def test_device_bytes_counts_the_ring():
    cfg = FederatedConfig(participation=64 / 10 ** 6)
    assert popstore.device_bytes(cfg, 1024, 10 ** 6) == 2 * 2 * 64 * 1024 * 4
    assert popstore.device_bytes(FederatedConfig(algorithm="agpdmm", participation=0.5),
                                 128, 8) == 2 * 1 * 4 * 128 * 4


def test_popstore_round_emits_its_spans_and_ring_counter(lsq, tmp_path):
    """With the global tracer on, a popstore round writes every
    ``popstore/*`` span and the ring counter into a trace that loads back;
    the tracer is left off afterwards."""
    ref, prob = lsq
    cfg = FederatedConfig(**_kw(ref, "gpdmm"))
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    path = tmp_path / "trace.json"
    telemetry.configure(enabled=True, trace_out=path)
    try:
        for _ in range(2):
            s, _ = runner.round(s, prob.batch())
    finally:
        telemetry.close()
        telemetry.configure(enabled=False)
    events = telemetry.load_trace(path)
    names = {e["name"] for e in events}
    for want in ("popstore/host_gather", "popstore/h2d_stage", "popstore/prefetch_draw",
                 "popstore/device_round", "popstore/prefetch_gather", "popstore/device_sync",
                 "popstore/scatter_back", "popstore/ring"):
        assert want in names, want
    ring = [e for e in events if e["name"] == "popstore/ring"]
    assert ring[-1]["ph"] == "C" and ring[-1]["args"] == {"hit": 1, "miss": 1}
    assert json.loads(path.read_text())  # closed: a plain JSON array
    assert not telemetry.enabled()
