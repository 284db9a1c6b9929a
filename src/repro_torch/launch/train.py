"""Federated LM training launcher, the port of ``src/repro/launch/train.py``
(every flag of it), on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch olmo-1b --reduced --steps 50 --algorithm gpdmm --k 4 --device cpu

Each round takes every client's gradient as ``vmap(grad(loss))``; on the
card the attention and RWKV-6 recurrence run as kernels 16-17 forward and
16b-17b backward, the RG-LRU recurrence as ``lru_scan`` and ``lru_scan_bwd``,
through their ``autograd.Function``s (``kernels.ops``), and the round's client
steps and server step are kernels 4 and 2-3 (6 on a tree of mixed dtypes,
which keeps the pytree path).  Every arch of ``configs`` trains.

Checkpointing: ``--ckpt-dir`` saves the full federated state (every arena
buffer, the server tree, and the round counter) at the end of the run;
``--resume`` restores the latest checkpoint and continues the same
trajectory -- the synthetic data stream is re-keyed from the restored round
counter, so save-at-r + resume equals the uninterrupted run (bitwise: the
kernels and the round's sums run in a fixed order).  Partial-participation
runs on the cohort engine feed cohort-sized batches from
``data.synthetic.cohort_lm_batches``; with the host-resident population
store (``--popstore``) the store's layout joins the resume fingerprint.

Robustness: ``--faults`` injects a deterministic fault schedule
(``core.faults``), ``--screen`` gates the uplink screen, and ``--watchdog``
arms a divergence watchdog -- after ``--watchdog-patience`` consecutive bad
logged rows (non-finite metrics, or server loss above ``--watchdog-factor``
x the attempt's best) it rolls the full state back to the newest healthy
checkpoint anchor and retries with the stepsize scaled by
``--eta-backoff``.

Telemetry: ``--telemetry`` turns on the metrics registry with an
end-of-run summary; ``--trace-out`` records round-phase spans as Chrome
trace JSON; ``--metrics-out`` streams every logged row through the
crash-safe JSONL sink; ``--profile-rounds A:B`` captures a
``torch.profiler`` trace of exactly those rounds (``telemetry.torchprof``).
All of it is off by default, and the off path adds no per-round host work.

``--eta auto`` derives per-client stepsizes from curvature probes that
differentiate the gradient forward-mode (``vmap(jvp(grad(loss)))``,
``core.autotune.estimate_L``).  On the card the tangents run as kernels too:
16j and 16bj for attention and its backward, 17j and 17bj for the RWKV-6
recurrence and its backward, ``lru_scan_jvp`` and ``lru_scan_bwd_jvp`` for
the RG-LRU (the forward-mode rules of ``kernels.ops``' Functions), so every
arch takes it on the card as on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import telemetry as tel
from repro_torch.configs import get_arch
from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import make as make_fed
from repro_torch.core import make_scan_rounds, popstore, prng
from repro_torch.core import tree_util as T
from repro_torch.core.api import FedOpt, use_arena, use_cohort, use_popstore
from repro_torch.data.synthetic import cohort_lm_batches, lm_batches
from repro_torch.device import resolve
from repro_torch.models import build as build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_device(state, dev: torch.device):
    """A loaded state's tensors on ``dev``; host numpy (the popstore's
    store and running sums) stays on the host."""
    if isinstance(state, dict):
        return {k: (v if k == "pop" else _to_device(v, dev)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        out = [_to_device(v, dev) for v in state]
        return out if isinstance(state, list) else tuple(out)
    if torch.is_tensor(state):
        return state.to(dev)
    return state


def _scalar(v) -> float:
    """The last value of a metric: a scalar, or a stacked (R,) row."""
    return float((v if torch.is_tensor(v) else np.asarray(v)).reshape(-1)[-1])


def _total(v) -> float:
    return float(v.sum()) if torch.is_tensor(v) else float(np.sum(np.asarray(v)))


def run(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 20,
    algorithm: str = "gpdmm",
    k: int = 2,
    eta: float | str = 0.3,
    tol: float = 0.0,
    patience: int = 1,
    m: int = 4,
    per_client_batch: int = 4,
    seq_len: int = 128,
    seed: int = 0,
    ckpt_dir: str | None = None,
    resume: bool = False,
    log_every: int = 5,
    uplink_bits: int | None = None,
    participation: float = 1.0,
    popstore_mode: bool | str = "auto",
    rounds_per_call: int = 1,
    faults: str | FaultConfig | None = None,
    screen: bool | str = "auto",
    deadline: float = math.inf,
    max_staleness: int = 0,
    stale_gamma: float = 0.5,
    async_rounds: bool | str = "auto",
    watchdog: bool = False,
    watchdog_factor: float = 10.0,
    watchdog_patience: int = 2,
    eta_backoff: float = 0.5,
    max_rollbacks: int = 3,
    ckpt_every: int = 0,
    ckpt_keep: int = 3,
    expect_demotions: int = 0,
    expect_rollbacks: int = 0,
    telemetry: bool = False,
    trace_out: str | None = None,
    metrics_out: str | None = None,
    profile_rounds: str | None = None,
    profile_dir: str | None = None,
    device="cuda",
):
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve(device)
    fault_cfg = FaultConfig.parse(faults) if isinstance(faults, str) else faults
    if watchdog and not ckpt_dir:
        raise ValueError("--watchdog needs --ckpt-dir (rollback anchors)")

    # telemetry: any output flag implies the master switch; the tracer only
    # records when it has a sink.  The global tracer is configured so the
    # instrumented library paths (core.popstore staging) emit into the same
    # trace.
    tel_on = telemetry or bool(trace_out) or bool(metrics_out) or bool(profile_rounds)
    tracer = tel.get_tracer()
    was_tracing = tracer.enabled
    if trace_out:
        tracer.configure(enabled=True, trace_out=trace_out)
    registry = tel.Registry() if tel_on else None
    sink = tel.JsonlSink(metrics_out) if metrics_out else None
    prof = tel.RoundProfiler.parse(
        profile_rounds,
        profile_dir or (str(pathlib.Path(trace_out).parent / "torchprof")
                        if trace_out else "telemetry/torchprof"))

    model = build_model(cfg)  # the model ignores cfg.fed
    params = model.init(prng.key(seed), device=dev)

    _eta_cache: list = []

    def resolved_eta():
        """The CLI eta, with ``"auto"`` resolved once host-side into the
        per-client tuple (curvature probes at the init params over a fixed
        probe batch, ``core.autotune``), cached across rebuilds."""
        if not isinstance(eta, str):
            return eta
        if not _eta_cache:
            from repro_torch.core import autotune

            probe = next(lm_batches(prng.key(seed + 3), 1, m, per_client_batch, seq_len,
                                    cfg.vocab_size, device=dev))
            L = autotune.estimate_L(client_grad, params, m, probe)
            etas = autotune.derive_eta(L)
            print(f"[train] auto-eta: per-client L in [{L.min():.4g}, {L.max():.4g}], eta in "
                  f"[{etas.min():.4g}, {etas.max():.4g}]", flush=True)
            _eta_cache.append(tuple(float(e) for e in etas))
        return _eta_cache[0]

    def fed_cfg(scale: float) -> FederatedConfig:
        # eta backoff after a rollback re-derives rho = 1/(K eta') too
        from repro_torch.core import autotune

        fc = dataclasses.replace(
            cfg.fed, algorithm=algorithm, inner_steps=k, eta=resolved_eta(), num_clients=m,
            layout="client_axis", uplink_bits=uplink_bits, participation=participation,
            popstore=popstore_mode, rounds_per_call=rounds_per_call, faults=fault_cfg,
            screen=screen, async_rounds=async_rounds, deadline=deadline,
            max_staleness=max_staleness, stale_gamma=stale_gamma, tol=tol, patience=patience,
        )
        return autotune.scale_eta(fc, scale)

    def client_grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    cfg = dataclasses.replace(cfg, fed=fed_cfg(1.0))

    # fingerprint saved with every checkpoint and checked on --resume
    run_config = {
        "arch": arch, "reduced": reduced, "algorithm": algorithm, "k": k,
        "eta": eta, "m": m, "per_client_batch": per_client_batch,
        "seq_len": seq_len, "seed": seed, "uplink_bits": uplink_bits,
        "participation": participation,
    }
    if fault_cfg is not None:
        run_config["faults"] = dataclasses.asdict(fault_cfg)
        run_config["screen"] = screen if isinstance(screen, str) else bool(screen)
        from repro_torch.core import faults as faults_mod

        if faults_mod.async_on(cfg.fed):
            run_config["deadline"] = deadline
            run_config["max_staleness"] = max_staleness
            run_config["stale_gamma"] = stale_gamma

    cohort = use_cohort(cfg.fed, m) and use_arena(cfg.fed, params)
    pop_on = cohort and use_popstore(cfg.fed, m)
    if pop_on:
        run_config["popstore"] = True

    def load_latest_good(what: str):
        """Newest loadable checkpoint under ckpt_dir: a truncated or corrupt
        newest file is skipped with a loud warning."""
        for step_n in sorted(ckpt.steps(ckpt_dir), reverse=True):
            try:
                with tracer.span("ckpt/load", {"step": step_n}):
                    return step_n, ckpt.load(ckpt_dir, step_n)
            except ValueError as e:
                print(f"[train] {what}: SKIPPING unreadable checkpoint step {step_n}: {e}",
                      flush=True)
        raise FileNotFoundError(f"{what}: no loadable checkpoint under {ckpt_dir}")

    start = 0
    eta_scale = 1.0
    state = None
    if resume:
        if not ckpt_dir:
            raise ValueError("--resume needs --ckpt-dir")
        last, payload = load_latest_good("--resume")
        if "fed_state" not in payload:
            raise ValueError(
                f"checkpoint step {last} under {ckpt_dir} has no 'fed_state' (it holds only "
                "server params); it cannot resume a trajectory -- retrain, or load "
                "payload['server'] manually for serving")
        saved_cfg = payload.get("config", {})
        diffs = {kk: (saved_cfg.get(kk), vv) for kk, vv in run_config.items()
                 if saved_cfg.get(kk) != vv}
        if diffs:
            raise ValueError(
                f"--resume config mismatch vs checkpoint (saved, requested): {diffs}; "
                f"resuming would NOT continue the same trajectory")
        if bool(saved_cfg.get("popstore", False)) != pop_on:
            raise ValueError(
                f"--resume popstore mismatch: checkpoint was written with "
                f"popstore={bool(saved_cfg.get('popstore', False))}, this run resolves "
                f"popstore={pop_on} (popstore_mode={popstore_mode!r}); pass --popstore "
                f"on/off to match")
        state = _to_device(payload["fed_state"], dev)
        start = int(payload["round"])
        eta_scale = float(payload.get("eta_scale", 1.0))
        print(f"[train] resumed full fed state at round {start} from {ckpt_dir}"
              + (f" (eta_scale={eta_scale:g})" if eta_scale != 1.0 else ""))
    if start >= steps:
        print(f"[train] checkpoint already at round {start} >= steps {steps}; nothing to do")
        return []

    R = max(1, rounds_per_call)
    if pop_on and R > 1:
        print(f"[train] popstore active: forcing rounds_per_call {rounds_per_call} -> 1 "
              f"(host-side round driver)")
        R = 1

    def _instrument(fn):
        """Dispatch/sync spans around a round function, installed only when
        tracing is on."""
        if not tracer.enabled:
            return fn

        def wrapped(s, b):
            with tracer.span("round/dispatch"):
                out = fn(s, b)
            with tracer.span("round/block_until_ready"):
                _sync(dev)
            return out

        return wrapped

    def build(scale: float):
        """(fed, step_fn, round_fn) at the given eta scale, rebuilt after
        every watchdog backoff."""
        if pop_on:
            runner = popstore.Runner(fed_cfg(scale), client_grad, device=dev)
            fed = FedOpt(name=algorithm, init=runner.init, round=runner.round,
                         server_params=runner.server_params)
            rf = _instrument(runner.round)
            return fed, rf, rf
        fed = make_fed(fed_cfg(scale))
        # the round gives up its input state (the reference donates it)
        # unless the residual reads the state before the round
        rnd = fed.round if tol > 0.0 or fed.round_ is None else fed.round_

        def one_round(s, b):
            s2, mets = rnd(s, client_grad, b)
            if tol > 0.0:
                from repro_torch.core import autotune

                mets = {**mets, **autotune.state_residual(s, s2)}
            return s2, mets

        step_fn = make_scan_rounds(fed, client_grad, tol=tol) if R > 1 else one_round
        return fed, _instrument(step_fn), _instrument(one_round)

    @torch.no_grad()
    def eval_loss(p, batch):
        # server-model loss averaged over the same stacked batch
        losses = torch.func.vmap(lambda b: model.loss(p, b)[0])(batch)
        return losses.mean()

    history = []
    n_rounds = steps - start

    def make_data(from_round: int):
        # re-keyed from the starting round: a rollback (or --resume)
        # regenerates the stream the uninterrupted run saw from that round
        data_key = prng.key(seed + 1)
        if cohort:
            return cohort_lm_batches(data_key, steps - from_round, m, per_client_batch,
                                     seq_len, cfg.vocab_size, participation=participation,
                                     fed_seed=cfg.fed.seed, start=from_round, device=dev)
        return lm_batches(data_key, steps - from_round, m, per_client_batch, seq_len,
                          cfg.vocab_size, start=from_round, device=dev)

    # cohort batches cover only the round's active clients: the logged loss
    # is on one fixed full-population batch instead
    eval_batch = None
    if cohort:
        eval_batch = next(lm_batches(prng.key(seed + 2), 1, m, per_client_batch, seq_len,
                                     cfg.vocab_size, device=dev))

    def metrics_row(metrics):
        # last-round values, whether stacked (R,) from the scan or scalars
        return {kk: _scalar(v) for kk, v in metrics.items() if kk != "trace"}

    class _Watchdog:
        """Trips after ``watchdog_patience`` consecutive bad logged rows."""

        def __init__(self):
            self.best = math.inf
            self.strikes = 0

        def note(self, row) -> bool:
            bad = (any(not math.isfinite(v) for v in row.values() if isinstance(v, float))
                   or row["server_loss"] > watchdog_factor * self.best)
            if bad:
                self.strikes += 1
                tracer.instant("watchdog/strike", {"round": row["round"],
                                                   "strikes": self.strikes,
                                                   "server_loss": row["server_loss"]})
                if registry is not None:
                    registry.counter("watchdog_strikes").inc()
            else:
                self.strikes = 0
                self.best = min(self.best, row["server_loss"])
            return self.strikes >= watchdog_patience

    injected_total = demoted_total = 0.0
    last_saved = None

    def note_faults(metrics):
        nonlocal injected_total, demoted_total
        if metrics and "faults_demoted" in metrics:
            injected_total += _total(metrics["faults_injected"])
            demoted_total += _total(metrics["faults_demoted"])
        if registry is not None and metrics:
            for key in tel.COUNTER_KEYS:
                if key in metrics:
                    v = _total(metrics[key])
                    if math.isfinite(v):
                        registry.counter(key).inc(v)

    def save_anchor(fed, state, scale):
        done = int(state["round"])
        with tracer.span("ckpt/save", {"round": done}):
            t0 = time.perf_counter()
            path = ckpt.save(ckpt_dir, done, {
                "server": fed.server_params(state),
                "fed_state": state,
                "round": done,
                "config": run_config,
                "eta_scale": scale,
            }, keep=ckpt_keep)
            dt = time.perf_counter() - t0
        if registry is not None:
            registry.counter("ckpt_saves").inc()
            registry.counter("ckpt_bytes").inc(os.path.getsize(path))
            registry.histogram("ckpt_save_s").observe(dt)
        return done

    def traced_batches(it):
        """Each ``next`` of the batch stream as a round/batch_build span,
        only when tracing."""
        if not tracer.enabled:
            return it

        def gen():
            src = iter(it)
            while True:
                with tracer.span("round/batch_build"):
                    try:
                        b = next(src)
                    except StopIteration:
                        return
                yield b

        return gen()

    def attempt(fed, step_fn, round_fn, state, from_round, scale, wd):
        """One trajectory attempt from ``from_round``; returns ``(state,
        "done" | "diverged")``."""
        nonlocal last_saved
        data = traced_batches(make_data(from_round))

        ee = None
        if tol > 0.0:
            from repro_torch.core import autotune

            ee = autotune.EarlyExit(tol, patience)

        def note_exit(i):
            saved = steps - i
            tracer.instant("autotune/early_exit",
                           {"round": i, "rounds_saved": saved, "rel_residual": ee.last_rel})
            if registry is not None:
                registry.counter("rounds_saved").inc(saved)
            print(f"[train] early exit at round {i}: relative residual {ee.last_rel:.3g} < "
                  f"tol {tol:g} for {patience} consecutive round(s); {saved} budgeted "
                  f"round(s) saved", flush=True)

        def log_round(i, state, metrics, eb):
            nonlocal last_saved
            with tracer.span("round/eval_log", {"round": i}):
                row = {"round": i,
                       "server_loss": float(eval_loss(fed.server_params(state), eb)),
                       **(metrics_row(metrics) if metrics is not None else {})}
            history.append(row)
            if sink is not None:
                sink.write({"kind": "round", **row})
            if registry is not None:
                registry.absorb(row, counters=())
            tracer.flush()
            print(f"[train] {json.dumps(row)}", flush=True)
            diverged = wd.note(row) if wd is not None else False
            healthy = math.isfinite(row["server_loss"]) and (wd is None or wd.strikes == 0)
            if (ckpt_dir and ckpt_every > 0 and healthy
                    and (last_saved is None or i - last_saved >= ckpt_every)):
                save_anchor(fed, state, scale)
                last_saved = i
            return diverged

        if R > 1:
            # a tail shorter than R runs round by round
            pending = []
            i = from_round
            last = metrics = None
            for batch in data:
                pending.append(batch)
                last = batch
                if len(pending) < R:
                    continue
                with tracer.span("round/batch_stack", {"R": R}):
                    stacked = T.tmap(lambda *xs: torch.stack(xs), *pending)
                pending = []
                if prof is not None:
                    prof.before_round(i + 1)
                state, metrics = step_fn(state, stacked)  # metrics stacked (R,)
                note_faults(metrics)
                i += R
                if prof is not None:
                    _sync(dev)
                    prof.after_round(i)
                if ee is not None and "res_dx2" in metrics:
                    if ee.update(metrics["res_dx2"], metrics["res_x2"]) is not None:
                        note_exit(i)
                        eb = eval_batch if eval_batch is not None else last
                        if not history or history[-1]["round"] != i:
                            log_round(i, state, metrics, eb)
                        return state, "done"
                if (i - R) // max(1, log_every) != i // max(1, log_every):
                    eb = eval_batch if eval_batch is not None else last
                    if log_round(i, state, metrics, eb):
                        return state, "diverged"
            for batch in pending:
                state, metrics = round_fn(state, batch)
                note_faults(metrics)
                i += 1
            if last is not None and (not history or history[-1]["round"] != i):
                eb = eval_batch if eval_batch is not None else last
                if log_round(i, state, metrics, eb):
                    return state, "diverged"
            return state, "done"

        # ``i`` counts completed rounds after each dispatch (the state's
        # round counter), the numbering the R > 1 path logs
        for i, batch in enumerate(data, start=from_round + 1):
            if prof is not None:
                prof.before_round(i)
            state, metrics = step_fn(state, batch)
            if prof is not None:
                _sync(dev)
                prof.after_round(i)
            note_faults(metrics)
            if ee is not None and metrics and "res_dx2" in metrics:
                if ee.update(metrics["res_dx2"], metrics["res_x2"]) is not None:
                    note_exit(i)
                    eb = eval_batch if eval_batch is not None else batch
                    if not history or history[-1]["round"] != i:
                        log_round(i, state, metrics, eb)
                    return state, "done"
            if (i - 1) // max(1, log_every) != i // max(1, log_every) or i == steps:
                eb = eval_batch if eval_batch is not None else batch
                if log_round(i, state, metrics, eb):
                    return state, "diverged"
        return state, "done"

    t0 = time.perf_counter()
    rollbacks = 0
    wd = _Watchdog() if watchdog else None
    fed, step_fn, round_fn = build(eta_scale)
    if state is None:
        state = fed.init(params, m)
    if wd is not None and ckpt.latest_step(ckpt_dir) is None:
        # round-start anchor: the first divergence has somewhere to roll back to
        last_saved = save_anchor(fed, state, eta_scale)
    try:
        while True:
            state, status = attempt(fed, step_fn, round_fn, state, start, eta_scale, wd)
            if status == "done":
                break
            rollbacks += 1
            if rollbacks > max_rollbacks:
                raise RuntimeError(
                    f"divergence watchdog: {rollbacks} rollbacks exceeded "
                    f"max_rollbacks={max_rollbacks} (eta_scale={eta_scale:g}); the run does "
                    f"not converge at any tried stepsize")
            _anchor, payload = load_latest_good("watchdog rollback")
            state = _to_device(payload["fed_state"], dev)
            start = int(payload["round"])
            eta_scale *= eta_backoff
            wd = _Watchdog()
            tracer.instant("watchdog/rollback", {"to_round": start, "eta_scale": eta_scale,
                                                 "rollbacks": rollbacks})
            if registry is not None:
                registry.counter("rollbacks").inc()
            print(f"[train] watchdog: diverged; rolled back to round {start}, "
                  f"eta_scale -> {eta_scale:g}", flush=True)
            fed, step_fn, round_fn = build(eta_scale)
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"[train] {n_rounds} rounds (K={k}, m={m}) in {dt:.1f}s; algo={algorithm}, "
              f"rounds_per_call={R}" + (", cohort batches" if cohort else ""))

        if ckpt_dir:
            # the full fed state, not just server params: ``load`` + --resume
            # continues the exact trajectory; "server" is for serving
            done = int(state["round"])
            save_anchor(fed, state, eta_scale)
            print(f"[train] full-state checkpoint (round {done}) saved to {ckpt_dir}")
        if fault_cfg is not None or watchdog:
            print(f"[train] robustness: faults_injected={injected_total:.0f} "
                  f"demoted={demoted_total:.0f} rollbacks={rollbacks} "
                  f"eta_scale={eta_scale:g}")
    finally:
        # telemetry teardown runs on the crash path too
        if prof is not None:
            prof.close()
        if registry is not None:
            registry.gauge("eta_scale").set(eta_scale)
        if sink is not None:
            sink.write({"kind": "summary", **registry.summary_row()})
            sink.close()
        if tel_on:
            print(f"[train] telemetry: {json.dumps(registry.summary_row(), default=float)}",
                  flush=True)
        if trace_out:
            trace_path = tracer.close()
            if trace_path:
                print(f"[train] trace written to {trace_path} (load in "
                      f"https://ui.perfetto.dev)", flush=True)
            tracer.configure(enabled=was_tracing)
    if expect_demotions and demoted_total < expect_demotions:
        raise RuntimeError(f"expected >= {expect_demotions} screened demotions, "
                           f"saw {demoted_total:.0f}")
    if expect_rollbacks and rollbacks < expect_rollbacks:
        raise RuntimeError(f"expected >= {expect_rollbacks} watchdog rollbacks, "
                           f"saw {rollbacks}")
    return history


def _eta_arg(s: str):
    """``--eta`` accepts a float or the literal ``auto``."""
    return "auto" if s == "auto" else float(s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--algorithm", default="gpdmm",
                    choices=["gpdmm", "agpdmm", "scaffold", "fedavg", "fedsplit"])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--eta", type=_eta_arg, default=0.3,
                    help="client stepsize, or 'auto' to derive per-client eta_i = safety / "
                         "L_i from a curvature probe (CPU only for now)")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="relative fixed-point residual tolerance: terminate once "
                         "||x - x_prev|| / ||x|| < tol for --patience consecutive rounds "
                         "(0 = fixed round budget)")
    ap.add_argument("--patience", type=int, default=1,
                    help="consecutive sub-tol rounds required before the early exit fires")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest full-state checkpoint from --ckpt-dir and "
                         "continue the same trajectory")
    ap.add_argument("--uplink-bits", type=int, default=None,
                    help="EF21 delta-quantised uplink (beyond paper)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients active per round (< 1 runs the cohort-sampled "
                         "round engine)")
    ap.add_argument("--popstore", default="auto", choices=["auto", "on", "off"],
                    help="host-resident population store: O(cohort) device memory (auto = "
                         "on for cohort runs at >= popstore_min_clients)")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="rounds per call of the round driver (make_scan_rounds)")
    ap.add_argument("--log-every", type=int, default=5,
                    help="rounds between logged rows (the watchdog and the periodic anchors "
                         "act at logged rows)")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault schedule, e.g. 'dropout=0.1,corrupt=0.05,seed=7'")
    ap.add_argument("--screen", default="auto", choices=["auto", "on", "off"],
                    help="uplink screening (auto = on iff faults active)")
    ap.add_argument("--deadline", type=float, default=math.inf,
                    help="straggler deadline in rounds: a drawn lateness past it demotes the "
                         "client to silence for the round")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="admit stale uplinks up to this age (0 = the synchronous point)")
    ap.add_argument("--stale-gamma", type=float, default=0.5,
                    help="admission weight gamma**age for arriving stale rows")
    ap.add_argument("--async", dest="async_rounds", default="auto",
                    choices=["auto", "on", "off"],
                    help="bounded-staleness round engine (auto = on iff the staleness knobs "
                         "deviate from the synchronous point)")
    ap.add_argument("--watchdog", action="store_true",
                    help="divergence watchdog: roll back to the newest healthy checkpoint "
                         "with eta backoff (needs --ckpt-dir)")
    ap.add_argument("--watchdog-factor", type=float, default=10.0,
                    help="a logged loss above factor x best counts as bad")
    ap.add_argument("--watchdog-patience", type=int, default=2,
                    help="consecutive bad logged rows before rollback")
    ap.add_argument("--eta-backoff", type=float, default=0.5,
                    help="eta multiplier applied on each rollback")
    ap.add_argument("--max-rollbacks", type=int, default=3)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a rollback anchor every N logged rounds (0 = final only)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retain only the newest N anchors")
    ap.add_argument("--expect-demotions", type=int, default=0,
                    help="fail unless >= N uplinks were demoted")
    ap.add_argument("--expect-rollbacks", type=int, default=0,
                    help="fail unless >= N rollbacks happened")
    ap.add_argument("--telemetry", action="store_true",
                    help="metrics registry + structured end-of-run summary (implied by any "
                         "of the output flags below)")
    ap.add_argument("--trace-out", default=None,
                    help="write round-phase spans as Chrome trace-event JSON")
    ap.add_argument("--metrics-out", default=None,
                    help="stream every logged row + an end-of-run summary to this JSONL file")
    ap.add_argument("--profile-rounds", default=None,
                    help="capture a torch.profiler trace for exactly rounds A:B (e.g. '3:5')")
    ap.add_argument("--profile-dir", default=None,
                    help="profiler output dir (default: next to --trace-out, else "
                         "./telemetry/torchprof)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    return run(
        args.arch, reduced=args.reduced, steps=args.steps, algorithm=args.algorithm,
        k=args.k, eta=args.eta, tol=args.tol, patience=args.patience,
        m=args.clients, per_client_batch=args.batch, seq_len=args.seq, seed=args.seed,
        ckpt_dir=args.ckpt_dir, resume=args.resume, uplink_bits=args.uplink_bits,
        participation=args.participation,
        popstore_mode={"auto": "auto", "on": True, "off": False}[args.popstore],
        rounds_per_call=args.rounds_per_call, log_every=args.log_every, faults=args.faults,
        screen={"auto": "auto", "on": True, "off": False}[args.screen],
        deadline=args.deadline, max_staleness=args.max_staleness,
        stale_gamma=args.stale_gamma,
        async_rounds={"auto": "auto", "on": True, "off": False}[args.async_rounds],
        watchdog=args.watchdog, watchdog_factor=args.watchdog_factor,
        watchdog_patience=args.watchdog_patience, eta_backoff=args.eta_backoff,
        max_rollbacks=args.max_rollbacks, ckpt_every=args.ckpt_every,
        ckpt_keep=args.ckpt_keep, expect_demotions=args.expect_demotions,
        expect_rollbacks=args.expect_rollbacks, telemetry=args.telemetry,
        trace_out=args.trace_out, metrics_out=args.metrics_out,
        profile_rounds=args.profile_rounds, profile_dir=args.profile_dir, device=args.device,
    )


if __name__ == "__main__":
    main()
