#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, in order; any failure ends the run with a non-zero exit code:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``src/repro_torch/kernels/csrc`` (timed set-up);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, time both on the device with CUDA
     events (and the kernel as the host enqueues it), and check
     the port on a small least-squares problem against its own CPU run;
  4. least squares at the paper's Fig. 2 size (m = n = d = 500, K = 5,
     ``use_arena=True`` with ``oracle()``): 30 rounds each of GPDMM and
     AGPDMM; ||x - x*|| must fall, the dual-sum invariant (25) hold to
     the rounding of the f32 client mean, and
     every value stay finite; ``inner_loop_affine``, ``round_tail`` and
     ``dual_from_uplink`` must launch once per round;
  5. softmax regression at the paper's Table I size (F = 784, C = 10,
     m = 10, B = 300, K = 5, one class per client): 10 rounds of each
     algorithm; the loss must fall and ``fused_update_arena`` launch K
     times per round;
  6. print one JSON line of per-kernel numbers, then the result line
     ``{"ok": true, "device": {...}}`` last.

Launch counts are set to 0 just before each main-path phase and read just
after it; the launches of phase 3 do not count.  The script imports no JAX
and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F32_EPS = 2.0 ** -23
LSQ = dict(m=500, n=500, d=500, K=5, rounds=30)
SOFTMAX = dict(F=784, C=10, m=10, B=300, K=5, rounds=10, n=1200)


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3, prefill: bool = True) -> float:
    """Mean time per call between CUDA events around ``iters`` calls.

    With ``prefill`` the stream is first kept busy by a spin kernel long
    enough for the host to enqueue every call, so the events time the
    device alone (kernels back to back); without it the host's enqueue
    (Python, ctypes, checks) may set the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(iters * 400_000)  # ~200 us of spinning per call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


class Record:
    """Per-kernel numbers for the JSON line."""

    def __init__(self, ops):
        self.rows = {k.name: {"name": k.name, "route": "cuda",
                              "source": f"src/repro_torch/kernels/csrc/{k.source}",
                              "replaces": k.replaces, "launches": 0}
                     for k in ops.KERNELS}

    def kernel(self, name, err, fn, plain_fn, iters, nbytes, flops):
        """Time ``fn`` (the kernel) and ``plain_fn`` on the device, and the
        kernel once more as the host enqueues it (``enqueue_ms``)."""
        ms, plain_ms = cuda_time_ms(fn, iters), cuda_time_ms(plain_fn, iters)
        enqueue_ms = cuda_time_ms(fn, iters, prefill=False)
        b, by = bound_ms(nbytes, flops)
        self.rows[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                               bound_by=by, library_ms=None, enqueue_ms=enqueue_ms)
        log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b:.4f} ms ({by})  host-paced {enqueue_ms:.4f} ms")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(rec, prob, eta, rho, torch, ops, ref, gen):
    dev = torch.device("cuda")
    m, d, K = LSQ["m"], LSQ["d"], LSQ["K"]
    from repro_torch.core.arena import ArenaSpec

    spec = ArenaSpec.from_tree(prob.x_star)
    w = spec.width
    H, c = prob.oracle().affine_arena(spec, prob.batch())
    x0 = torch.randn(m, w, generator=gen, device=dev)
    x0[:, d:] = 0
    lam = 0.1 * torch.randn(m, w, generator=gen, device=dev)
    lam[:, d:] = 0
    xs = spec.pack(prob.x_star)
    step = 1.0 / (1.0 / eta + rho)

    # inner loop: the matvec sums in another order than the plain einsum
    got = ops.inner_loop_affine(x0, H, c, xs, lam, step, rho, K)
    want = ref.inner_loop_affine_ref(x0, H, c, xs, lam, step, rho, K)
    scale = max(1.0, float(want[0].abs().max()))
    err = max(max_err(a, b) for a, b in zip(got, want))
    check(err <= 1e-4 * scale, f"inner_loop_affine: error {err} > 1e-4 * {scale}")
    nbytes = 4 * (m * w * w + 3 * m * w + w + 2 * m * w)
    flops = m * K * (2 * w * w + 8 * w)
    rec.kernel("inner_loop_affine", err,
               lambda: ops.inner_loop_affine(x0, H, c, xs, lam, step, rho, K),
               lambda: ref.inner_loop_affine_ref(x0, H, c, xs, lam, step, rho, K), 20,
               nbytes, flops)

    # round tail (f32 timed, bf16 checked); lam_is is bitwise, the uplink
    # differs by the plain version's multiply-by-reciprocal division
    for dt in (torch.float32, torch.bfloat16):
        xr, lm, sr = x0.to(dt), lam.to(dt), xs.to(dt)
        for wl in (True, False):
            g_li, g_up = ops.round_tail(xr, lm, sr, rho, with_lam_is=wl)
            w_li, w_up = ref.round_tail_ref(xr, lm, sr, rho, with_lam_is=wl)
            ulp = 2.0 ** (-23 if dt == torch.float32 else -7)
            e_up = max_err(g_up, w_up)
            check(e_up <= 2 * ulp * max(1.0, float(w_up.float().abs().max())),
                  f"round_tail {dt}: uplink error {e_up}")
            if wl:
                check(max_err(g_li, w_li) == 0.0, f"round_tail {dt}: lam_is differs")
            else:
                check(g_li is None, "round_tail: lam_is returned without asking")
    _, g_up = ops.round_tail(x0, lam, xs, rho, with_lam_is=False)
    _, w_up = ref.round_tail_ref(x0, lam, xs, rho, with_lam_is=False)
    rec.kernel("round_tail", max_err(g_up, w_up),
               lambda: ops.round_tail(x0, lam, xs, rho, with_lam_is=False),
               lambda: ref.round_tail_ref(x0, lam, xs, rho, with_lam_is=False), 200,
               4 * (3 * m * w + w), 5 * m * w)

    for dt in (torch.float32, torch.bfloat16):
        e = max_err(ops.dual_from_uplink(x0.to(dt), xs.to(dt), rho),
                    ref.dual_from_uplink_ref(x0.to(dt), xs.to(dt), rho))
        check(e == 0.0, f"dual_from_uplink {dt}: error {e}")
    rec.kernel("dual_from_uplink", 0.0,
               lambda: ops.dual_from_uplink(x0, xs, rho),
               lambda: ref.dual_from_uplink_ref(x0, xs, rho), 200,
               4 * (2 * m * w + w), 2 * m * w)

    # fused update at the softmax arena: m = 10, W = 7936
    ms_, ws = SOFTMAX["m"], 7936
    xa, ga, la = (torch.randn(ms_, ws, generator=gen, device=dev) for _ in range(3))
    xsa = torch.randn(ws, generator=gen, device=dev)
    steps = torch.rand(ms_, generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for st in (0.05, steps):
            for lm in (la, None):
                lmd = None if lm is None else lm.to(dt)
                e = max_err(ops.fused_update_arena(xa.to(dt), ga.to(dt), xsa.to(dt), lmd, st, 4.0),
                            ref.fused_update_arena_ref(xa.to(dt), ga.to(dt), xsa.to(dt), lmd, st, 4.0))
                check(e == 0.0, f"fused_update_arena {dt}: error {e}")
    rec.kernel("fused_update_arena", 0.0,
               lambda: ops.fused_update_arena(xa, ga, xsa, la, 0.05, 4.0),
               lambda: ref.fused_update_arena_ref(xa, ga, xsa, la, 0.05, 4.0), 200,
               4 * (4 * ms_ * ws + ws), 7 * ms_ * ws)
    torch.cuda.synchronize()


def check_small_against_cpu(torch, make, FederatedConfig, quadratic):
    """The port on the card against the port on the CPU (plain versions),
    5 GPDMM rounds at quickstart size; rtol = atol = 1e-4: the matvec and
    the client mean sum in other orders on the two devices."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=64, d=64, device="cpu")
    fields = {f: getattr(prob, f) for f in ("AtA", "Atb", "btb", "evals", "evecs",
                                            "x_star", "f_star")}
    gprob = type(prob)(**{k: v.cuda() for k, v in fields.items()}, L=prob.L, mu=prob.mu)
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=5, eta=0.5 / prob.L,
                               use_arena=True))
    s_cpu, s_gpu = opt.init(torch.zeros(64), 8), opt.init(torch.zeros(64, device="cuda"), 8)
    for _ in range(5):
        s_cpu, _ = opt.round(s_cpu, prob.oracle(), prob.batch())
        s_gpu, _ = opt.round(s_gpu, gprob.oracle(), gprob.batch())
    torch.testing.assert_close(s_gpu["x_s"].cpu(), s_cpu["x_s"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_gpu["x_c"].cpu(), s_cpu["x_c"], rtol=1e-4, atol=1e-4)
    log("small least squares: card == CPU (rtol = atol = 1e-4) after 5 GPDMM rounds")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def run_rounds(torch, ops, opt, state, grad, batch_of, rounds, per_step, on_round=None):
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(rounds):
        state, metrics = opt.round(state, grad, batch_of(r), per_step)
        if on_round is not None:
            on_round(r, state, metrics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return state, metrics, ops.launches(), secs


def lsq_phase(rec, prob, torch, ops, make, FederatedConfig, dev, prof=None):
    R, K, m = LSQ["rounds"], LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    rho = 1.0 / (K * eta)
    x0 = torch.zeros(prob.d, device=dev)
    d0 = float(prob.dist(x0))
    dists = {}
    for algo in ("gpdmm", "agpdmm"):
        opt = make(FederatedConfig(algorithm=algo, inner_steps=K, eta=eta, use_arena=True))
        state = opt.init(x0, m)
        trail = []
        inv = []

        def on_round(r, s, met):
            if r in (0, R // 2 - 1, R - 1):
                trail.append(float(prob.dist(s["x_s"])))
                # invariant (25): sum_i lam_i = rho m (mean u - x_s') is zero
                # up to the f32 rounding of the client mean, ~ rho m eps ||x_s||
                scale = rho * m * F32_EPS * max(1.0, float(torch.linalg.vector_norm(s["x_s"])))
                inv.append(float(met["lam_sum_norm"]) / scale)

        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, state, prob.oracle(), lambda r: prob.batch(), R, False, on_round)
        for k in ("inner_loop_affine", "round_tail", "dual_from_uplink"):
            rec.rows[k]["launches"] += counts[k]
        log(f"lsq {algo}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"||x - x*|| {d0:.4e} -> {trail}; launches {counts}; "
            f"lam_sum_norm / (rho m eps ||x_s||) {[round(v, 3) for v in inv]}")
        check(counts == {"inner_loop_affine": R, "round_tail": R, "dual_from_uplink": R,
                         "fused_update_arena": 0}, f"lsq {algo}: launches {counts}")
        check(trail[-1] < trail[0] < d0, f"lsq {algo}: distance did not fall: {trail}")
        check(max(inv) < 16.0, f"lsq {algo}: dual-sum invariant (25) broken: {inv}")
        for k in ("x_s", "lam_s") + (("x_c",) if "x_c" in state else ()):
            check(bool(torch.isfinite(state[k]).all()), f"lsq {algo}: {k} not finite")
        check(tuple(state["x_s"].shape) == (prob.d,), "lsq: x_s shape")
        dists[algo] = trail
        if prof is not None:
            prof(f"lsq_{algo}", lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                                   lambda r: prob.batch(), 3, False),
                 1e3 * secs / R, 3)
    log(f"lsq info: AGPDMM {dists['agpdmm']} vs GPDMM {dists['gpdmm']} (||x - x*|| at "
        f"rounds 1, {R // 2}, {R})")


def mixture_data(torch, gen, F, C, n, dev):
    """One class per client, n samples each: class means of norm ~ sqrt(F)
    * 0.12 plus unit noise, scaled by 1/10 (the Table I set-up)."""
    means = 0.12 * torch.randn(C, F, generator=gen, device=dev)
    x = (means[:, None, :] + torch.randn(C, n, F, generator=gen, device=dev)) / 10.0
    y = torch.arange(C, device=dev, dtype=torch.int32)[:, None].expand(C, n).contiguous()
    return x, y


def softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, gen, dev,
                  prof=None):
    F, C, m, B, K, R, n = (SOFTMAX[k] for k in ("F", "C", "m", "B", "K", "rounds", "n"))
    prob = SoftmaxRegression(F, C)
    xs, ys = mixture_data(torch, gen, F, C, n, dev)
    pool = {"x": xs.reshape(-1, F), "y": ys.reshape(-1)}

    def batch_of(r):
        starts = [((r * K + k) * B) % (n - B + 1) for k in range(K)]
        return {"x": torch.stack([xs[:, s:s + B] for s in starts]),
                "y": torch.stack([ys[:, s:s + B] for s in starts])}

    for algo in ("gpdmm", "agpdmm"):
        # the default use_arena="auto" takes the arena here: W = 7936 >= 1024
        opt = make(FederatedConfig(algorithm=algo, inner_steps=K, eta=0.05))
        state = opt.init(prob.init_params(dev), m)
        loss0 = float(prob.loss(opt.server_params(state), pool))
        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, state, prob.oracle(), batch_of, R, True)
        w = opt.server_params(state)
        loss1, acc = float(prob.loss(w, pool)), float(prob.accuracy(w, pool["x"], pool["y"]))
        for k in ("fused_update_arena", "round_tail", "dual_from_uplink"):
            rec.rows[k]["launches"] += counts[k]
        log(f"softmax {algo}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"loss {loss0:.4f} -> {loss1:.4f}, train accuracy {acc:.3f}; launches {counts}")
        check(counts == {"inner_loop_affine": 0, "round_tail": R, "dual_from_uplink": R,
                         "fused_update_arena": K * R}, f"softmax {algo}: launches {counts}")
        check(math.isfinite(loss1) and loss1 < loss0, f"softmax {algo}: loss {loss0} -> {loss1}")
        check(bool(torch.isfinite(state["lam_s"]).all()), f"softmax {algo}: lam_s not finite")
        if prof is not None:
            prof(f"softmax_{algo}", lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                                       batch_of, 3, True),
                 1e3 * secs / R, 3)


def profile_rounds(torch, label, run, round_ms, rounds, out):
    """torch.profiler over ``run`` (``rounds`` rounds): kernel time by name,
    device-busy time per round, and the device's idle share of the round
    time ``round_ms`` measured without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    events = p.key_averages()
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in events
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy_ms /= rounds
    idle = max(0.0, 1.0 - busy_ms / round_ms)
    log(f"profile {label}: device busy {busy_ms:.4f} ms/round of {round_ms:.4f} ms/round; "
        f"idle share {idle:.3f}")
    table = events.table(sort_by="self_device_time_total", row_limit=12)
    log(table)
    out[f"profile_{label}"] = {"busy_ms_per_round": busy_ms, "round_ms": round_ms,
                               "idle_share": idle, "table": table}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="after each algorithm's rounds, profile 3 more: kernel times "
                         "by name and the device's idle share")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make, quadratic
    from repro_torch.core.softmax import SoftmaxRegression
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    out = {"card": card}

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s for {sorted(logs) or 'nothing (cached)'}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    out["build_s"] = build_s

    rec = Record(ops)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    prob = quadratic.generate(gen, m=LSQ["m"], n=LSQ["n"], d=LSQ["d"], device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"least squares m={LSQ['m']} n={LSQ['n']} d={LSQ['d']}: set-up (draw, Gram, "
        f"batched eigh, solve) {setup_s:.2f} s; L {prob.L:.4e} mu {prob.mu:.4e}")
    out["lsq_setup_s"] = setup_s

    eta = 0.5 / prob.L
    check_kernels(rec, prob, eta, 1.0 / (LSQ["K"] * eta), torch, ops, ref, gen)
    check_small_against_cpu(torch, make, FederatedConfig, quadratic)

    dev = torch.device("cuda")
    prof = None
    if args.profile:
        def prof(label, run, round_ms, rounds):
            profile_rounds(torch, label, run, round_ms, rounds, out)
    lsq_phase(rec, prob, torch, ops, make, FederatedConfig, dev, prof)
    softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, gen, dev, prof)

    kernels = {"kernels": list(rec.rows.values())}
    out |= kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
