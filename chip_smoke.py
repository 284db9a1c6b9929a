#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, in order; any failure ends the run with a non-zero exit code:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``src/repro_torch/kernels/csrc`` (timed set-up);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (f32 and bf16, with and without the
     optional operands), time both on the device with CUDA events (and the
     kernel as the host enqueues it), and check the port on a small
     least-squares problem against its own CPU run;
  4. least squares at the paper's Fig. 2 size (m = n = d = 500, K = 5,
     ``use_arena=True`` with ``oracle()``): 30 rounds each of GPDMM,
     AGPDMM, SCAFFOLD and FedAvg; ||x - x*|| must fall, the dual-sum
     invariant (25) and SCAFFOLD's sum_i (c_i - c) = 0 hold to the rounding
     of the f32 client mean, and every value stay finite;
     ``inner_loop_affine`` launches once per round, ``round_tail`` and
     ``dual_from_uplink`` once per GPDMM/AGPDMM round, ``scaffold_cv``
     once per SCAFFOLD round;
  5. softmax regression at the paper's Table I size (F = 784, C = 10,
     m = 10, B = 300, K = 5, one class per client): 10 rounds each of
     GPDMM, AGPDMM, SCAFFOLD, FedAvg, Inexact FedSplit (x_s init) and GPDMM
     with SVRG; the loss must fall, ``fused_update_arena`` (``fused_update``
     for FedSplit) launch K times per round;
  6. Fig. 2 as ``benchmarks/fig2_lsq.py`` runs it: the default config (the
     per-leaf pytree path at W = 512) with the plain grad, eta = 0.5 / L,
     200 rounds of FedAvg, GPDMM, AGPDMM and SCAFFOLD at m = n = d = 500,
     K in {1, 5, 20} and at m = 25, n = 5000, d = 500, K in {1, 3, 5, 10,
     20}; the benchmark's claims must hold for K > 1 (AGPDMM within 1.05x
     of GPDMM at round 50, FedAvg's final distance above 10x AGPDMM's),
     the K = 1 trajectories of AGPDMM, SCAFFOLD and FedAvg agree (paper
     (27)/(31)), and ``fused_update`` launch K times per round, no arena
     kernel at all;
  7. Fig. 1 as ``benchmarks/fig1_fedsplit.py`` runs it: Inexact FedSplit
     at m = 25 (rho = L / 10, eta = 1 / L), init z and x_s, K in {1, 3},
     300 rounds; the x_s init's gap must be below 1e-3 of the z init's, as
     the benchmark computes it (f32) and in float64;
  8. partial participation and the EF21 uplink on phase 4's problem (30
     rounds): GPDMM, AGPDMM, SCAFFOLD and FedAvg at participation 0.1 (the
     cohort engine, 50 of 500 clients), GPDMM, AGPDMM and FedAvg with
     8-bit EF21 on top, GPDMM with EF21 at full participation, and GPDMM
     at participation 0.1 on the masked full-population round
     (``cohort=False``), whose every state entry must equal the cohort
     run's at each round (rtol 1e-5); GPDMM at participation 0.1, plain
     and with 8-bit EF21, on the default config (the per-leaf pytree path,
     the plain grad); ||x - x*|| falls, the invariants hold, the launches
     per round are as derived from the code; then softmax at the Table I
     size with participation 0.5 and 8-bit EF21 (GPDMM, FedAvg), whose loss
     must fall;
  9. print one JSON line of per-kernel numbers, then the result line
     ``{"ok": true, "device": {...}}`` last.

Phase 3 also holds the cohort kernels (``row_gather``, ``row_scatter``)
and the EF21 kernels (``ef21_rowmax``, ``ef21_apply``) bitwise against
their plain versions (f32 and bf16, a NaN included), and times the one
PyTorch call that computes the same function where there is one
(``index_select``, ``index_copy``).

Launch counts are set to 0 just before each run of the main path (phases
3-8) and read just after it; the launches of phase 3's comparisons do not
count.  Each phase draws its data from a generator of its own.  The script
imports no JAX and nothing of the JAX package.
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
# benchmarks/fig2_lsq.py:47-51 and fig1_fedsplit.py:18-30
FIG2 = dict(rounds=200, methods=("fedavg", "gpdmm", "agpdmm", "scaffold"),
            settings=((500, 500, (1, 5, 20)), (25, 5000, (1, 3, 5, 10, 20))))
FIG1 = dict(rounds=300, m=25, n=5000, inits=("z", "xs"), Ks=(1, 3))


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3, prefill: bool = True,
                 spin_cycles: int = 400_000) -> float:
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
        torch.cuda._sleep(iters * spin_cycles)  # by default ~200 us of spinning per call
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

    def add(self, counts):
        """Add a main-path run's launch counts."""
        for k, n in counts.items():
            self.rows[k]["launches"] += n

    def kernel(self, name, err, fn, plain_fn, iters, nbytes, flops, library_fn=None):
        """Time ``fn`` (the kernel), ``plain_fn`` and, where one PyTorch call
        computes the same function, ``library_fn`` on the device, and the
        kernel once more as the host enqueues it (``enqueue_ms``)."""
        ms, plain_ms = cuda_time_ms(fn, iters), cuda_time_ms(plain_fn, iters)
        library_ms = None if library_fn is None else cuda_time_ms(library_fn, iters)
        enqueue_ms = cuda_time_ms(fn, iters, prefill=False)
        b, by = bound_ms(nbytes, flops)
        self.rows[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                               bound_by=by, library_ms=library_ms, enqueue_ms=enqueue_ms)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {lib}  bound {b:.4f} ms ({by})  host-paced {enqueue_ms:.4f} ms")


def seeded(torch, seed: int):
    """A generator of its own on the card for each phase's data, so that no
    phase's problem depends on what an earlier phase drew.  The problems
    take seed 0, as ``benchmarks/fig2_lsq.py``, ``fig1_fedsplit.py`` and
    ``tab1_softmax.py`` draw theirs from ``jax.random.key(0)``."""
    return torch.Generator(device="cuda").manual_seed(seed)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(rec, prob, eta, rho, torch, ops, ref, gen):
    dev = gen.device
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

    # the variants SCAFFOLD (off row) and FedAvg (no off) run on the arena:
    # lam=None, rho = 0, the step eta
    off = 0.1 * torch.randn(m, w, generator=gen, device=dev)
    off[:, d:] = 0
    for o in (off, None):
        got = ops.inner_loop_affine(x0, H, c, xs, None, eta, 0.0, K, off=o)
        want = ref.inner_loop_affine_ref(x0, H, c, xs, None, eta, 0.0, K, off=o)
        scale = max(1.0, float(want[0].abs().max()))
        e = max(max_err(a, b) for a, b in zip(got, want))
        check(e <= 1e-4 * scale, f"inner_loop_affine (off={o is not None}, lam=None, rho=0): "
                                 f"error {e} > 1e-4 * {scale}")
        log(f"inner_loop_affine off={o is not None} lam=None rho=0: max_abs_err {e:.3e}")

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

    # SCAFFOLD's control-variate refresh at the least-squares and softmax
    # arenas, scalar and per-client alpha
    for (mm, ww) in ((m, w), (ms_, ws)):
        ci, xk = (torch.randn(mm, ww, generator=gen, device=dev) for _ in range(2))
        cs, ss = (torch.randn(ww, generator=gen, device=dev) for _ in range(2))
        alphas = 1.0 + 40.0 * torch.rand(mm, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            for a in (1.0 / (K * eta), alphas):
                e = max_err(ops.scaffold_cv(ci.to(dt), xk.to(dt), cs.to(dt), ss.to(dt), a),
                            ref.scaffold_cv_ref(ci.to(dt), xk.to(dt), cs.to(dt), ss.to(dt), a))
                check(e == 0.0, f"scaffold_cv {dt} ({mm}, {ww}): error {e}")
    ci, xk = (torch.randn(m, w, generator=gen, device=dev) for _ in range(2))
    cs = torch.randn(w, generator=gen, device=dev)
    alpha = 1.0 / (K * eta)
    rec.kernel("scaffold_cv", 0.0,
               lambda: ops.scaffold_cv(ci, xk, cs, xs, alpha),
               lambda: ref.scaffold_cv_ref(ci, xk, cs, xs, alpha), 200,
               4 * (3 * m * w + 2 * w), 4 * m * w)

    # the per-leaf step at the Fig. 2 leaf (500, 500), the softmax arena
    # (Inexact FedSplit) and a ragged leaf (numel % 4 != 0); a full or a
    # broadcast server leaf, with and without lam, scalar and per-client step
    for shape in ((m, d), (ms_, ws), (6, 13)):
        xf, gf, lf, sf = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
        stf = torch.rand((shape[0], 1), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            for srv in (sf, sf[0].contiguous()):
                for st in (0.05, stf):
                    for lm in (lf, None):
                        args = (xf.to(dt), gf.to(dt), srv.to(dt),
                                None if lm is None else lm.to(dt), st, 4.0)
                        e = max_err(ops.fused_update(*args), ref.fused_update_ref(*args))
                        check(e == 0.0, f"fused_update {dt} {shape}: error {e}")
    # timed as GPDMM's pytree round calls it: lam, the server leaf broadcast
    xf, gf, lf = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
    sf = torch.randn(d, generator=gen, device=dev)
    rec.kernel("fused_update", 0.0,
               lambda: ops.fused_update(xf, gf, sf, lf, step, rho),
               lambda: ref.fused_update_ref(xf, gf, sf, lf, step, rho), 200,
               4 * (4 * m * d + d), 6 * m * d)
    torch.cuda.synchronize()


def same_bits(torch, got, want) -> bool:
    """Bit for bit equal (so -0.0 differs from 0.0), a NaN matching a NaN in
    the same place whatever its payload."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()):
        return False
    ity = torch.int32 if got.element_size() == 4 else torch.int16
    return torch.equal(got[~nan].view(ity), want[~nan].view(ity))


def check_cohort_kernels(rec, torch, ops, ref, gen):
    """Kernels 7-10 against their plain versions at phase 8's shapes, bitwise
    (f32 and bf16, a NaN in one client's leaf for EF21), then timed: the
    gather and scatter as phase 8's cohort round calls them (50 of 500 rows
    of W = 512), the EF21 pair at the full (500, 512) arena of run (c)."""
    from repro_torch.kernels import gather

    dev = gen.device
    sz = {torch.float32: 4, torch.bfloat16: 2}
    for m, w, mc in ((500, 512, 50), (500, 512, 250), (10, 7936, 5), (65536, 512, 656)):
        arr32 = torch.randn(m, w, generator=gen, device=dev)
        rows32 = torch.randn(mc, w, generator=gen, device=dev)
        idx = torch.sort(torch.randperm(m, generator=gen, device=dev)[:mc]).values
        for dt in (torch.float32, torch.bfloat16):
            arr, rows = arr32.to(dt), rows32.to(dt)
            for ids in (idx, idx.to(torch.int32)):
                check(torch.equal(ops.row_gather(arr, ids), ref.row_gather_ref(arr, ids)),
                      f"row_gather {dt} ({m}, {w}) mc={mc} {ids.dtype}: differs")
            before = arr.clone()
            got = ops.row_scatter(arr, idx, rows)
            check(torch.equal(arr, before), "row_scatter wrote its input")
            check(torch.equal(got, arr.index_copy(0, idx, rows)),
                  f"row_scatter {dt} ({m}, {w}) mc={mc}: differs from the plain version")
        del arr32, rows32, arr, rows, before, got
    log("row_gather / row_scatter: bitwise at (500, 512) mc 50 and 250, (10, 7936) mc 5, "
        "(65536, 512) mc 656; f32 and bf16; int64 and int32 ids")

    for (m, w), leaf_rows in (((500, 512), (4,)), ((500, 512), (3, 1)), ((10, 7936), (62,))):
        uh32 = torch.randn(m, w, generator=gen, device=dev)
        u32 = uh32 + 0.1 * torch.randn(m, w, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            u, uh = u32.to(dt), uh32.to(dt)
            u[1, 7] = float("nan")
            rm = ops.ef21_rowmax(u, uh)
            check(same_bits(torch, rm, ref.ef21_rowmax_ref(u, uh)) and int(rm.isnan().sum()) == 1,
                  f"ef21_rowmax {dt} ({m}, {w}): differs")
            for bits in (8, 4):
                sc = ops._ef21_row_scales(rm, leaf_rows, float(2 ** (bits - 1) - 1))
                check(same_bits(torch, ops.ef21_apply(u, uh, sc, bits),
                                ref.ef21_apply_ref(u, uh, sc, bits)),
                      f"ef21_apply {dt} ({m}, {w}) {leaf_rows} bits={bits}: differs")
                want = ref.ef21_apply_ref(u, uh, ops._ef21_row_scales(
                    ref.ef21_rowmax_ref(u, uh), leaf_rows, float(2 ** (bits - 1) - 1)), bits)
                check(same_bits(torch, ops.ef21_update(u, uh, bits, leaf_rows), want),
                      f"ef21_update {dt} ({m}, {w}) {leaf_rows} bits={bits}: differs")
    log("ef21_rowmax / ef21_apply: bitwise at (500, 512) leaves (4,) and (3, 1), "
        "(10, 7936) (62,); bits 8 and 4; f32 and bf16; a NaN in one client's leaf")

    m, w, mc = 500, 512, 50
    arr, rows = (torch.randn(n, w, generator=gen, device=dev) for n in (m, mc))
    idx = torch.sort(torch.randperm(m, generator=gen, device=dev)[:mc]).values
    rec.kernel("row_gather", 0.0, lambda: ops.row_gather(arr, idx),
               lambda: ref.row_gather_ref(arr, idx), 200, 2 * mc * w * 4 + 8 * mc, 0,
               library_fn=lambda: torch.index_select(arr, 0, idx))
    pos = torch.zeros(m, dtype=torch.int32, device=dev).index_copy_(
        0, idx, torch.arange(mc, dtype=torch.int32, device=dev))
    mask = torch.zeros(m, dtype=torch.int32, device=dev).index_fill_(0, idx, 1)
    rec.kernel("row_scatter", 0.0, lambda: gather.row_scatter(arr, pos, mask, rows),
               lambda: ref.row_scatter_ref(arr, pos, mask, rows), 200,
               2 * m * w * 4 + 8 * m, 0, library_fn=lambda: arr.index_copy(0, idx, rows))
    uh = torch.randn(m, w, generator=gen, device=dev)
    u = uh + 0.1 * torch.randn(m, w, generator=gen, device=dev)
    rm = ops.ef21_rowmax(u, uh)
    sc = ops._ef21_row_scales(rm, (w // 128,), 127.0)
    rec.kernel("ef21_rowmax", 0.0, lambda: ops.ef21_rowmax(u, uh),
               lambda: ref.ef21_rowmax_ref(u, uh), 200, 2 * m * w * 4 + m * w // 128 * 4,
               3 * m * w)
    rec.kernel("ef21_apply", 0.0, lambda: ops.ef21_apply(u, uh, sc, 8),
               lambda: ref.ef21_apply_ref(u, uh, sc, 8), 200,
               3 * m * w * 4 + m * w // 128 * 4, 7 * m * w)
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
# phases 4 and 5: the arena rounds at the paper's sizes
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


def expected(ops, rounds, **per_round):
    """The launch counts of ``rounds`` rounds: ``per_round`` launches of the
    named kernels per round, none of any other."""
    return {k.name: rounds * per_round.get(k.name, 0) for k in ops.KERNELS}


def lsq_phase(rec, prob, torch, ops, make, FederatedConfig, dev, prof=None):
    R, K, m = LSQ["rounds"], LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    rho = 1.0 / (K * eta)
    x0 = torch.zeros(prob.d, device=dev)
    d0 = float(prob.dist(x0))
    dists = {}
    per_round = {
        "gpdmm": dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1),
        "agpdmm": dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1),
        "scaffold": dict(inner_loop_affine=1, scaffold_cv=1),
        "fedavg": dict(inner_loop_affine=1),
    }
    for algo in per_round:
        opt = make(FederatedConfig(algorithm=algo, inner_steps=K, eta=eta, use_arena=True))
        state = opt.init(x0, m)
        trail = []
        inv = []

        def on_round(r, s, met):
            if r in (0, R // 2 - 1, R - 1):
                trail.append(float(prob.dist(s["x_s"])))
                if "lam_sum_norm" in met:
                    # invariant (25): sum_i lam_i = rho m (mean u - x_s') is
                    # zero up to the f32 rounding of the client mean, ~ rho m
                    # eps ||x_s||
                    scale = rho * m * F32_EPS * max(
                        1.0, float(torch.linalg.vector_norm(s["x_s"])))
                    inv.append(float(met["lam_sum_norm"]) / scale)
                elif "c_sum_norm" in met:
                    # SCAFFOLD: sum_i (c_i - c) = 0 up to the rounding of the
                    # f32 c-delta means, ~ m eps times a row of c_i
                    scale = m * F32_EPS * max(
                        1.0, float(torch.linalg.vector_norm(s["c_i"])) / math.sqrt(m))
                    inv.append(float(met["c_sum_norm"]) / scale)

        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, state, prob.oracle(), lambda r: prob.batch(), R, False, on_round)
        rec.add(counts)
        log(f"lsq {algo}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"||x - x*|| {d0:.4e} -> {trail}; launches {counts}; "
            f"invariant / rounding scale {[round(v, 3) for v in inv]}")
        check(counts == expected(ops, R, **per_round[algo]), f"lsq {algo}: launches {counts}")
        check(trail[-1] < trail[0] < d0, f"lsq {algo}: distance did not fall: {trail}")
        if algo in ("gpdmm", "agpdmm"):
            check(max(inv) < 16.0, f"lsq {algo}: dual-sum invariant (25) broken: {inv}")
        if algo == "scaffold":
            check(max(inv) < 64.0, f"lsq scaffold: sum_i (c_i - c) = 0 broken: {inv}")
        for k in ("x_s", "lam_s", "x_c", "c", "c_i"):
            if k in state:
                check(bool(torch.isfinite(state[k]).all()), f"lsq {algo}: {k} not finite")
        check(tuple(state["x_s"].shape) == (prob.d,), "lsq: x_s shape")
        dists[algo] = trail
        if prof is not None:
            prof(f"lsq_{algo}", lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                                   lambda r: prob.batch(), 3, False),
                 1e3 * secs / R, 3)
    log(f"lsq info: ||x - x*|| at rounds 1, {R // 2}, {R}: {dists}")


# phase 5: every algorithm at full participation, launches per round
SOFTMAX_RUNS = {
    "gpdmm": (dict(algorithm="gpdmm"),
              dict(fused_update_arena=SOFTMAX["K"], round_tail=1, dual_from_uplink=1)),
    "agpdmm": (dict(algorithm="agpdmm"),
               dict(fused_update_arena=SOFTMAX["K"], round_tail=1, dual_from_uplink=1)),
    "scaffold": (dict(algorithm="scaffold"), dict(fused_update_arena=SOFTMAX["K"], scaffold_cv=1)),
    "fedavg": (dict(algorithm="fedavg"), dict(fused_update_arena=SOFTMAX["K"])),
    "fedsplit_xs": (dict(algorithm="fedsplit", fedsplit_init="xs"),
                    dict(fused_update=SOFTMAX["K"])),
    "gpdmm_svrg": (dict(algorithm="gpdmm", variance_reduction="svrg"),
                   dict(fused_update_arena=SOFTMAX["K"], round_tail=1, dual_from_uplink=1)),
}


# ---------------------------------------------------------------------------
# phase 8: partial participation, the cohort engine and the EF21 uplink
# ---------------------------------------------------------------------------

# launches per round, read off the rounds' code: the cohort rounds gather
# the cohort's state rows and scatter them back, EF21 adds its two kernels
# and, on the cohort, the gather of the cached u_hat rows; the masked round
# selects with torch.where
PARTICIPATION_RUNS = {
    "a_gpdmm": (dict(algorithm="gpdmm", participation=0.1),
                dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=2,
                     row_scatter=2)),
    "a_agpdmm": (dict(algorithm="agpdmm", participation=0.1),
                 dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=1,
                      row_scatter=1)),
    "a_scaffold": (dict(algorithm="scaffold", participation=0.1),
                   dict(inner_loop_affine=1, scaffold_cv=1, row_gather=1, row_scatter=1)),
    "a_fedavg": (dict(algorithm="fedavg", participation=0.1),
                 dict(inner_loop_affine=1, row_scatter=1)),
    "b_gpdmm": (dict(algorithm="gpdmm", participation=0.1, uplink_bits=8),
                dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=3,
                     row_scatter=2, ef21_rowmax=1, ef21_apply=1)),
    "b_agpdmm": (dict(algorithm="agpdmm", participation=0.1, uplink_bits=8),
                 dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=2,
                      row_scatter=1, ef21_rowmax=1, ef21_apply=1)),
    "b_fedavg": (dict(algorithm="fedavg", participation=0.1, uplink_bits=8),
                 dict(inner_loop_affine=1, row_gather=1, row_scatter=1, ef21_rowmax=1,
                      ef21_apply=1)),
    "c_gpdmm": (dict(algorithm="gpdmm", uplink_bits=8),
                dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, ef21_rowmax=1,
                     ef21_apply=1)),
    "d_gpdmm": (dict(algorithm="gpdmm", participation=0.1, cohort=False),
                dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1)),
}
# the same at the Fig. 2 size on the default config (the per-leaf pytree
# path at W = 512, the plain grad): the tail is plain torch ops, so only the
# K fused_update steps launch a kernel
PARTICIPATION_PYTREE_RUNS = {
    "pytree_gpdmm": (dict(algorithm="gpdmm", participation=0.1),
                     dict(fused_update=LSQ["K"])),
    "pytree_gpdmm_ef21": (dict(algorithm="gpdmm", participation=0.1, uplink_bits=8),
                          dict(fused_update=LSQ["K"])),
}
# softmax at the Table I size, participation 0.5 (5 of 10) with 8-bit EF21
SOFTMAX_PARTIAL = {
    "gpdmm_p50_ef21": (dict(algorithm="gpdmm", participation=0.5, uplink_bits=8),
                       dict(fused_update_arena=SOFTMAX["K"], round_tail=1, dual_from_uplink=1,
                            row_gather=3, row_scatter=2, ef21_rowmax=1, ef21_apply=1)),
    "fedavg_p50_ef21": (dict(algorithm="fedavg", participation=0.5, uplink_bits=8),
                        dict(fused_update_arena=SOFTMAX["K"], row_gather=1, row_scatter=1,
                             ef21_rowmax=1, ef21_apply=1)),
}


def invariants(torch, met, state, rho, m):
    """The invariant of a round over its rounding scale: (25) for
    GPDMM/AGPDMM, sum_i (c_i - c) = 0 for SCAFFOLD (phase 4's scales); None
    for FedAvg."""
    if "lam_sum_norm" in met:
        scale = rho * m * F32_EPS * max(1.0, float(torch.linalg.vector_norm(state["x_s"])))
        return float(met["lam_sum_norm"]) / scale
    if "c_sum_norm" in met:
        scale = m * F32_EPS * max(1.0, float(torch.linalg.vector_norm(state["c_i"]))
                                  / math.sqrt(m))
        return float(met["c_sum_norm"]) / scale
    return None


def participation_phase(rec, prob, torch, ops, make, FederatedConfig, dev, out, prof=None):
    R, K, m = LSQ["rounds"], LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    rho = 1.0 / (K * eta)
    x0 = torch.zeros(prob.d, device=dev)
    d0 = float(prob.dist(x0))
    t_phase = time.perf_counter()
    # the first participation draw of a process loads torch's integer and
    # sort kernels; draw once before the timed runs, as phase 3 warms the
    # kernels before phase 4
    from repro_torch.core import gpdmm

    cfg, st = (FederatedConfig(participation=0.1),
               {"round": torch.zeros((), dtype=torch.int32, device=dev)})
    gpdmm.round_cohort(cfg, st, m)
    torch.cuda.synchronize()
    log(f"participation: warm-up draw {time.perf_counter() - t_phase:.3f} s")
    # the draw alone (threefry2x32 fold_in, split, bits, sort): as the host
    # enqueues it, and on the device with the stream pre-filled; one draw
    # per timing there (about 560 launches), since many more than the
    # stream's queue of pending launches would let the host set the pace
    draw_host = cuda_time_ms(lambda: gpdmm.round_cohort(cfg, st, m), 20, prefill=False)
    draw_dev = sum(cuda_time_ms(lambda: gpdmm.round_cohort(cfg, st, m), 1, warmup=1,
                                spin_cycles=40_000_000) for _ in range(5)) / 5
    out["participation_draw_ms"] = {"host_paced": draw_host, "device": draw_dev}
    log(f"participation draw (m = {m}, cohort 50): {draw_host:.4f} ms host-paced, "
        f"{draw_dev:.4f} ms on the device")
    trails = {}
    for label, (kw, per_round) in (PARTICIPATION_RUNS | PARTICIPATION_PYTREE_RUNS).items():
        pytree = label in PARTICIPATION_PYTREE_RUNS
        opt = make(FederatedConfig(inner_steps=K, eta=eta, **kw) if pytree else
                   FederatedConfig(inner_steps=K, eta=eta, use_arena=True, **kw))
        states, trail, inv = [], [], []

        def on_round(r, s, met):
            if label in ("a_gpdmm", "d_gpdmm"):
                states.append(s)
            if r in (0, R // 2 - 1, R - 1):
                trail.append(float(prob.dist(s["x_s"])))
                v = invariants(torch, met, s, rho, m)
                if v is not None:
                    inv.append(v)

        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, opt.init(x0, m), prob.grad if pytree else prob.oracle(),
            lambda r: prob.batch(), R, False, on_round)
        rec.add(counts)
        check(float(metrics["used_arena"]) == (0.0 if pytree else 1.0),
              f"participation {label}: took the wrong path")
        out[f"participation_{label}_ms_per_round"] = 1e3 * secs / R
        log(f"participation {label}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} "
            f"ms/round); ||x - x*|| {d0:.4e} -> {trail}; launches {counts}; "
            f"invariant / rounding scale {[round(v, 3) for v in inv]}")
        check(counts == expected(ops, R, **per_round), f"participation {label}: launches {counts}")
        check(trail[-1] < trail[0] < d0, f"participation {label}: distance did not fall: {trail}")
        if kw["algorithm"] in ("gpdmm", "agpdmm"):
            check(max(inv) < 16.0, f"participation {label}: invariant (25) broken: {inv}")
        if kw["algorithm"] == "scaffold":
            check(max(inv) < 64.0, f"participation {label}: sum_i (c_i - c) = 0 broken: {inv}")
        for k, v in state.items():
            if k != "round":
                check(bool(torch.isfinite(v).all()), f"participation {label}: {k} not finite")
        trails[label] = states
        if prof is not None and label in ("a_gpdmm", "b_gpdmm"):
            prof(f"participation_{label}",
                 lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                    lambda r: prob.batch(), 3, False),
                 1e3 * secs / R, 3)

    # the masked full-population round (d) against the cohort round (a),
    # round by round: the reference's contract (tests/test_cohort.py)
    worst = 0.0
    for r, (sa, sd) in enumerate(zip(trails["a_gpdmm"], trails["d_gpdmm"])):
        for k in ("x_s", "lam_s", "x_c", "u_hat"):
            scale = max(1.0, float(sd[k].abs().max()))
            err = float((sa[k] - sd[k]).abs().max()) / scale
            worst = max(worst, err)
            check(err <= 1e-5, f"participation: cohort != masked at round {r}: {k} {err}")
    out["participation_cohort_vs_masked_max_rel_err"] = worst
    log(f"participation: cohort (a) == masked (d) for x_s, lam_s, x_c, u_hat over {R} rounds "
        f"(max relative error {worst:.3e}, bound 1e-5)")
    del trails
    log(f"participation phase (least squares): {time.perf_counter() - t_phase:.2f} s")


def mixture_data(torch, gen, F, C, n, dev):
    """One class per client, n samples each: class means of norm ~ sqrt(F)
    * 0.12 plus unit noise, scaled by 1/10 (the Table I set-up)."""
    means = 0.12 * torch.randn(C, F, generator=gen, device=dev)
    x = (means[:, None, :] + torch.randn(C, n, F, generator=gen, device=dev)) / 10.0
    y = torch.arange(C, device=dev, dtype=torch.int32)[:, None].expand(C, n).contiguous()
    return x, y


def softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, gen, dev, runs,
                  prof=None):
    """Softmax regression at the Table I size over ``runs`` (label ->
    (config keywords, launches per round)): ``SOFTMAX_RUNS`` in phase 5,
    ``SOFTMAX_PARTIAL`` in phase 8."""
    F, C, m, B, K, R, n = (SOFTMAX[k] for k in ("F", "C", "m", "B", "K", "rounds", "n"))
    prob = SoftmaxRegression(F, C)
    xs, ys = mixture_data(torch, gen, F, C, n, dev)
    pool = {"x": xs.reshape(-1, F), "y": ys.reshape(-1)}

    def batch_of(r):
        starts = [((r * K + k) * B) % (n - B + 1) for k in range(K)]
        return {"x": torch.stack([xs[:, s:s + B] for s in starts]),
                "y": torch.stack([ys[:, s:s + B] for s in starts])}

    for label, (kw, per_round) in runs.items():
        # the default use_arena="auto" takes the arena here: W = 7936 >= 1024
        opt = make(FederatedConfig(inner_steps=K, eta=0.05, **kw))
        state = opt.init(prob.init_params(dev), m)
        loss0 = float(prob.loss(opt.server_params(state), pool))
        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, state, prob.oracle(), batch_of, R, True)
        w = opt.server_params(state)
        loss1, acc = float(prob.loss(w, pool)), float(prob.accuracy(w, pool["x"], pool["y"]))
        rec.add(counts)
        log(f"softmax {label}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"loss {loss0:.4f} -> {loss1:.4f}, train accuracy {acc:.3f}; launches {counts}")
        check(counts == expected(ops, R, **per_round), f"softmax {label}: launches {counts}")
        check(math.isfinite(loss1) and loss1 < loss0, f"softmax {label}: loss {loss0} -> {loss1}")
        for k in ("lam_s", "c_i", "z_s", "u_hat", "x_c"):
            if k in state:
                check(bool(torch.isfinite(state[k]).all()), f"softmax {label}: {k} not finite")
        if prof is not None:
            prof(f"softmax_{label}", lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                                        batch_of, 3, True),
                 1e3 * secs / R, 3)


# ---------------------------------------------------------------------------
# phases 6 and 7: the paper's Fig. 2 and Fig. 1 on the per-leaf path
# ---------------------------------------------------------------------------

def fig2_phase(rec, problems, torch, ops, make, FederatedConfig, dev, prof=None):
    """``benchmarks/fig2_lsq.py`` on the port: the default config, so the
    per-leaf pytree path at W = 512, with the plain grad."""
    R = FIG2["rounds"]
    cp = max(1, R // 4)
    t_phase = time.perf_counter()
    for (m, n, Ks) in FIG2["settings"]:
        prob = problems[m]
        eta = 0.5 / prob.L
        x0 = torch.zeros(prob.d, device=dev)
        d_cp, d_end, traj = {}, {}, {}
        for K in Ks:
            for method in FIG2["methods"]:
                opt = make(FederatedConfig(algorithm=method, inner_steps=K, eta=eta))
                xs_trail = []

                def on_round(r, s, met):
                    if K == 1:
                        xs_trail.append(s["x_s"])
                    if r + 1 == cp:
                        d_cp[(K, method)] = float(prob.dist(s["x_s"]))

                state, metrics, counts, secs = run_rounds(
                    torch, ops, opt, opt.init(x0, m), prob.grad, lambda r: prob.batch(), R,
                    False, on_round)
                rec.add(counts)
                x = opt.server_params(state)
                d_end[(K, method)] = float(prob.dist(x))
                if K == 1:
                    traj[method] = torch.stack(xs_trail)
                log(f"fig2 m={m} K={K} {method}: {R} rounds in {secs:.3f} s "
                    f"({1e3 * secs / R:.3f} ms/round); ||x - x*|| at round {cp} "
                    f"{d_cp[(K, method)]:.4e}, at {R} {d_end[(K, method)]:.4e}; "
                    f"used_arena {float(metrics['used_arena'])}; launches {counts}")
                check(counts == expected(ops, R, fused_update=K),
                      f"fig2 m={m} K={K} {method}: launches {counts}")
                check(float(metrics["used_arena"]) == 0.0, "fig2: left the pytree path")
                check(bool(torch.isfinite(x).all()), f"fig2 m={m} K={K} {method}: not finite")
                if prof is not None and K == 5 and method == "agpdmm":
                    prof(f"fig2_m{m}_agpdmm_K5",
                         lambda: run_rounds(torch, ops, opt, state, prob.grad,
                                            lambda r: prob.batch(), 3, False),
                         1e3 * secs / R, 3)
        # the benchmark's claims (fig2_lsq.py:66-71), for K > 1
        for K in Ks:
            if K > 1:
                check(d_cp[(K, "agpdmm")] <= 1.05 * d_cp[(K, "gpdmm")],
                      f"fig2 m={m} K={K}: AGPDMM {d_cp[(K, 'agpdmm')]} > 1.05 x GPDMM "
                      f"{d_cp[(K, 'gpdmm')]} at round {cp}")
                check(d_end[(K, "fedavg")] > 10 * d_end[(K, "agpdmm")],
                      f"fig2 m={m} K={K}: FedAvg {d_end[(K, 'fedavg')]} not above 10 x "
                      f"AGPDMM {d_end[(K, 'agpdmm')]}")
        # K = 1: AGPDMM == SCAFFOLD == FedAvg, round by round (paper (27)/(31))
        for method in ("scaffold", "fedavg"):
            err = float((traj[method] - traj["agpdmm"]).abs().max())
            log(f"fig2 m={m} K=1: max |x_s({method}) - x_s(agpdmm)| over {R} rounds {err:.3e}")
            torch.testing.assert_close(traj[method], traj["agpdmm"], rtol=1e-4, atol=1e-4)
    log(f"fig2 phase: {time.perf_counter() - t_phase:.2f} s")


def gap_f64(torch, prob, x) -> float:
    """F(x) - F(x*) in float64: the f32 ``prob.gap`` of the benchmark is
    rounding noise of O(10) at m = 25, n = 5000 (F ~ 3e7), this is not."""
    f64 = torch.float64
    H, g = prob.AtA.to(f64).sum(0), prob.Atb.to(f64).sum(0)

    def F(v):
        v = v.to(f64)
        return 0.5 * v @ H @ v - g @ v

    return float(F(x) - F(prob.x_star))


def fig1_phase(rec, prob, torch, ops, make, FederatedConfig, dev):
    """``benchmarks/fig1_fedsplit.py`` on the port: Inexact FedSplit, the
    improper z init against the x_s init."""
    R = FIG1["rounds"]
    t_phase = time.perf_counter()
    gaps, gaps64 = {}, {}
    for init in FIG1["inits"]:
        for K in FIG1["Ks"]:
            opt = make(FederatedConfig(algorithm="fedsplit", inner_steps=K, eta=1.0 / prob.L,
                                       fedsplit_init=init, rho=prob.L / 10.0))
            state, metrics, counts, secs = run_rounds(
                torch, ops, opt, opt.init(torch.zeros(prob.d, device=dev), prob.m),
                prob.grad, lambda r: prob.batch(), R, False)
            rec.add(counts)
            x = opt.server_params(state)
            gaps[(init, K)] = float(prob.gap(x))
            gaps64[(init, K)] = gap_f64(torch, prob, x)
            log(f"fig1 init={init} K={K}: {R} rounds in {secs:.3f} s "
                f"({1e3 * secs / R:.3f} ms/round); gap {gaps[(init, K)]:.4e} (f32), "
                f"{gaps64[(init, K)]:.4e} (f64); ||x - x*|| {float(prob.dist(x)):.4e}; "
                f"launches {counts}")
            check(counts == expected(ops, R, fused_update=K),
                  f"fig1 init={init} K={K}: launches {counts}")
    for K in FIG1["Ks"]:
        check(gaps[("xs", K)] < 1e-3 * max(gaps[("z", K)], 1e-12),
              f"fig1 K={K}: x_s init gap {gaps[('xs', K)]} not below 1e-3 x z init gap "
              f"{gaps[('z', K)]}")
        check(gaps64[("xs", K)] < 1e-3 * gaps64[("z", K)],
              f"fig1 K={K}: x_s init f64 gap {gaps64[('xs', K)]} not below 1e-3 x z init "
              f"f64 gap {gaps64[('z', K)]}")
    log(f"fig1 phase: {time.perf_counter() - t_phase:.2f} s")


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
    t0 = time.perf_counter()
    prob = quadratic.generate(seeded(torch, 0), m=LSQ["m"], n=LSQ["n"], d=LSQ["d"],
                              device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"least squares m={LSQ['m']} n={LSQ['n']} d={LSQ['d']}: set-up (draw, Gram, "
        f"batched eigh, solve) {setup_s:.2f} s; L {prob.L:.4e} mu {prob.mu:.4e}")
    out["lsq_setup_s"] = setup_s

    eta = 0.5 / prob.L
    check_kernels(rec, prob, eta, 1.0 / (LSQ["K"] * eta), torch, ops, ref, seeded(torch, 3))
    check_cohort_kernels(rec, torch, ops, ref, seeded(torch, 13))
    check_small_against_cpu(torch, make, FederatedConfig, quadratic)

    dev = torch.device("cuda")
    prof = None
    if args.profile:
        def prof(label, run, round_ms, rounds):
            profile_rounds(torch, label, run, round_ms, rounds, out)
    lsq_phase(rec, prob, torch, ops, make, FederatedConfig, dev, prof)
    softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, seeded(torch, 0),
                  dev, SOFTMAX_RUNS, prof)

    t0 = time.perf_counter()
    prob25 = quadratic.generate(seeded(torch, 0), m=FIG1["m"], n=FIG1["n"], d=LSQ["d"],
                                device="cuda")
    torch.cuda.synchronize()
    log(f"least squares m={FIG1['m']} n={FIG1['n']} d={LSQ['d']}: set-up "
        f"{time.perf_counter() - t0:.2f} s; L {prob25.L:.4e} mu {prob25.mu:.4e}")
    fig2_phase(rec, {LSQ["m"]: prob, FIG1["m"]: prob25}, torch, ops, make, FederatedConfig,
               dev, prof)
    fig1_phase(rec, prob25, torch, ops, make, FederatedConfig, dev)
    participation_phase(rec, prob, torch, ops, make, FederatedConfig, dev, out, prof)
    softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, seeded(torch, 0),
                  dev, SOFTMAX_PARTIAL, prof)

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
