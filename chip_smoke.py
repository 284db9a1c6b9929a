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
  9. faults, uplink screening and async rounds, with the reference
     benchmark's configs (``benchmarks/round_bench.py:647-652, 733-737``):
     (a) phase 4's problem, 30 rounds of GPDMM, AGPDMM, SCAFFOLD and FedAvg
     with 10% dropout and 5% corruption, screened: finite, descending,
     invariants as phase 4, every NaN or Inf row demoted each round; (b)
     GPDMM at participation 0.1 through the cohort engine, screened, and
     with finite-only screening (``screen_mult=0``, the blow-up scaled by
     1) equal to the masked round state by state (rtol 1e-5); (c) async rounds (30% delay) at
     ``max_staleness`` 0, 2 and 4, GPDMM on the arena and the pytree path,
     AGPDMM, FedAvg and SCAFFOLD on the arena at 2: ``max_staleness=0``
     equals the synchronous run bitwise round by round, at 4 rows buffer
     and are admitted and none dropped; (d) the reference's acceptance
     rules at m = 8, n = 60, d = 24 (screened within 10% and stale within
     15% of the descent scale of the clean run); (e) the ``lm_flat`` shape
     (m = 8, one 2^20 leaf, K = 4), screened and async; (f) the fault plan
     drawn on the card equals the CPU's over 30 rounds of each config; the
     launches per round are as derived from the code;
 10. graph-PDMM over general topologies and auto-tuned stepsizes with the
     residual early exit: (a) ``residual_norm`` at (500, 512), (8, 2^20)
     and (5, 130), f32 and bf16, a NaN row included, to rtol
     1e-6 sqrt(W / 128) and the same from run to run; ``neighbor_reduce``
     and ``edge_flip`` (masked and unmasked) bitwise their plain versions on
     ring, star, complete, torus and er at m = 8, W = 2^20 (lm_flat),
     m = 500, W = 512 (Fig. 2) and m = 8, W = 128 (the ring example), f32
     and bf16; each timed with its bound, its plain version and
     (``neighbor_reduce``) ``torch.sparse.mm``, ``edge_flip`` unmasked and
     under a colour phase's mask; (b)
     ``gpdmm_graph`` on star, ring and complete at lm_flat (the reference
     benchmark's bench_topology rows), launches per colour phase as the code
     gives them; (c) the star graph against the centralised arena GPDMM on
     phase 4's problem, 30 rounds, x_s and the carry within atol = rtol =
     1e-4; (d) ``examples/ring_pdmm.py``'s setting, every node within 1e-2
     of x*; (e) ``eta="auto"`` resolved on phase 4's problem, L_i within
     rtol 1e-5 of the CPU's, then the reference's autotune bench at lm_flat
     (a_i log-spaced 0.1-3.16, tol 1e-5, at most 600 rounds, rho = 1/(K
     eta_hand)) through ``make_scan_rounds`` and ``EarlyExit``: auto
     reaches tol in fewer rounds than the hand-tuned eta, and the early-exit
     state equals the fixed-budget run's at that round;
 11. print one JSON line of per-kernel numbers, then the result line
     ``{"ok": true, "device": {...}}`` last.

Phase 3 also holds the cohort kernels (``row_gather``, ``row_scatter``)
and the EF21 kernels (``ef21_rowmax``, ``ef21_apply``) bitwise against
their plain versions (f32 and bf16, a NaN included), ``stale_mix``
bitwise and ``screen_uplink`` (finite flags exactly, sums to rtol
1e-6 * sqrt(W / 128)) at (500, 512), (50, 512), (8, 2^20) and (5, 130),
f32 and bf16, broadcast and per-row, with NaN and Inf rows, and times the
one PyTorch call that computes the same function where there is one
(``index_select``, ``index_copy``).

Launch counts are set to 0 just before each run of the main path (phases
3-10) and read just after it; the launches of the kernel comparisons (phases 3
 and 10 (a)) do not
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
# kernels 11-12 are checked at the arena, the cohort, lm_flat and a ragged width
FAULT_SHAPES = ((500, 512), (50, 512), (8, 1 << 20), (5, 130))


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


def fault_inputs(torch, gen, m, w, dtype, per_row):
    """Uplink, reference row (or rows), stale buffer and the per-client
    scalars for kernels 11-12: a NaN row, an Inf row, an Inf entry, a
    blown-up row; w = 0 over a NaN and an Inf buffered row, w > 0 on the
    odd rows; fresh and store patterns."""
    dev = gen.device
    u = torch.randn(m, w, generator=gen, device=dev)
    u[1 % m] = float("nan")
    u[2 % m, w // 3] = float("inf")
    u[(m - 1)] = -float("inf")
    u[3 % m] *= 1e4
    other = torch.randn((m, w) if per_row else (w,), generator=gen, device=dev)
    buf = torch.randn(m, w, generator=gen, device=dev)
    buf[0] = float("nan")
    buf[2 % m] = float("inf")
    ar = torch.arange(m, device=dev)
    fresh, store = ar % 2 == 0, ar % 3 == 0
    wt = torch.where(ar % 2 == 1, 0.5 ** (1 + ar % 3).float(),
                     torch.zeros((), device=dev))
    return u.to(dtype), other.to(dtype), buf.to(dtype), fresh, store, wt


def check_fault_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 11-12 against their plain versions at FAULT_SHAPES, f32 and
    bf16, a broadcast and a per-row reference row (cache): ``stale_mix``
    bitwise, ``screen_uplink``'s finite flags exactly and its sums to rtol
    1e-6 sqrt(W / 128) (its own fixed order, not torch.sum's), the same
    from run to run.  Then each is timed at every f32 shape: the JSON row
    holds the main path's, (500, 512) with the server row as ``ref`` for the
    screen and the (m, W) u_hat cache for the mix."""
    worst = 0.0
    for (m, w) in FAULT_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for per_row in (False, True):
                u, other, buf, fresh, store, wt = fault_inputs(torch, gen, m, w, dt, per_row)
                fin, sq = ops.screen_uplink(u, other)
                fin_p, sq_p = ref.screen_uplink_ref(u, other)
                rtol = 1e-6 * math.sqrt(w / 128)
                rel = float(((sq - sq_p).abs() / sq_p.abs().clamp(min=1e-30)).max())
                worst = max(worst, rel / rtol)
                check(torch.equal(fin, fin_p), f"screen_uplink {dt} ({m}, {w}) per_row={per_row}: "
                                               f"finite flags differ")
                check(rel <= rtol, f"screen_uplink {dt} ({m}, {w}) per_row={per_row}: relative "
                                   f"error {rel} > {rtol}")
                fin2, sq2 = ops.screen_uplink(u, other)
                check(torch.equal(fin2, fin) and torch.equal(sq2, sq),
                      f"screen_uplink {dt} ({m}, {w}): differs from run to run")
                got = ops.stale_mix(u, other, buf, fresh, store, wt)
                want = ref.stale_mix_ref(u, other, buf, fresh, store, wt)
                check(all(same_bits(torch, a, b) for a, b in zip(got, want)),
                      f"stale_mix {dt} ({m}, {w}) per_row={per_row}: differs")
                del u, other, buf, got, want
    out["screen_uplink_worst_rel_err_over_rtol"] = worst
    log(f"screen_uplink: finite exact, sums within {worst:.3f} of rtol 1e-6 sqrt(W / 128); "
        f"stale_mix bitwise; at {list(FAULT_SHAPES)}, f32 and bf16, broadcast and per-row")

    times = []
    for (m, w) in FAULT_SHAPES:
        for per_row in (False, True):
            u, other, buf, fresh, store, wt = fault_inputs(torch, gen, m, w, torch.float32,
                                                           per_row)
            u = torch.where(torch.isfinite(u), u, 0.0)  # timed on finite rows
            iters = 200 if m * w < 1 << 22 else 50
            nb_ref = 4 * (m * w if per_row else w)
            sc_bytes = 4 * m * w + nb_ref + 5 * m
            mx_bytes = 4 * 4 * m * w + nb_ref + 6 * m
            row = {"shape": [m, w], "per_row": per_row}
            for name, fn, plain, nbytes in (
                    ("screen_uplink", lambda: ops.screen_uplink(u, other),
                     lambda: ref.screen_uplink_ref(u, other), sc_bytes),
                    ("stale_mix", lambda: ops.stale_mix(u, other, buf, fresh, store, wt),
                     lambda: ref.stale_mix_ref(u, other, buf, fresh, store, wt), mx_bytes)):
                b, _ = bound_ms(nbytes, 3 * m * w)
                if (m, w) == (500, 512) and per_row == (name == "stale_mix"):  # the main path's
                    err = (max_err(fn()[1], plain()[1]) if name == "screen_uplink" else 0.0)
                    rec.kernel(name, err, fn, plain, iters, nbytes, 3 * m * w)
                    r = rec.rows[name]
                    k_ms, p_ms, host_ms = r["ms"], r["plain_ms"], r["enqueue_ms"]
                else:
                    k_ms, p_ms = cuda_time_ms(fn, iters), cuda_time_ms(plain, iters)
                    host_ms = cuda_time_ms(fn, iters, prefill=False)
                row[name] = {"ms": k_ms, "plain_ms": p_ms, "host_paced_ms": host_ms,
                             "bound_ms": b}
                log(f"{name} ({m}, {w}) {'per-row' if per_row else 'broadcast'}: {k_ms:.4f} ms "
                    f"(bound {b:.4f} ms, {b / k_ms:.2f} of it), plain {p_ms:.4f} ms, "
                    f"host-paced {host_ms:.4f} ms")
            times.append(row)
            del u, other, buf
    out["fault_kernel_times"] = times
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


# ---------------------------------------------------------------------------
# phase 9: faults, uplink screening and bounded-staleness async rounds
# ---------------------------------------------------------------------------

# the reference benchmark's robustness configs (benchmarks/round_bench.py:647-652
# and 733-737)
SCREENED = dict(faults=dict(dropout=0.1, corrupt=0.05, seed=7), screen=True)
DELAYED = dict(faults=dict(delay=0.3, seed=9), async_rounds=True)
# finite-only screening (the outlier rule off) for cohort == masked: the
# cohort takes the rule's median over the cohort, the masked round over the
# population (ROADMAP.md section 3).  Finite flags let the blow-up class
# through, and 1e6 times a row drives the state to inf within two rounds,
# so these runs keep every class but scale the blow-up by 1 (a sign flip and
# an honest copy pass; the NaN and Inf rows are demoted)
FINITE_ONLY = dict(faults=dict(dropout=0.1, corrupt=0.05, seed=7, blowup=1.0), screen=True,
                   screen_mult=0.0)
ARENA_TAIL = dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1)
# launches per round, read off the rounds' code: every screened arena round
# screens once (screen="auto" screens a delay-only schedule too), every
# async arena round mixes once, the cohort gathers the cached u_hat rows
# for its keep select besides its lam and carry rows; the pytree path
# screens and mixes as plain tensor code
FAULT_RUNS = {
    "a_gpdmm": (dict(algorithm="gpdmm", **SCREENED), ARENA_TAIL | dict(screen_uplink=1)),
    "a_agpdmm": (dict(algorithm="agpdmm", **SCREENED), ARENA_TAIL | dict(screen_uplink=1)),
    "a_scaffold": (dict(algorithm="scaffold", **SCREENED),
                   dict(inner_loop_affine=1, scaffold_cv=1, screen_uplink=1)),
    "a_fedavg": (dict(algorithm="fedavg", **SCREENED), dict(inner_loop_affine=1, screen_uplink=1)),
    "b_gpdmm": (dict(algorithm="gpdmm", participation=0.1, **SCREENED),
                ARENA_TAIL | dict(screen_uplink=1, row_gather=3, row_scatter=2)),
    "b_gpdmm_finite": (dict(algorithm="gpdmm", participation=0.1, **FINITE_ONLY),
                       ARENA_TAIL | dict(screen_uplink=1, row_gather=3, row_scatter=2)),
    "b_gpdmm_finite_masked": (dict(algorithm="gpdmm", participation=0.1, cohort=False,
                                   **FINITE_ONLY), ARENA_TAIL | dict(screen_uplink=1)),
    "c_gpdmm_sync": (dict(algorithm="gpdmm", faults=DELAYED["faults"], async_rounds=False),
                     ARENA_TAIL | dict(screen_uplink=1)),
    "c_gpdmm_ms0": (dict(algorithm="gpdmm", max_staleness=0, **DELAYED),
                    ARENA_TAIL | dict(screen_uplink=1, stale_mix=1)),
    "c_gpdmm_ms2": (dict(algorithm="gpdmm", max_staleness=2, **DELAYED),
                    ARENA_TAIL | dict(screen_uplink=1, stale_mix=1)),
    "c_gpdmm_ms4": (dict(algorithm="gpdmm", max_staleness=4, **DELAYED),
                    ARENA_TAIL | dict(screen_uplink=1, stale_mix=1)),
    "c_agpdmm_ms2": (dict(algorithm="agpdmm", max_staleness=2, **DELAYED),
                     ARENA_TAIL | dict(screen_uplink=1, stale_mix=1)),
    "c_fedavg_ms2": (dict(algorithm="fedavg", max_staleness=2, **DELAYED),
                     dict(inner_loop_affine=1, screen_uplink=1, stale_mix=1)),
    "c_scaffold_ms2": (dict(algorithm="scaffold", max_staleness=2, **DELAYED),
                       dict(inner_loop_affine=1, scaffold_cv=1, screen_uplink=1, stale_mix=1)),
}
FAULT_PYTREE_RUNS = {
    "c_pytree_sync": (dict(algorithm="gpdmm", faults=DELAYED["faults"], async_rounds=False),
                      dict(fused_update=LSQ["K"])),
    "c_pytree_ms0": (dict(algorithm="gpdmm", max_staleness=0, **DELAYED),
                     dict(fused_update=LSQ["K"])),
    "c_pytree_ms2": (dict(algorithm="gpdmm", max_staleness=2, **DELAYED),
                     dict(fused_update=LSQ["K"])),
    "c_pytree_ms4": (dict(algorithm="gpdmm", max_staleness=4, **DELAYED),
                     dict(fused_update=LSQ["K"])),
}
STALE_KEYS = ("stale_buf", "stale_age", "stale_lat")
# the runs whose states are compared round by round
PAIRED = ("b_gpdmm_finite", "b_gpdmm_finite_masked", "c_gpdmm_sync", "c_gpdmm_ms0",
          "c_pytree_sync", "c_pytree_ms0")
# the reference's acceptance rules (tests/test_faults.py:332,
# tests/test_staleness.py:371) and lm_flat (benchmarks/round_bench.py:61, 108-115)
ACCEPT = dict(m=8, n=60, d=24, K=3, rounds=40)
LM_FLAT = dict(m=8, width=1 << 20, K=4, eta=0.1, rounds=10)


def fault_cfg(FederatedConfig, FaultConfig, kw, **base):
    kw = dict(kw)
    return FederatedConfig(faults=FaultConfig(**kw.pop("faults")), **base, **kw)


def faults_phase(rec, prob, torch, ops, make, FederatedConfig, FaultConfig, quadratic, gen,
                 dev, out, prof=None):
    from repro_torch.core import faults, gpdmm
    from repro_torch.core import tree_util as T
    from repro_torch.core.api import make_oracle

    R, K, m = LSQ["rounds"], LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    rho = 1.0 / (K * eta)
    x0 = torch.zeros(prob.d, device=dev)
    d0 = float(prob.dist(x0))
    t_phase = time.perf_counter()
    i32 = torch.int32

    # the fault plan alone, as the host enqueues it and on the device
    for label, kw in (("screened", SCREENED), ("async", DELAYED | dict(max_staleness=2))):
        cfg = fault_cfg(FederatedConfig, FaultConfig, kw, inner_steps=K, eta=eta)
        r0 = torch.zeros((), dtype=i32, device=dev)
        host = cuda_time_ms(lambda: faults.plan(cfg, r0, m), 20, prefill=False)
        devt = sum(cuda_time_ms(lambda: faults.plan(cfg, r0, m), 1, warmup=1,
                                spin_cycles=40_000_000) for _ in range(5)) / 5
        out[f"fault_plan_{label}_ms"] = {"host_paced": host, "device": devt}
        log(f"fault plan ({label}, m = {m}): {host:.4f} ms host-paced, {devt:.4f} ms on the "
            f"device")

    runs = {}
    for label, (kw, per_round) in (FAULT_RUNS | FAULT_PYTREE_RUNS).items():
        pytree = label in FAULT_PYTREE_RUNS
        base = dict(inner_steps=K, eta=eta) | ({} if pytree else dict(use_arena=True))
        cfg = fault_cfg(FederatedConfig, FaultConfig, kw, **base)
        opt = make(cfg)
        states, mets, finite, trail, inv = [], [], [], [], []

        def on_round(r, s, met):
            if label in PAIRED:
                states.append(s)
            mets.append(met)
            finite.append(torch.isfinite(s["x_s"]).all())
            if r in (0, R // 2 - 1, R - 1):
                trail.append(float(prob.dist(s["x_s"])))
                v = invariants(torch, met, s, rho, m)
                if v is not None:
                    inv.append(v)

        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, opt.init(x0, m), prob.grad if pytree else prob.oracle(),
            lambda r: prob.batch(), R, False, on_round)
        rec.add(counts)
        tot = {k: sum(float(mt[k]) for mt in mets) for k in mets[0]
               if k.startswith(("faults_", "stale_"))}
        out[f"faults_{label}_ms_per_round"] = 1e3 * secs / R
        log(f"faults {label}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"||x - x*|| {d0:.4e} -> {trail}; launches {counts}; invariant / rounding scale "
            f"{[round(v, 3) for v in inv]}; totals {tot}")
        check(float(metrics["used_arena"]) == (0.0 if pytree else 1.0),
              f"faults {label}: took the wrong path")
        check(counts == expected(ops, R, **per_round), f"faults {label}: launches {counts}")
        check(all(bool(f) for f in finite), f"faults {label}: x_s not finite in some round")
        check(trail[-1] < trail[0] < d0, f"faults {label}: distance did not fall: {trail}")
        if kw["algorithm"] in ("gpdmm", "agpdmm"):
            check(max(inv) < 16.0, f"faults {label}: invariant (25) broken: {inv}")
        if kw["algorithm"] == "scaffold":
            check(max(inv) < 64.0, f"faults {label}: sum_i (c_i - c) = 0 broken: {inv}")
        for k, v in state.items():
            if k != "round":
                check(bool(torch.isfinite(v.float()).all()), f"faults {label}: {k} not finite")
        if label.startswith("a_") or label == "b_gpdmm":
            # every NaN or Inf row on the wire was demoted: x_s stayed
            # finite, and the screen silenced at least that many each round
            for r, mt in enumerate(mets):
                rnd = {"round": torch.tensor(r, dtype=i32, device=dev)}
                p = faults.plan(cfg, rnd["round"], m)
                bad = p.corrupt & (p.kind < 2)
                if label == "b_gpdmm":  # the cohort's rows only were sent
                    bad = bad & gpdmm.participation(cfg, rnd, m)
                check(float(mt["faults_demoted"]) >= float(bad.sum()),
                      f"faults {label} round {r}: {float(mt['faults_demoted'])} demoted, "
                      f"{float(bad.sum())} NaN or Inf rows sent")
        if label.endswith("_ms4"):
            check(tot["stale_buffered"] > 0 and tot["stale_admitted"] > 0
                  and tot["stale_dropped"] == 0.0, f"faults {label}: stale totals {tot}")
        runs[label] = states
        if prof is not None and label in ("a_gpdmm", "c_gpdmm_ms2"):
            prof(f"faults_{label}",
                 lambda: run_rounds(torch, ops, opt, state, prob.oracle(),
                                    lambda r: prob.batch(), 3, False),
                 1e3 * secs / R, 3)

    # (b) cohort == masked with finite-only screening (rtol 1e-5, as phase 8)
    worst = 0.0
    for r, (sa, sd) in enumerate(zip(runs["b_gpdmm_finite"], runs["b_gpdmm_finite_masked"])):
        for k in ("x_s", "lam_s", "x_c", "u_hat"):
            scale = max(1.0, float(sd[k].abs().max()))
            err = float((sa[k] - sd[k]).abs().max()) / scale
            worst = max(worst, err)
            check(err <= 1e-5, f"faults: cohort != masked at round {r}: {k} {err}")
    out["faults_cohort_vs_masked_max_rel_err"] = worst
    log(f"faults: screened cohort == masked (screen_mult=0) for x_s, lam_s, x_c, u_hat over "
        f"{R} rounds (max relative error {worst:.3e}, bound 1e-5)")
    # (c) the synchronous collapse, bitwise, every round, every state entry
    for a, b in (("c_gpdmm_ms0", "c_gpdmm_sync"), ("c_pytree_ms0", "c_pytree_sync")):
        for r, (sa, sb) in enumerate(zip(runs[a], runs[b])):
            keys = sorted(k for k in sa if k not in STALE_KEYS)
            check(keys == sorted(sb), f"faults: {a} and {b} state keys differ")
            for k in keys:
                for x, y in zip(T.leaves(sa[k]), T.leaves(sb[k])):
                    check(same_bits(torch, x, y), f"faults: {a} != {b} at round {r}: {k}")
        log(f"faults: {a} == {b} bitwise, every state entry, {R} rounds")
    del runs

    accept_phase(torch, ops, make, FederatedConfig, FaultConfig, quadratic, dev, out)
    lm_flat_phase(rec, torch, ops, make, make_oracle, FederatedConfig, FaultConfig, T, gen, dev,
                  out)

    # (f) the plan drawn on the card equals the CPU's, integer for integer
    plan_cfgs = [fault_cfg(FederatedConfig, FaultConfig, kw, inner_steps=K, eta=eta)
                 for kw, _ in list(FAULT_RUNS.values()) + list(FAULT_PYTREE_RUNS.values())]
    plan_cfgs.append(fault_cfg(FederatedConfig, FaultConfig, dict(
        faults=dict(delay=0.25, seed=7), max_staleness=3, stale_gamma=0.5), inner_steps=3,
        eta=eta))
    n_cmp = 0
    for cfg in plan_cfgs:
        for mm in (m, ACCEPT["m"]):
            for r in range(R):
                pc = faults.plan(cfg, torch.tensor(r, dtype=i32), mm)
                pg = faults.plan(cfg, torch.tensor(r, dtype=i32, device=dev), mm)
                for name, a, b in zip(faults.FaultPlan._fields, pg, pc):
                    check(a.device.type == dev.type and torch.equal(a.cpu(), b),
                          f"fault plan r={r} m={mm}: {name} differs between card and CPU")
                n_cmp += 1
    log(f"faults: card plan == CPU plan, all five fields, {n_cmp} draws "
        f"({len(plan_cfgs)} configs x m in ({m}, {ACCEPT['m']}) x {R} rounds)")
    log(f"faults phase: {time.perf_counter() - t_phase:.2f} s")


def accept_phase(torch, ops, make, FederatedConfig, FaultConfig, quadratic, dev, out):
    """(d) The reference's acceptance rules at their own size: the screened
    run within 10%, the stale run within 15%, of the descent scale of the
    fault-free run (``tests/test_faults.py:332``,
    ``tests/test_staleness.py:371``)."""
    a = ACCEPT
    prob = quadratic.generate(seeded(torch, 0), m=a["m"], n=a["n"], d=a["d"], device=dev)
    base = dict(algorithm="gpdmm", inner_steps=a["K"], eta=0.5 / prob.L, use_arena=True)

    def obj(cfg):
        opt = make(cfg)
        s = opt.init(torch.zeros(prob.d, device=dev), prob.m)
        for _ in range(a["rounds"]):
            s, _ = opt.round(s, prob.oracle(), prob.batch())
        return float(prob.F(opt.server_params(s)))

    clean = obj(FederatedConfig(**base))
    screened = obj(FederatedConfig(faults=FaultConfig(dropout=0.1, corrupt=0.05, seed=7),
                                   **base))
    stale = obj(FederatedConfig(faults=FaultConfig(delay=0.25, seed=7), max_staleness=3,
                                stale_gamma=0.5, **base))
    scale = float(prob.F(torch.zeros(prob.d, device=dev)) - prob.f_star)
    res = {"clean": clean, "screened": screened, "stale": stale, "scale": scale,
           "screened_off": abs(screened - clean) / scale, "stale_off": abs(stale - clean) / scale}
    out["faults_acceptance"] = res
    log(f"faults acceptance (m = {a['m']}, n = {a['n']}, d = {a['d']}, K = {a['K']}, "
        f"{a['rounds']} rounds): {res}")
    check(math.isfinite(screened) and res["screened_off"] <= 0.1,
          f"faults: screened run {screened} not within 0.1 of {scale} of the clean {clean}")
    check(math.isfinite(stale) and res["stale_off"] <= 0.15,
          f"faults: stale run {stale} not within 0.15 of {scale} of the clean {clean}")


def lm_flat_phase(rec, torch, ops, make, make_oracle, FederatedConfig, FaultConfig, T, gen, dev,
                  out):
    """(e) The reference benchmark's lm_flat shape: m = 8, one (2^20,) leaf,
    K = 4, eta = 0.1, the arena-native gradient 0.3 x; GPDMM screened and
    async at max_staleness 2.  Kernels 11-12 move 32 MB rows here."""
    c = LM_FLAT
    m, K, R = c["m"], c["K"], c["rounds"]
    params = {"w": torch.randn(c["width"], generator=gen, device=dev)}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    batch = {"dummy": torch.zeros(m, 1, device=dev)}
    tail = dict(fused_update_arena=K, round_tail=1, dual_from_uplink=1, screen_uplink=1)
    for label, kw, per_round in (
            ("screened", SCREENED, tail),
            ("async_ms2", DELAYED | dict(max_staleness=2), tail | dict(stale_mix=1))):
        opt = make(fault_cfg(FederatedConfig, FaultConfig, kw, algorithm="gpdmm",
                             inner_steps=K, eta=c["eta"], use_arena=True))
        state = opt.init(params, m)
        state, _, _, _ = run_rounds(torch, ops, opt, state, grad, lambda r: batch, 2, False)
        state, metrics, counts, secs = run_rounds(torch, ops, opt, state, grad,
                                                  lambda r: batch, R, False)
        rec.add(counts)
        out[f"faults_lm_flat_{label}_ms_per_round"] = 1e3 * secs / R
        log(f"faults lm_flat {label}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} "
            f"ms/round); launches {counts}")
        check(counts == expected(ops, R, **per_round), f"lm_flat {label}: launches {counts}")
        for k, v in state.items():
            if k != "round":
                check(all(bool(torch.isfinite(x.float()).all()) for x in T.leaves(v)),
                      f"lm_flat {label}: {k} not finite")


# ---------------------------------------------------------------------------
# phase 10: graph-PDMM over general topologies, auto-tuned stepsizes, early exit
# ---------------------------------------------------------------------------

# kernel 13 at the Fig. 2 arena, lm_flat and a ragged width; kernels 14-15 on
# every family at lm_flat (m = 8, W = 2^20), at the Fig. 2 size (m = 500,
# W = 512) and at the ring example's arena (m = 8, W = 128)
RESIDUAL_SHAPES = ((500, 512), (8, 1 << 20), (5, 130))
GRAPH_SIZES = ((8, 1 << 20), (500, 512), (8, 128))
GRAPH_FAMILIES = ("ring", "star", "complete", "torus", "er")
GRAPH_BENCH = ("star", "ring", "complete")  # benchmarks/round_bench.py:539
RING = dict(m=8, n=400, d=64, K=5, rounds=300)  # examples/ring_pdmm.py
# benchmarks/round_bench.py:766-865 (bench_autotune at lm_flat)
AUTOTUNE = dict(m=8, width=1 << 20, K=4, tol=1e-5, max_rounds=600, chunk=10)
L_RTOL = 1e-5  # L_i on the card against the CPU's: 96 matvecs summed in other orders


def check_residual_kernel(rec, torch, ops, ref, gen, out):
    """Kernel 13 against its plain version at RESIDUAL_SHAPES, f32 and bf16,
    a NaN row included: the same NaN rows, sums to rtol 1e-6 sqrt(W / 128)
    (its own fixed order), the same from run to run; then timed at every f32
    shape, the JSON row at lm_flat, the shape phase 10's early exit gives
    it."""
    dev, worst = gen.device, 0.0
    for (m, w) in RESIDUAL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(m, w, generator=gen, device=dev)
            xp = x + 0.01 * torch.randn(m, w, generator=gen, device=dev)
            x[1 % m, w // 2] = float("nan")
            x, xp = x.to(dt), xp.to(dt)
            got, want = ops.residual_norm(x, xp), ref.residual_norm_ref(x, xp)
            rtol = 1e-6 * math.sqrt(w / 128)
            for a, b in zip(got, want):
                nan = b.isnan()
                check(torch.equal(a.isnan(), nan), f"residual_norm {dt} ({m}, {w}): NaN rows")
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30))[~nan].max())
                worst = max(worst, rel / rtol)
                check(rel <= rtol, f"residual_norm {dt} ({m}, {w}): rel err {rel} > {rtol}")
            again = ops.residual_norm(x, xp)
            check(all(same_bits(torch, a, b) for a, b in zip(again, got)),
                  f"residual_norm {dt} ({m}, {w}): differs from run to run")
    out["residual_norm_worst_rel_err_over_rtol"] = worst
    log(f"residual_norm: NaN rows exact, sums within {worst:.3f} of rtol 1e-6 sqrt(W / 128), "
        f"the same from run to run, at {list(RESIDUAL_SHAPES)}, f32 and bf16")
    times = []
    for (m, w) in RESIDUAL_SHAPES:
        x = torch.randn(m, w, generator=gen, device=dev)
        xp = x + 0.01 * torch.randn(m, w, generator=gen, device=dev)
        fn, plain = lambda: ops.residual_norm(x, xp), lambda: ref.residual_norm_ref(x, xp)
        nbytes, flops = 2 * 4 * m * w + 2 * 4 * m, 5 * m * w
        iters = 200 if m * w < 1 << 22 else 50
        if (m, w) == (AUTOTUNE["m"], AUTOTUNE["width"]):
            err = max(max_err(a, b) for a, b in zip(fn(), plain()))
            rec.kernel("residual_norm", err, fn, plain, iters, nbytes, flops)
            k_ms, p_ms = rec.rows["residual_norm"]["ms"], rec.rows["residual_norm"]["plain_ms"]
        else:
            k_ms, p_ms = cuda_time_ms(fn, iters), cuda_time_ms(plain, iters)
        b, _ = bound_ms(nbytes, flops)
        times.append({"shape": [m, w], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b})
        log(f"residual_norm ({m}, {w}): {k_ms:.4f} ms (bound {b:.4f} ms, {b / k_ms:.2f} of it), "
            f"plain {p_ms:.4f} ms")
    out["residual_norm_times"] = times
    log("residual_norm library: none (no one PyTorch call gives both row sums)")


def signed_incidence(torch, t, dev):
    """The (n, 2E) sparse matrix of ``neighbor_reduce``: +-1 at (src[t], t),
    for the library's one call (``torch.sparse.mm``)."""
    S = t.n_slots
    idx = torch.stack([torch.as_tensor(t.src, dtype=torch.int64),
                       torch.arange(S, dtype=torch.int64)])
    vals = torch.as_tensor(t.sgn, dtype=torch.float32)
    return torch.sparse_coo_tensor(idx, vals, (t.n, S)).to(dev).coalesce().to_sparse_csr()


def check_graph_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 14-15 against their plain versions on every family at both
    GRAPH_SIZES, f32 and bf16, ``edge_flip`` masked and unmasked: bitwise
    (the same f32 operations, the sums in slot order).  Timed in f32,
    ``edge_flip`` unmasked and masked as the first colour phase masks it; the
    JSON rows at ring(8) on lm_flat, the main path's shape (phase 10 (b)),
    ``edge_flip`` masked as the main path calls it.  A masked flip's bound
    counts the x rows its firing slots read (the distinct ``nbr[mask != 0]``)
    and 2 operations per element of a firing slot."""
    from repro_torch.core import topology
    from repro_torch.kernels import neighbor_reduce as nr

    dev, c = gen.device, 0.85
    times = []
    for (m, w) in GRAPH_SIZES:
        for fam in GRAPH_FAMILIES:
            t = topology.make(fam, m)
            S, n, first = t.n_slots, t.n, t.first_flags()
            indptr, sgn = (a.long() for a in nr.reduce_tables(t.src, first, t.sgn, n, dev))
            rev, nbr, sgn_f, _ = nr.flip_tables(t.rev, t.nbr, t.sgn, dev)
            rev, nbr, sgn_f = rev.long(), nbr.long(), sgn_f.long()
            mask = (torch.rand(S, generator=gen, device=dev) < 0.5).to(torch.int32)
            for dt in (torch.float32, torch.bfloat16):
                z = torch.randn(S, w, generator=gen, device=dev).to(dt)
                x = torch.randn(n, w, generator=gen, device=dev).to(dt)
                got = ops.neighbor_reduce(z, seg=t.src, first=first, sgn=t.sgn, n=n)
                check(same_bits(torch, got, ref.neighbor_reduce_ref(z, indptr, sgn, n)),
                      f"neighbor_reduce {fam}({m}) W={w} {dt}: differs from the plain version")
                for mk in (None, mask):
                    got = ops.edge_flip(z, x, c, rev=t.rev, nbr=t.nbr, sgn=t.sgn, mask=mk)
                    want = ref.edge_flip_ref(z, x, c, rev, nbr, sgn_f, mk)
                    check(same_bits(torch, got, want),
                          f"edge_flip {fam}({m}) W={w} {dt} masked={mk is not None}: differs")
                del z, x, got
            z = torch.randn(S, w, generator=gen, device=dev)
            x = torch.randn(n, w, generator=gen, device=dev)
            iters = 200 if S * w < 1 << 22 else 20
            inc = signed_incidence(torch, t, dev)
            nr_fn = lambda: ops.neighbor_reduce(z, seg=t.src, first=first, sgn=t.sgn, n=n)
            nr_plain = lambda: ref.neighbor_reduce_ref(z, indptr, sgn, n)
            nr_lib = lambda: torch.sparse.mm(inc, z)
            nr_bytes, nr_flops = 4 * (S + n) * w + 4 * (n + 1 + S), S * w
            ef_fn = lambda: ops.edge_flip(z, x, c, rev=t.rev, nbr=t.nbr, sgn=t.sgn)
            ef_plain = lambda: ref.edge_flip_ref(z, x, c, rev, nbr, sgn_f, None)
            ef_bytes, ef_flops = 4 * (2 * S + n) * w + 3 * 4 * S, 2 * S * w
            fired = torch.zeros(n, dtype=torch.bool, device=dev)
            fired[torch.as_tensor(t.colors[0], dtype=torch.int64, device=dev)] = True
            phase_mask = fired[nbr].to(torch.int32)  # as the first colour phase masks it
            efm_fn = lambda: ops.edge_flip(z, x, c, rev=t.rev, nbr=t.nbr, sgn=t.sgn,
                                           mask=phase_mask)
            efm_plain = lambda: ref.edge_flip_ref(z, x, c, rev, nbr, sgn_f, phase_mask)
            x_rows = int(torch.unique(nbr[phase_mask != 0]).numel())
            efm_bytes = 4 * (2 * S + x_rows) * w + 4 * 4 * S
            efm_flops = 2 * int(phase_mask.sum()) * w
            row = {"topology": fam, "m": m, "n": n, "slots": S, "W": w,
                   "masked_firing_slots": int(phase_mask.sum()), "masked_x_rows": x_rows}
            if (fam, m, w) == ("ring", LM_FLAT["m"], LM_FLAT["width"]):  # the main path's
                lib_err = max_err(nr_lib(), nr_fn())
                rec.kernel("neighbor_reduce", max_err(nr_fn(), nr_plain()), nr_fn, nr_plain,
                           iters, nr_bytes, nr_flops, library_fn=nr_lib)
                rec.kernel("edge_flip", max_err(efm_fn(), efm_plain()), efm_fn, efm_plain,
                           iters, efm_bytes, efm_flops)
                r_nr, r_ef = rec.rows["neighbor_reduce"], rec.rows["edge_flip"]
                row["neighbor_reduce"] = {k: r_nr[k] for k in ("ms", "plain_ms", "library_ms")}
                row["edge_flip_masked"] = {k: r_ef[k] for k in ("ms", "plain_ms")}
                log(f"neighbor_reduce library (torch.sparse.mm, CSR): max abs diff {lib_err:.3e}")
            else:
                row["neighbor_reduce"] = {"ms": cuda_time_ms(nr_fn, iters),
                                          "plain_ms": cuda_time_ms(nr_plain, iters),
                                          "library_ms": cuda_time_ms(nr_lib, iters)}
                row["edge_flip_masked"] = {"ms": cuda_time_ms(efm_fn, iters),
                                           "plain_ms": cuda_time_ms(efm_plain, iters)}
            row["edge_flip"] = {"ms": cuda_time_ms(ef_fn, iters),
                                "plain_ms": cuda_time_ms(ef_plain, iters)}
            row["neighbor_reduce"]["bound_ms"] = bound_ms(nr_bytes, nr_flops)[0]
            row["edge_flip"]["bound_ms"] = bound_ms(ef_bytes, ef_flops)[0]
            row["edge_flip_masked"]["bound_ms"] = bound_ms(efm_bytes, efm_flops)[0]
            times.append(row)
            r_nr, r_ef, r_efm = row["neighbor_reduce"], row["edge_flip"], row["edge_flip_masked"]
            log(f"graph kernels {fam}({m}) n={n} slots={S} W={w}: neighbor_reduce "
                f"{r_nr['ms']:.4f} ms (bound {r_nr['bound_ms']:.4f}, plain "
                f"{r_nr['plain_ms']:.4f}, sparse.mm {r_nr['library_ms']:.4f}); edge_flip "
                f"{r_ef['ms']:.4f} ms (bound {r_ef['bound_ms']:.4f}, plain "
                f"{r_ef['plain_ms']:.4f}); masked ({row['masked_firing_slots']} firing slots, "
                f"{x_rows} x rows) {r_efm['ms']:.4f} ms (bound {r_efm['bound_ms']:.4f}, plain "
                f"{r_efm['plain_ms']:.4f})")
            del z, x, inc
    out["graph_kernel_times"] = times
    log("graph kernels: neighbor_reduce and edge_flip bitwise their plain versions on "
        f"{list(GRAPH_FAMILIES)} at {list(GRAPH_SIZES)}, f32 and bf16, masked and unmasked; "
        "edge_flip library: none (no one PyTorch call gathers, scales and subtracts)")
    torch.cuda.synchronize()


def states_equal(torch, a, b) -> bool:
    """Two round states bit for bit (NaN-free states; trees of tensors)."""
    if sorted(a) != sorted(b):
        return False
    for k in a:
        la = [a[k][j] for j in sorted(a[k])] if isinstance(a[k], dict) else [a[k]]
        lb = [b[k][j] for j in sorted(b[k])] if isinstance(b[k], dict) else [b[k]]
        if not all(torch.equal(x, y) for x, y in zip(la, lb)):
            return False
    return True


def graph_launches(t, K, *, affine):
    """Launches per graph round: per colour phase one neighbor_reduce and
    one edge_flip, and where data nodes fire one inner_loop_affine (affine
    oracle) or K fused_update_arena."""
    phases = len(t.colors)
    data = sum(int((c < t.n_data).any()) for c in t.colors)
    inner = dict(inner_loop_affine=data) if affine else dict(fused_update_arena=K * data)
    return dict(neighbor_reduce=phases, edge_flip=phases, **inner)


def graph_phase(rec, prob, torch, ops, make, FederatedConfig, quadratic, gen, dev, out,
                prof=None):
    """(b) gpdmm_graph at lm_flat on star, ring and complete (the reference
    benchmark's bench_topology rows); (c) the star graph against the
    centralised arena GPDMM on phase 4's problem; (d) examples/ring_pdmm.py's
    setting."""
    from repro_torch.core import make_oracle, pdmm_graph

    # (b)
    c = LM_FLAT
    m, K, R = c["m"], c["K"], c["rounds"]
    params = {"w": torch.randn(c["width"], generator=gen, device=dev)}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    batch = {"dummy": torch.zeros(m, 1, device=dev)}
    for name in GRAPH_BENCH:
        cfg = FederatedConfig(algorithm="gpdmm_graph", topology=name, inner_steps=K,
                              eta=c["eta"])
        opt = make(cfg)
        t = pdmm_graph.topo_for(cfg, m)
        state = opt.init(params, m)
        x0 = float(torch.linalg.vector_norm(state["x"]))
        state, _, _, _ = run_rounds(torch, ops, opt, state, grad, lambda r: batch, 2, False)
        state, metrics, counts, secs = run_rounds(torch, ops, opt, state, grad,
                                                  lambda r: batch, R, False)
        rec.add(counts)
        per = graph_launches(t, K, affine=False)
        out[f"graph_lm_flat_{name}_ms_per_round"] = 1e3 * secs / R
        log(f"graph lm_flat {name} (n={t.n}, {t.n_edges} edges, {len(t.colors)} colours): {R} "
            f"rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); launches {counts}; "
            f"consensus {float(metrics['consensus_err']):.3e}")
        check(counts == expected(ops, R, **per), f"graph lm_flat {name}: launches {counts}")
        for k in ("x", "z"):
            check(bool(torch.isfinite(state[k]).all()), f"graph lm_flat {name}: {k} not finite")
        x1 = float(torch.linalg.vector_norm(state["x"]))
        check(x1 < x0, f"graph lm_flat {name}: ||x|| did not fall ({x0} -> {x1})")
        if prof is not None:
            prof(f"graph_lm_flat_{name}", lambda: run_rounds(
                torch, ops, opt, state, grad, lambda r: batch, 3, False), 1e3 * secs / R, 3)

    # (c)
    R, K = LSQ["rounds"], LSQ["K"]
    eta = 0.5 / prob.L
    g = make(FederatedConfig(algorithm="gpdmm_graph", inner_steps=K, eta=eta))
    cen = make(FederatedConfig(algorithm="gpdmm", inner_steps=K, eta=eta, use_arena=True))
    x0 = torch.zeros(prob.d, device=dev)
    sg, sc = g.init(x0, prob.m), cen.init(x0, prob.m)
    worst = {"x_s": 0.0, "carry": 0.0}
    counts_g, counts_c, secs_g, secs_c = {}, {}, 0.0, 0.0
    for r in range(R):
        sg, _, cg, tg = run_rounds(torch, ops, g, sg, prob.oracle(), lambda _: prob.batch(), 1,
                                   False)
        sc, _, cc, tc = run_rounds(torch, ops, cen, sc, prob.oracle(), lambda _: prob.batch(),
                                   1, False)
        secs_g, secs_c = secs_g + tg, secs_c + tc
        for k in cg:
            counts_g[k] = counts_g.get(k, 0) + cg[k]
            counts_c[k] = counts_c.get(k, 0) + cc[k]
        for key, a, b in (("x_s", sg["x_s"], sc["x_s"]),
                          ("carry", sg["x"][:prob.m], sc["x_c"])):
            # allclose at atol = rtol = 1e-4: |a - b| <= 1e-4 (1 + |b|)
            worst[key] = max(worst[key], float(((a - b).abs() / (1.0 + b.abs())).max()))
    rec.add(counts_g)
    rec.add(counts_c)
    t = pdmm_graph.topo_for(FederatedConfig(algorithm="gpdmm_graph"), prob.m)
    out["graph_star_vs_central"] = {"worst": worst, "graph_ms_per_round": 1e3 * secs_g / R,
                                    "central_ms_per_round": 1e3 * secs_c / R}
    log(f"graph star vs centralised GPDMM (m = n = d = {prob.m}, K = {K}, {R} rounds): worst "
        f"|diff| / (1 + |central|) x_s {worst['x_s']:.3e}, carry {worst['carry']:.3e} (limit "
        f"1e-4); graph {1e3 * secs_g / R:.3f} ms/round, centralised {1e3 * secs_c / R:.3f}; "
        f"launches {counts_g} / {counts_c}; final ||x - x*|| "
        f"{float(prob.dist(sg['x_s'])):.4e} / {float(prob.dist(sc['x_s'])):.4e}")
    check(max(worst.values()) <= 1e-4, f"graph star != centralised GPDMM: {worst}")
    check(counts_g == expected(ops, R, **graph_launches(t, K, affine=True)),
          f"graph star: launches {counts_g}")

    # (d)
    rc = RING
    rprob = quadratic.generate(seeded(torch, 0), m=rc["m"], n=rc["n"], d=rc["d"], device=dev)
    cfg = FederatedConfig(algorithm="gpdmm", topology="ring", inner_steps=rc["K"],
                          eta=0.5 / rprob.L)
    opt = make(cfg)
    check(opt.name == "gpdmm_graph", f"gpdmm on a ring routed to {opt.name}")
    state = opt.init(torch.zeros(rprob.d, device=dev), rprob.m)
    state, metrics, counts, secs = run_rounds(torch, ops, opt, state, rprob.oracle(),
                                              lambda r: rprob.batch(), rc["rounds"], False)
    rec.add(counts)
    t = pdmm_graph.topo_for(cfg, rprob.m)
    worst_node = float(torch.max(torch.linalg.vector_norm(
        state["x"][:, :rprob.d] - rprob.x_star[None], dim=1)))
    out["ring_example"] = {"worst_node_dist": worst_node,
                           "ms_per_round": 1e3 * secs / rc["rounds"],
                           "consensus_err": float(metrics["consensus_err"])}
    log(f"ring example (m = {rc['m']}, n = {rc['n']}, d = {rc['d']}, K = {rc['K']}, "
        f"{rc['rounds']} rounds): worst per-node ||x_i - x*|| {worst_node:.3e} (limit 1e-2), "
        f"consensus {float(metrics['consensus_err']):.3e}, {1e3 * secs / rc['rounds']:.3f} "
        f"ms/round; launches {counts}")
    check(worst_node < 1e-2, f"ring example: worst node distance {worst_node}")
    check(counts == expected(ops, rc["rounds"], **graph_launches(t, rc["K"], affine=True)),
          f"ring example: launches {counts}")


def autotune_phase(rec, prob, torch, ops, make, FederatedConfig, quadratic, gen, dev, out):
    """(e) ``eta="auto"`` on phase 4's problem (L_i against the CPU's), then
    the reference's autotune bench at lm_flat: rounds to the relative
    residual tol under the auto-derived and the hand-tuned eta, the early
    exit through ``make_scan_rounds`` and ``EarlyExit``, and the early-exit
    state equal to the fixed-budget run's at that round."""
    from repro_torch.core import autotune, make_oracle, make_scan_rounds

    m, d, K = prob.m, prob.d, LSQ["K"]
    base = FederatedConfig(algorithm="gpdmm", inner_steps=K, eta="auto", use_arena=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = autotune.resolve(base, prob.oracle(), torch.zeros(d, device=dev), m, prob.batch())
    resolve_s = time.perf_counter() - t0
    L_card = autotune.SAFETY / torch.tensor(cfg.eta, dtype=torch.float64)
    cpu = prob.__class__(**{f: getattr(prob, f).cpu() for f in (
        "AtA", "Atb", "btb", "evals", "evecs", "x_star", "f_star")}, L=prob.L, mu=prob.mu)
    t0 = time.perf_counter()
    L_cpu = torch.from_numpy(autotune.estimate_L(cpu.oracle(), torch.zeros(d), m, cpu.batch()))
    cpu_s = time.perf_counter() - t0
    del cpu
    rel = float(((L_card - L_cpu).abs() / L_cpu).max())
    eig = float(((L_card - prob.evals[:, -1].double().cpu()).abs()
                 / prob.evals[:, -1].double().cpu()).max())
    state = (opt := make(cfg)).init(torch.zeros(d, device=dev), m)
    state, _, counts, secs = run_rounds(torch, ops, opt, state, prob.oracle(),
                                        lambda r: prob.batch(), LSQ["rounds"], False)
    rec.add(counts)
    dist = float(prob.dist(state["x_s"]))
    out["autotune_fig2"] = {"resolve_s": resolve_s, "cpu_estimate_s": cpu_s, "L_rel_vs_cpu": rel,
                            "L_rel_vs_eigvalsh": eig, "dist_after": dist,
                            "ms_per_round": 1e3 * secs / LSQ["rounds"]}
    log(f"autotune Fig. 2 (m = {m}, W = 512): resolve {resolve_s:.3f} s on the card "
        f"(CPU {cpu_s:.3f} s); L_i vs CPU max rel {rel:.3e} (rtol {L_RTOL}), vs eigvalsh "
        f"{eig:.3e}; eta_i in [{min(cfg.eta):.4e}, {max(cfg.eta):.4e}]; {LSQ['rounds']} auto "
        f"rounds {1e3 * secs / LSQ['rounds']:.3f} ms/round, ||x - x*|| {dist:.4e}; "
        f"launches {counts}")
    check(rel <= L_RTOL, f"autotune: L_i on the card vs the CPU {rel} > {L_RTOL}")
    check(counts == expected(ops, LSQ["rounds"], inner_loop_affine=1, round_tail=1,
                             dual_from_uplink=1), f"autotune Fig. 2: launches {counts}")
    check(math.isfinite(dist) and dist < float(prob.dist(torch.zeros(d, device=dev))),
          f"autotune Fig. 2: distance {dist}")

    a_cfg = AUTOTUNE
    m, K, tol = a_cfg["m"], a_cfg["K"], a_cfg["tol"]
    params = {"w": torch.randn(a_cfg["width"], generator=gen, device=dev)}
    a = torch.logspace(-1.0, 0.5, m, dtype=torch.float32, device=dev)
    batch = {"a": a, "t": 0.5 * torch.randn(m, a_cfg["width"], generator=gen, device=dev)}
    het = make_oracle(lambda p, b: {"w": b["a"] * (p["w"] - b["t"])},
                      grad_arena=lambda spec: (lambda xa, b: b["a"][:, None] * (xa - b["t"])))
    eta_hand = autotune.SAFETY / float(a.max())
    rho = 1.0 / (K * eta_hand)
    kw = dict(algorithm="gpdmm", inner_steps=K, use_arena=True, tol=tol, rho=rho)
    auto_cfg = autotune.resolve(FederatedConfig(eta="auto", **kw), het, params, m, batch)
    hand_cfg = FederatedConfig(eta=eta_hand, **kw)
    want_eta = autotune.SAFETY / a.double().cpu()
    eta_rel = float(((torch.tensor(auto_cfg.eta, dtype=torch.float64) - want_eta).abs()
                     / want_eta).max())
    check(eta_rel <= L_RTOL, f"autotune bench: eta_i vs safety / a_i rel {eta_rel}")
    CH = a_cfg["chunk"]
    batches = {k: v[None].expand((CH,) + tuple(v.shape)) for k, v in batch.items()}

    def scan_to_tol(cfg):
        """Rounds until EarlyExit fires, driven by make_scan_rounds in
        chunks of CH rounds: (stop round, seconds, launches)."""
        fed = make(cfg)
        run = make_scan_rounds(fed, het, tol=cfg.tol)
        state = fed.init(params, m)
        ee = autotune.EarlyExit(cfg.tol, cfg.patience)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, a_cfg["max_rounds"], CH):
            state, met = run(state, batches)
            j = ee.update(met["res_dx2"], met["res_x2"])
            if j is not None:
                torch.cuda.synchronize()
                return start + j + 1, time.perf_counter() - t0, ops.launches(), start + CH
        torch.cuda.synchronize()
        return a_cfg["max_rounds"], time.perf_counter() - t0, ops.launches(), a_cfg["max_rounds"]

    r_auto, s_auto, c_auto, ran_auto = scan_to_tol(auto_cfg)
    r_hand, s_hand, c_hand, ran_hand = scan_to_tol(hand_cfg)
    for counts, ran in ((c_auto, ran_auto), (c_hand, ran_hand)):
        rec.add(counts)
        check(counts == expected(ops, ran, fused_update_arena=K, round_tail=1,
                                 dual_from_uplink=1, residual_norm=2),
              f"autotune bench: launches {counts} over {ran} rounds")

    # the early exit, round by round, is a prefix of the fixed-budget run
    fed = make(auto_cfg)
    s0 = fed.init(params, m)
    ee, s, stop = autotune.EarlyExit(tol), s0, None
    for r in range(1, a_cfg["max_rounds"] + 1):
        s2, _ = fed.round(s, het, batch)
        res = autotune.state_residual(s, s2)
        s = s2
        if ee.update(res["res_dx2"], res["res_x2"]) is not None:
            stop = r
            break
    s_fixed = s0
    for _ in range(r_auto):
        s_fixed, _ = fed.round(s_fixed, het, batch)
    same = stop == r_auto and states_equal(torch, s, s_fixed)
    out["autotune_bench"] = {"tol": tol, "rounds_auto": r_auto, "rounds_fixed": r_hand,
                             "rounds_speedup": r_hand / max(r_auto, 1),
                             "ms_per_round_auto": 1e3 * s_auto / ran_auto,
                             "ms_per_round_fixed": 1e3 * s_hand / ran_hand,
                             "per_round_stop": stop, "prefix_equal": same}
    log(f"autotune bench (lm_flat, a_i log-spaced 0.1-3.16, tol {tol}, rho {rho:.4f}): tol in "
        f"{r_auto} rounds with auto eta vs {r_hand} hand-tuned (x{r_hand / max(r_auto, 1):.2f}); "
        f"{1e3 * s_auto / ran_auto:.3f} / {1e3 * s_hand / ran_hand:.3f} ms/round (scan chunks "
        f"of {CH}, residual on); per-round early exit at {stop}; early-exit state == "
        f"fixed-budget state at that round: {same}")
    check(r_auto < r_hand, f"autotune bench: auto {r_auto} rounds, hand-tuned {r_hand}")
    check(r_auto < a_cfg["max_rounds"], "autotune bench: auto never reached tol")
    check(same, f"autotune bench: early exit at {stop} vs the scan's {r_auto}, or the states "
                f"differ")


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
    from repro_torch.configs.base import FaultConfig, FederatedConfig
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

    phase_s = out["phase_s"] = {}

    def timed(label, fn, *a):
        t = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        phase_s[label] = time.perf_counter() - t
        log(f"phase {label}: {phase_s[label]:.2f} s")

    eta = 0.5 / prob.L
    timed("3 kernels", check_kernels, rec, prob, eta, 1.0 / (LSQ["K"] * eta), torch, ops, ref,
          seeded(torch, 3))
    timed("3 cohort kernels", check_cohort_kernels, rec, torch, ops, ref, seeded(torch, 13))
    timed("3 fault kernels", check_fault_kernels, rec, torch, ops, ref, seeded(torch, 17), out)
    timed("3 card vs cpu", check_small_against_cpu, torch, make, FederatedConfig, quadratic)

    dev = torch.device("cuda")
    prof = None
    if args.profile:
        def prof(label, run, round_ms, rounds):
            profile_rounds(torch, label, run, round_ms, rounds, out)
    timed("4 lsq", lsq_phase, rec, prob, torch, ops, make, FederatedConfig, dev, prof)
    timed("5 softmax", softmax_phase, rec, torch, ops, make, FederatedConfig, SoftmaxRegression,
          seeded(torch, 0), dev, SOFTMAX_RUNS, prof)

    t0 = time.perf_counter()
    prob25 = quadratic.generate(seeded(torch, 0), m=FIG1["m"], n=FIG1["n"], d=LSQ["d"],
                                device="cuda")
    torch.cuda.synchronize()
    log(f"least squares m={FIG1['m']} n={FIG1['n']} d={LSQ['d']}: set-up "
        f"{time.perf_counter() - t0:.2f} s; L {prob25.L:.4e} mu {prob25.mu:.4e}")
    timed("6 fig2", fig2_phase, rec, {LSQ["m"]: prob, FIG1["m"]: prob25}, torch, ops, make,
          FederatedConfig, dev, prof)
    timed("7 fig1", fig1_phase, rec, prob25, torch, ops, make, FederatedConfig, dev)
    timed("8 participation", participation_phase, rec, prob, torch, ops, make, FederatedConfig,
          dev, out, prof)
    timed("8 softmax", softmax_phase, rec, torch, ops, make, FederatedConfig, SoftmaxRegression,
          seeded(torch, 0), dev, SOFTMAX_PARTIAL, prof)
    timed("9 faults", faults_phase, rec, prob, torch, ops, make, FederatedConfig, FaultConfig,
          quadratic, seeded(torch, 21), dev, out, prof)
    timed("10 residual kernel", check_residual_kernel, rec, torch, ops, ref, seeded(torch, 23),
          out)
    timed("10 graph kernels", check_graph_kernels, rec, torch, ops, ref, seeded(torch, 29), out)
    timed("10 graph rounds", graph_phase, rec, prob, torch, ops, make, FederatedConfig,
          quadratic, seeded(torch, 31), dev, out, prof)
    timed("10 autotune", autotune_phase, rec, prob, torch, ops, make, FederatedConfig,
          quadratic, seeded(torch, 37), dev, out)

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
