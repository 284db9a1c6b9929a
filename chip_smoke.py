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
     least-squares problem against its own CPU run, in f32 and with bf16
     parameters; ``inner_loop_affine`` on the resident route at (500, 512)
     (lam, an off row at rho = 0, a per-client step, bf16 rows; the
     streaming route launched there gives the same bits; both routes
     timed there, the clusters that fit at once logged), at m = 37 on each
     other resident width (W = 128, 256, 384, 640: every cluster size the
     route takes) against the plain version and the streaming route, and
     on the streaming route at (64, 1024), the width it alone takes;
     kernels 4 and 6, one kernel stepping a table of segments, bitwise its
     plain version in f32 and bf16 at the reference benchmark's lm_flat
     (the (8, 2^20) arena) and lm_tree (six leaves at m = 8, one launch),
     on one leaf, in every mode of x_bar's running sum (first, add, last,
     only), timed there with lam and the sum beside the pair it replaces
     (the step kernel without the sum, then a plain add, per leaf) and
     host-paced on 1 and 6 small leaves; the server step ("3 server
     step", ``SERVER_SHAPES``: (500, 512) f32 and bf16, lm_flat and
     (10^6, 1,024) f32): ``client_mean`` against ``torch.mean`` (f32 within
     2 (d + 2) 2^-24 of each column's mean |u|, d the kernel's summation
     depth, and half that of the float64 mean; bf16 one bf16 step), the
     dual pass's lam bitwise the plain dual given the kernel's x_s', its
     column sum against ``torch.sum`` likewise relative to sum |lam|,
     ``round_tail_mean``'s mean bitwise ``client_mean`` of its uplink, two
     runs bitwise equal, each timed with its bound and its plain
     composition;
  4. least squares at the paper's Fig. 2 size (m = n = d = 500, K = 5,
     ``use_arena=True`` with ``oracle()``): 30 rounds each of GPDMM,
     AGPDMM, SCAFFOLD and FedAvg; ||x - x*|| must fall, the dual-sum
     invariant (25) and SCAFFOLD's sum_i (c_i - c) = 0 hold to their
     rounding scales (``invariants``: the f32 client mean's, and (25) also
     sqrt(m) eps ||lam||_F for lam's column sum), and every value stay
     finite; ``inner_loop_affine`` launches once per round,
     ``round_tail_mean`` and ``dual_from_uplink`` (the server step's two
     passes; every round with a cache runs ``round_tail``, ``client_mean``
     and ``dual_from_uplink``) once per GPDMM/AGPDMM round,
     ``scaffold_step`` (SCAFFOLD's server step, two passes) once per
     SCAFFOLD round;
  5. softmax regression at the paper's Table I size (F = 784, C = 10,
     m = 10, B = 300, K = 5, one class per client): 10 rounds each of
     GPDMM, AGPDMM, SCAFFOLD, FedAvg, Inexact FedSplit (x_s init) and GPDMM
     with SVRG; the loss must fall, ``fused_update_arena`` (``fused_update``
     for FedSplit) launch K times per round, and no plain op writes
     GPDMM's x_bar (``check_x_bar``: the inner loop's x_bar is none of the
     outputs of the tensor ops it dispatched, so the step kernel's running
     sum wrote it);
  6. Fig. 2 as ``benchmarks/fig2_lsq.py`` runs it: the default config (the
     per-leaf pytree path at W = 512) with the plain grad, eta = 0.5 / L,
     200 rounds of FedAvg, GPDMM, AGPDMM and SCAFFOLD at m = n = d = 500,
     K in {1, 5, 20} and at m = 25, n = 5000, d = 500, K in {1, 3, 5, 10,
     20}; the benchmark's claims must hold for K > 1 (AGPDMM within 1.05x
     of GPDMM at round 50, FedAvg's final distance above 10x AGPDMM's),
     the K = 1 trajectories of AGPDMM, SCAFFOLD and FedAvg agree (paper
     (27)/(31)), and ``fused_update`` launch K times per round, no arena
     kernel at all, GPDMM no plain op for x_bar; then the reference
     benchmark's lm_tree (``round_bench.py:62-72``: m = 8, six f32 leaves,
     K = 4, the 0.3 x tree gradient) on the pytree path, 10 rounds each of
     GPDMM, AGPDMM, SCAFFOLD and FedAvg: one ``fused_update`` launch a step
     for all six leaves, no plain op for x_bar, the card equal to the CPU
     after a GPDMM round (rtol = atol = 1e-5);
  7. Fig. 1 as ``benchmarks/fig1_fedsplit.py`` runs it: Inexact FedSplit
     at m = 25 (rho = L / 10, eta = 1 / L), init z and x_s, K in {1, 3},
     300 rounds; the x_s init's gap must be below 1e-3 of the z init's, as
     the benchmark computes it (f32) and in float64; then "7 theory":
     (a) ``benchmarks/theory_rate.py`` on its own problem (the reference's
     key 3 drawn through ``core.prng``, m = 10, n = 400, d = 64, K = 5, eta
     = 0.5 / L, the default config's pytree path): 40 traced GPDMM rounds,
     every Q^{r+1} / Q^r <= beta + 1e-3 (Theorem 1), and AGPDMM's
     contraction of ||x_s - x*|| over 30 rounds at least GPDMM's and within
     beta; (b) Q's ratios over 25 traced arena rounds at the Fig. 2 size,
     logged only (mu is not positive there in f32, so beta is undefined);
     (c) ``kkt_residuals`` after 300 arena rounds at tests/test_theory.py's
     size, to its thresholds;
  8. partial participation and the EF21 uplink on phase 4's problem (30
     rounds): GPDMM, AGPDMM, SCAFFOLD and FedAvg at participation 0.1 (the
     cohort engine, 50 of 500 clients), GPDMM, AGPDMM and FedAvg with
     8-bit EF21 on top, GPDMM with EF21 at full participation, and GPDMM
     at participation 0.1 on the masked full-population round
     (``cohort=False``), whose every state entry must equal the cohort
     run's at each round (rtol 1e-5); GPDMM at participation 0.1, plain
     and with 8-bit EF21, on the default config (the per-leaf pytree path,
     the plain grad); ||x - x*|| falls, the invariants hold, the launches
     per round are as derived from the code (a cohort round launches one
     gather and one scatter); then softmax at the Table I size with
     participation 0.5 and 8-bit EF21 (GPDMM, FedAvg), whose loss must
     fall; then the GPDMM cohort round at the reference's population sweep
     (``POPULATION``: m = 10^5 and 10^6 clients, W = 1,024, a cohort of
     64, K = 4, the 0.3 x arena gradient), functional (``fed.round``) and
     donated (``fed.round_``), each alone on the card: ms a round, host
     ops, launches, device-busy ms and the peak allocation; three donated
     rounds bitwise three functional ones, whose input stays as it was;
     then "8 popstore", the host-resident population store
     (``core.popstore.Runner``): (a) 10 rounds of GPDMM, AGPDMM, SCAFFOLD
     and FedAvg, plain and with 8-bit EF21 (not SCAFFOLD), and GPDMM with
     10% dropout, screened, at the Fig. 2 size and participation 0.1,
     each round against the device cohort round from the same start (x_s,
     every store buffer and GPDMM's lazy dual against lam_s within atol
     1e-5 of max(1, max |a|); EF21 rounds each from the device round's
     state), the launches of the body's code and no row kernel; (b) the
     benchmark's lm_flat cell (m = 8, 2^20, participation 0.5): ms a round
     against the device cohort round, ring hits and misses; (c) the
     population sweep (``POPULATION``): ms a round, the draw's ms,
     launches, device-busy ms, the body's host syncs, ring hits and misses,
     the peak allocation above the set-up (below 1 GB at 10^6), the running
     sum against a dense f64 column sum at f32 resolution, an m skipped
     with a line when its host store does not fit twice into MemAvailable;
     (d) a round at 10^5 with the global tracer on, whose trace loads back
     with every ``popstore/*`` span and the ring counter, timed against the
     same round with tracing off; and the lazy dual's cost at (64, 1,024);
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
     launches per round are as derived from the code; in one round of the
     screened arena, cohort and SCAFFOLD configs the screen dispatches no
     tensor op from the uplink to the mask (``faults.screen_keep``, one
     ``screen_keep`` launch) and SCAFFOLD's tail none (``scaffold_step``,
     its two passes, no ``scaffold_cv``);
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
     gives them, no plain op for x_bar; (c) the star graph against the centralised arena GPDMM on
     phase 4's problem, 30 rounds, x_s and the carry within atol = rtol =
     1e-4; (d) ``examples/ring_pdmm.py``'s setting, every node within 1e-2
     of x*; (e) ``eta="auto"`` resolved on phase 4's problem, L_i within
     rtol 1e-5 of the CPU's, then the reference's autotune bench at lm_flat
     (a_i log-spaced 0.1-3.16, tol 1e-5, at most 600 rounds, rho = 1/(K
     eta_hand)) through ``make_scan_rounds`` and ``EarlyExit``: auto
     reaches tol in fewer rounds than the hand-tuned eta, and the early-exit
     state equals the fixed-budget run's at that round;
 11. the model slice: (a) ``flash_attention`` against its plain version
     at olmo-1b's prefill shape (4, 1024, 16, 128) bf16, causal, with a
     window of 256, grouped (H 32, Hkv 8), in f32 and with suffix queries,
     and at the edges of its tensor-core tiles (``FLASH_EDGES``), each on
     the route its dtype and head dims select, timed beside
     ``scaled_dot_product_attention``; at the head dims of the archs served
     below (``FLASH_HEAD_DIMS``: deepseek's MLA hd 192 / vd 128,
     recurrentgemma's hd 256 on one kv head with its 2,048-key window, at
     4,096 keys too, stablelm's hd 160) and their edges
     (``FLASH_HEAD_DIM_EDGES``: f32, the 64-key tiles, vd above and below
     hd), those four timed with their bounds beside the fastest SDPA
     backend that takes them (each pinned in turn); ``lru_scan`` bitwise
     its plain recurrence at recurrentgemma's (4, 1024, 4096) and at
     lengths 1, 511 and 513, timed with its bound; ``wkv6`` at
     rwkv6-1.6b's (4, 1024, 32, 64) bf16 with a nonzero initial state, at
     a ragged length with near-zero decay, and at lengths 1, 63, 65 and
     100 with a zero and a nonzero initial state; (b)
     ``repro_torch.launch.serve.run`` at full width for every arch of
     ``SERVE_ARCHS`` (olmo-1b, rwkv6-1.6b and recurrentgemma-9b at full
     depth; deepseek-v2-lite-16b at 8 layers; stablelm-12b,
     llava-next-mistral-7b, musicgen-large and llama4-maverick at 2
     layers), batch 4,
     prompt 1024, 32 new tokens, the weights drawn once (the reference's,
     from seed 0) and one warm-up prefill before the timed one: prefill
     and decode times, the weights' draw time and peak allocation, the
     serving peak, ``SERVE_LAUNCHES`` per prefill and none per decode
     token, kernel 16 on the tensor cores, finite logits, the last decode
     step's logits against a prefill of the extended prompt (MoE archs
     drop-free, every token routed as that prefill routed it,
     ``LOGITS_MOE_REL``; the top-k choices a free-running decode makes
     otherwise counted) and the same in f32 at full width with 4 layers
     (``F32_CHECK``: deepseek and maverick cut), and a profile
     of one prefill and 8 decode steps (busy time, idle share, kernel time
     by name); (c) olmo-1b and rwkv6-1.6b at full width with 2 layers on
     the card against the CPU (prefill of a 256-token prompt and one
     decode step);
 12. federated LM training: (a) the backward kernels 16b and 17b against
     autograd of their plain versions (``FLASH_BWD_CASES``, with 16b at the
     trained archs' head dims ``FLASH_BWD_HEAD_DIMS``: MLA's 192 / 128,
     recurrentgemma's 256 on one kv head with its window, stablelm's 160;
     ``WKV_BWD_CASES``; every case run twice, the two bitwise equal), timed
     at the prefill shapes and the training round's folded shapes beside
     their bounds and, for 16b, SDPA's backward under each of its backends
     ``SDPA_BACKENDS``, the fastest the library time (medians of
     ``BWD_TRIALS`` trials; which backends refuse a shape logged);
     ``lru_scan_bwd`` bitwise autograd of the plain recurrence at
     ``LRU_BWD_SHAPES``, timed with its bound; and ``vmap(grad)``
     through ``ops.flash_attention`` and ``ops.wkv6`` (one launch of each
     kernel); (b) olmo-1b at full width through ``launch.train.run``
     (``TRAIN``: a resume replays the uninterrupted run bitwise), kernels
     2-4 at its arena, rwkv6-1.6b at 2 layers; (c) "12 train archs":
     deepseek-v2-lite-16b (2 layers), recurrentgemma-9b (one unit) and
     stablelm-12b (2 layers) at full block width (``TRAIN_ARCHS``, the
     vocabulary cut to 32,000 where it would not fit), 3 GPDMM rounds each
     through ``fed.round`` over ``vmap(grad(loss))`` with the launches
     derived, ``lam_sum_norm`` at its rounding scale, ms a round, peak and
     idle share, deepseek run twice more with its rows bitwise equal; (d)
     "12 train card vs cpu": the reduced configs in f32 at the full head
     dims, one round on the card against the CPU (``TRAIN_CPU_REL``); the
     examples and the popstore's checkpoint; (e) "12 jvp kernels": the
     forward-mode kernels 16j, 16bj (``FLASH_JVP_CASES``: olmo-1b's training
     shape and the trained archs' head dims, bf16 and f32) and
     ``lru_scan_jvp``, ``lru_scan_bwd_jvp`` (``LRU_JVP_SHAPES``, bitwise
     ``torch.func.jvp`` of the plain recurrence and of its backward) and the
     RWKV-6 tangents 17j ``wkv6_jvp``, 17bj ``wkv6_bwd_jvp``
     (``WKV_JVP_CASES``: rwkv6-1.6b's prefill and training shapes in bf16, a
     ragged length, the extreme decay in f32, a slow one in f32 and bf16)
     against their plain versions, every case twice (bitwise equal), timed
     beside their bounds,
     16j also beside ``torch.func.jvp`` of SDPA under each backend that
     takes it; (f) "12 eta auto": the curvature probe of ``--eta auto``
     (``vmap(jvp(grad(loss)))``) through the kernels: olmo-1b at full width
     and depth through ``autotune.estimate_L`` (``ETA_AUTO``: L range,
     seconds, launches, peak allocation; ``--full-probe`` runs instead
     rwkv6-1.6b's at full depth with witnesses of its L, ``FULL_PROBE``),
     ``launch.train.run(eta="auto", steps=1)`` for
     ``ETA_AUTO_ARCHS`` at their cuts (``TRAIN_ARCHS`` and rwkv6-1.6b at 2
     layers: finite loss, the probe's launches), the reduced configs of "12
     train card vs cpu" and rwkv6-1.6b's against the CPU's L
     (``L_CARD_CPU_RTOL``) and against the plain ops on the card
     (``L_PLAIN_RTOL``);
 13. print one JSON line of per-kernel numbers (with each source's
     ``-Xptxas -v`` registers, static shared memory and spills per entry
     function when the run built it), then the result line
     ``{"ok": true, "device": {...}}`` last.

Phase 3 also holds the cohort kernels (``row_gather``, ``row_scatter``,
over a table of buffers) bitwise against their plain versions at
``ROW_CHECKS`` (f32, bf16 and mixed tables, int32 and int64 ids; the
in-place scatter leaves every row outside the cohort as it was, the
functional one its input) and times them at ``ROW_SHAPES`` beside
``index_select`` and the in-place ``index_copy_``, and holds
the EF21 kernels (``ef21_rowmax``, ``ef21_apply``) bitwise against
their plain versions (f32 and bf16, a NaN included) and the EF21 uplink
in one pass (``ef21_update``) bitwise against their composition with
the plain per-leaf scales at ``EF21_CHECKS`` on its own route and on the
wide one (a NaN, an Inf, a -Inf, an all-zero leaf, bits 8 and 4), timed
at ``EF21_TIMED`` with the tensor ops it dispatches besides
``torch.empty`` (none), ``stale_mix``
bitwise and ``screen_uplink`` (finite flags exactly, sums to rtol
1e-6 * sqrt(W / 128)) at (500, 512), (50, 512), (8, 2^20) and (5, 130),
f32 and bf16, broadcast and per-row, with NaN and Inf rows, and times the
one PyTorch call that computes the same function where there is one;
"3 screen keep" holds ``screen_keep`` (the screen with its keep rule in
one launch) at ``KEEP_SHAPES`` bitwise to the plain rule on
``screen_uplink``'s sq (mask, median, sq; NaN, Inf, ties, no finite row, a
NaN reference; screen_mult 0, 3 and 100; 10^5 x 1,024 on the cooperative
select route), and "3 scaffold step" holds ``scaffold_step`` at
``SCAFFOLD_SHAPES`` (c_i' bitwise ``scaffold_cv``'s, x_s' and c' within
the mean's depth roundings, bitwise on integer data, the column sum within
its depth roundings); both timed beside their bounds, their plain
versions and the card's old path (the old kernel, then plain ops).

Launch counts are set to 0 just before each run of the main path (phases
3-11) and read just after it; the launches of the kernel comparisons (phases
3, 10 (a) and 11 (a)) and of phase 11's checks do not count.  Each phase draws its data from a generator of its own.  The script
imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F32_EPS = 2.0 ** -23
LSQ = dict(m=500, n=500, d=500, K=5, rounds=30)
SOFTMAX = dict(F=784, C=10, m=10, B=300, K=5, rounds=10, n=600)
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


def med_ms(fn, iters: int, trials: int, spin_cycles: int = 400_000) -> tuple[float, list]:
    """The median of ``trials`` timings of ``iters`` calls (``cuda_time_ms``,
    the stream pre-filled by ``spin_cycles`` a call), and every trial's."""
    every = [cuda_time_ms(fn, iters, spin_cycles=spin_cycles) for _ in range(trials)]
    return statistics.median(every), every


def bound_ms(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _demangle(name: str) -> str:
    """A short readable form of an Itanium-mangled kernel name: the last
    identifier of its nested name and its template arguments, e.g.
    ``flash_tc_kernel<2>`` or ``wkv6_kernel<__nv_bfloat16>``."""
    def ident(i):
        m = re.match(r"(\d+)", name[i:])
        n = int(m.group(1))
        j = i + len(m.group(1))
        return name[j:j + n], j + n

    if not name.startswith("_Z"):
        return name
    i = 2 + (name[2] == "N")
    last = name
    while i < len(name) and name[i].isdigit():
        last, i = ident(i)
    if i >= len(name) or name[i] != "I":
        return last
    args, i = [], i + 1
    while i < len(name) and name[i] != "E":
        if name[i] == "L":  # a literal: L<type><value>E
            j = name.index("E", i)
            args.append(re.sub(r"^L[a-z]", "", name[i:j]))
            i = j + 1
        elif name[i].isdigit():
            a, i = ident(i)
            args.append(a)
        else:
            args.append({"f": "float", "d": "double", "i": "int"}.get(name[i], name[i]))
            i += 1
    return f"{last}<{', '.join(args)}>"


def ptxas_report(text: str) -> list:
    """Per entry function of an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spill-store bytes (``fn``, ``regs``, ``smem``,
    ``spill``; the dynamic shared memory is set at launch)."""
    rows, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = {"fn": _demangle(m.group(1))}
            rows.append(fn)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            fn["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fn["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            fn["smem"] = int(sm.group(1)) if sm else 0
    return rows


class Record:
    """Per-kernel numbers for the JSON line."""

    def __init__(self, ops, build_logs):
        self.rows = {k.name: {"name": k.name, "route": "cuda",
                              "source": f"src/repro_torch/kernels/csrc/{k.source}",
                              "replaces": k.replaces, "launches": 0,
                              "ptxas": (ptxas_report(build_logs[k.source])
                                        if k.source in build_logs else None)}
                     for k in ops.KERNELS}

    def add(self, counts):
        """Add a main-path run's launch counts."""
        for k, n in counts.items():
            self.rows[k]["launches"] += n

    def kernel(self, name, err, fn, plain_fn, iters, nbytes, flops, library_fn=None,
               flop_per_s=F32_FLOP_PER_S, plain_iters=None, plain_spin=400_000, trials=1):
        """Time ``fn`` (the kernel), ``plain_fn`` and, where one PyTorch call
        computes the same function, ``library_fn`` on the device, and the
        kernel once more as the host enqueues it (``enqueue_ms``).  The bound
        takes ``flops`` at ``flop_per_s`` (f32 outside the tensor cores by
        default).  A plain version of many ops takes ``plain_iters`` calls
        behind a spin of ``plain_spin`` cycles a call, so that the host has
        enqueued them all before the device reaches them.  With ``trials`` >
        1 the kernel's and the library's times are medians of that many
        trials of ``iters`` calls each (``med_ms``, every trial's time
        kept)."""
        ms, ms_all = med_ms(fn, iters, trials)
        plain_ms = cuda_time_ms(plain_fn, plain_iters or iters, spin_cycles=plain_spin)
        library_ms, lib_all = ((None, None) if library_fn is None
                               else med_ms(library_fn, iters, trials))
        enqueue_ms = cuda_time_ms(fn, iters, prefill=False)
        b, by = bound_ms(nbytes, flops, flop_per_s)
        self.rows[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                               bound_by=by, library_ms=library_ms, enqueue_ms=enqueue_ms)
        if trials > 1:
            self.rows[name].update(ms_trials=ms_all, library_trials=lib_all)
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

def check_inner_loop(rec, torch, ops, ref, gen, x0, H, c, xs, lam, eta, rho, K, d):
    """Kernel 1 at the main path's (500, 512), K = 5, on the resident route
    its width selects: against the plain version (the matvec sums in another
    order than the plain einsum: rtol = atol = 1e-4 of the largest output),
    with lam, with an ``off`` row and no lam at rho = 0, with a per-client
    step, and with bf16 rows (one bf16 ulp, 2^-7, of the largest output);
    the streaming route launched at the same width gives the same bits; its
    time beside the resident route's; each other resident width at m = 37
    (f32 and bf16, with lam and a per-client step), against the plain
    version and bitwise against the streaming route; then the streaming
    route at W = 1024, m = 64, the width it alone takes.
    ``gen`` draws the off row as before the resident route came; the draws
    it added come from a generator of their own."""
    from repro_torch.kernels import inner_loop as _il

    dev = gen.device
    own = seeded(torch, 19)
    m, w = x0.shape
    step = 1.0 / (1.0 / eta + rho)

    def close(got, want, what, f32=True):
        scale = max(1.0, float(want[0].float().abs().max()))
        e = max(max_err(a, b) for a, b in zip(got, want))
        tol = (1e-4 if f32 else 2.0 ** -7 + 1e-4) * scale
        check(all(a.dtype == b.dtype for a, b in zip(got, want)), f"{what}: dtype")
        check(e <= tol, f"inner_loop_affine {what}: error {e} > {tol}")
        log(f"inner_loop_affine {what}: max_abs_err {e:.3e} (tolerance {tol:.3e})")
        return e

    _il.last_route = None
    got = ops.inner_loop_affine(x0, H, c, xs, lam, step, rho, K)
    check(_il.last_route == "resident", f"inner_loop_affine ({m}, {w}): route {_il.last_route}")
    err = close(got, ref.inner_loop_affine_ref(x0, H, c, xs, lam, step, rho, K), "resident")
    streamed = _il.launch(x0, H, c, xs, lam, step, rho, K, path="stream")
    check(all(torch.equal(a, b) for a, b in zip(got, streamed)),
          "inner_loop_affine: the resident and streaming routes differ")

    # the variants SCAFFOLD (off row) and FedAvg (no off) run on the arena:
    # lam=None, rho = 0, the step eta; the per-client step of eta="auto"
    off = 0.1 * torch.randn(m, w, generator=gen, device=dev)
    off[:, d:] = 0
    steps = step * (0.5 + torch.rand(m, generator=own, device=dev))
    for o in (off, None):
        close(ops.inner_loop_affine(x0, H, c, xs, None, eta, 0.0, K, off=o),
              ref.inner_loop_affine_ref(x0, H, c, xs, None, eta, 0.0, K, off=o),
              f"off={o is not None} lam=None rho=0")
    close(ops.inner_loop_affine(x0, H, c, xs, lam, steps, rho, K),
          ref.inner_loop_affine_ref(x0, H, c, xs, lam, steps, rho, K), "per-client step")
    bf = [t.to(torch.bfloat16) for t in (x0, xs, lam, off)]
    close(ops.inner_loop_affine(bf[0], H, c, bf[1], bf[2], step, rho, K, off=bf[3]),
          ref.inner_loop_affine_ref(bf[0], H, c, bf[1], bf[2], step, rho, K, off=bf[3]),
          "bf16 rows", f32=False)
    check(_il.last_route == "resident", "inner_loop_affine bf16: not on the resident route")
    for what, args in (("f64 rows", (x0.double(), H, c, xs.double())),
                       ("a bf16 H", (bf[0], H.to(torch.bfloat16), c, bf[1]))):
        try:
            ops.inner_loop_affine(*args, None, step, rho, K)
        except TypeError as exc:
            check("dtype" in str(exc), f"inner_loop_affine {what}: {exc}")
        else:
            raise AssertionError(f"inner_loop_affine took {what}")

    nbytes = 4 * (m * w * w + 3 * m * w + w + 2 * m * w)
    flops = m * K * (2 * w * w + 8 * w)
    cluster = _il.cluster_size(w)
    rec.kernel("inner_loop_affine", err,
               lambda: ops.inner_loop_affine(x0, H, c, xs, lam, step, rho, K),
               lambda: ref.inner_loop_affine_ref(x0, H, c, xs, lam, step, rho, K), 20,
               nbytes, flops)
    stream_ms = cuda_time_ms(
        lambda: _il.launch(x0, H, c, xs, lam, step, rho, K, path="stream"), 20)
    occupancy = _il.max_active_clusters(w)
    rec.rows["inner_loop_affine"].update(
        inner_route="resident", cluster=cluster, smem_bytes=_il.resident_smem_bytes(w),
        max_active_clusters=occupancy, stream_ms=stream_ms)
    log(f"inner_loop_affine resident at ({m}, {w}), K {K}: clusters of {cluster}, "
        f"{_il.resident_smem_bytes(w)} B of shared memory a block; max active clusters "
        f"{occupancy}; the streaming route at this width {stream_ms:.4f} ms")

    # every other width the resident route takes, at a client count that is
    # a multiple of no cluster size
    for wr in (128, 256, 384, 640):
        check(_il.route(wr) == "resident", f"inner_loop_affine: W = {wr} not resident")
        A = torch.randn(37, wr, wr, generator=own, device=dev) / wr ** 0.5
        Hr = A @ A.transpose(1, 2) / 4.0
        xr, cr, lr = (torch.randn(37, wr, generator=own, device=dev) for _ in range(3))
        sr = torch.randn(wr, generator=own, device=dev)
        str_ = 0.05 + 0.1 * torch.rand(37, generator=own, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            xd, sd, ld = (t.to(dt) for t in (xr, sr, lr))
            _il.last_route = None
            got_r = ops.inner_loop_affine(xd, Hr, cr, sd, ld, str_, 0.9, K)
            check(_il.last_route == "resident", f"inner_loop_affine W = {wr}: route "
                                                f"{_il.last_route}")
            close(got_r, ref.inner_loop_affine_ref(xd, Hr, cr, sd, ld, str_, 0.9, K),
                  f"resident (37, {wr}) C = {_il.cluster_size(wr)} {str(dt)[6:]}",
                  f32=dt == torch.float32)
            streamed = _il.launch(xd, Hr, cr, sd, ld, str_, 0.9, K, path="stream")
            check(all(torch.equal(a, b) for a, b in zip(got_r, streamed)),
                  f"inner_loop_affine W = {wr}: the resident and streaming routes differ")

    # the streaming route at the width it alone takes, H (268 MB) above L2
    ms_, ws = 64, 1024
    A = torch.randn(ms_, ws, ws, generator=own, device=dev) / ws ** 0.5
    H2 = A @ A.transpose(1, 2) / 4.0
    del A
    x2, c2, l2 = (torch.randn(ms_, ws, generator=own, device=dev) for _ in range(3))
    s2 = torch.randn(ws, generator=own, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        xd, sd, ld = (t.to(dt) for t in (x2, s2, l2))
        e2 = close(ops.inner_loop_affine(xd, H2, c2, sd, ld, 0.1, 0.9, K),
                   ref.inner_loop_affine_ref(xd, H2, c2, sd, ld, 0.1, 0.9, K),
                   f"stream ({ms_}, {ws}) {str(dt)[6:]}", f32=dt == torch.float32)
        check(_il.last_route == "stream", f"inner_loop_affine ({ms_}, {ws}): route "
                                          f"{_il.last_route}, expected stream")
    t2 = cuda_time_ms(lambda: ops.inner_loop_affine(x2, H2, c2, s2, l2, 0.1, 0.9, K), 10)
    p2 = cuda_time_ms(lambda: ref.inner_loop_affine_ref(x2, H2, c2, s2, l2, 0.1, 0.9, K), 10)
    b2, _ = bound_ms(4 * (ms_ * ws * ws + 5 * ms_ * ws + ws), ms_ * K * (2 * ws * ws + 8 * ws))
    rec.rows["inner_loop_affine"]["stream_1024"] = dict(m=ms_, w=ws, ms=t2, plain_ms=p2,
                                                         bound_ms=b2)
    log(f"inner_loop_affine stream at ({ms_}, {ws}), K {K}: {t2:.4f} ms, plain {p2:.4f} ms, "
        f"bound {b2:.4f} ms (bytes)")
    del H2
    torch.cuda.synchronize()


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

    check_inner_loop(rec, torch, ops, ref, gen, x0, H, c, xs, lam, eta, rho, K, d)

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
    # kernel 3's row is timed with the server step (check_server_step)

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
    # timed as GPDMM's softmax round calls it: lam, x_bar's sum ("add")
    acc_a, acc_p = torch.randn_like(xa), torch.randn_like(xa)
    a_k, a_p = acc_a.clone(), acc_a.clone()
    e_arena = max(max_err(ops.fused_update_arena(xa, ga, xsa, la, 0.05, 4.0, acc=a_k),
                          ref.fused_update_arena_ref(xa, ga, xsa, la, 0.05, 4.0, acc=a_p)),
                  max_err(a_k, a_p))
    check(e_arena == 0.0, f"fused_update_arena with the sum: error {e_arena}")
    rec.kernel("fused_update_arena", e_arena,
               lambda: ops.fused_update_arena(xa, ga, xsa, la, 0.05, 4.0, acc=acc_a),
               lambda: ref.fused_update_arena_ref(xa, ga, xsa, la, 0.05, 4.0, acc=acc_p), 200,
               4 * (6 * ms_ * ws + ws), 8 * ms_ * ws)
    rec.rows["fused_update_arena"]["pair_ms"] = cuda_time_ms(
        lambda: step_pair(ops, ([xa], [ga], [xsa], [la], [acc_p]), 0.05, 4.0, True), 200)

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
    rec.kernel("scaffold_cv", max_err(ops.scaffold_cv(ci, xk, cs, xs, alpha),
                                      ref.scaffold_cv_ref(ci, xk, cs, xs, alpha)),
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
    # timed as GPDMM's pytree round calls it: lam, the server leaf
    # broadcast, x_bar's sum ("add")
    xf, gf, lf, af, ap = (torch.randn(m, d, generator=gen, device=dev) for _ in range(5))
    sf = torch.randn(d, generator=gen, device=dev)
    a_k, a_p = af.clone(), af.clone()
    e_leaf = max(max_err(ops.fused_update_leaves([xf], [gf], [sf], [lf], step, rho,
                                                 accs=[a_k])[0],
                         ref.fused_update_leaves_ref([xf], [gf], [sf], [lf], step, rho,
                                                     accs=[a_p])[0]),
                 max_err(a_k, a_p))
    check(e_leaf == 0.0, f"fused_update with the sum: error {e_leaf}")
    rec.kernel("fused_update", e_leaf,
               lambda: ops.fused_update_leaves([xf], [gf], [sf], [lf], step, rho, accs=[af]),
               lambda: ref.fused_update_leaves_ref([xf], [gf], [sf], [lf], step, rho,
                                                   accs=[ap]), 200,
               4 * (6 * m * d + d), 8 * m * d)
    # the pair each replaces on the main path: the step, then x_bar's plain add
    rec.rows["fused_update"]["pair_ms"] = cuda_time_ms(
        lambda: step_pair(ops, ([xf], [gf], [sf], [lf], [ap]), step, rho, False), 200)
    log(f"kernels 4 and 6 against the pair they replace (the step, then a plain add): "
        f"{rec.rows['fused_update_arena']['pair_ms']:.4f} and "
        f"{rec.rows['fused_update']['pair_ms']:.4f} ms")
    torch.cuda.synchronize()


# the server step (kernels 2-3 redesigned) at (label, m, W, dtype): the
# Fig. 2 arena, the reference benchmark's lm_flat (round_bench.py:61) and its
# population sweep's largest point (round_bench.py:361-374); the JSON line's
# rows: the population for the mean and the dual (the cohort round's server
# step), Fig. 2 f32 for the round tail with the mean (the full round's)
SERVER_SHAPES = (("fig2_bf16", 500, 512, "bfloat16"), ("lm_flat", 8, 1 << 20, "float32"),
                 ("pop_1e6", 10 ** 6, 1024, "float32"), ("fig2", 500, 512, "float32"))
UNIT_ROUNDOFF = 2.0 ** -24


def column_sums_f64(torch, a, chunk=1 << 16):
    """(sum_i a[i, j], sum_i |a[i, j]|) in float64, a row chunk at a time."""
    s = torch.zeros(a.shape[1], dtype=torch.float64, device=a.device)
    s_abs = torch.zeros_like(s)
    for r0 in range(0, a.shape[0], chunk):
        c = a[r0:r0 + chunk].double()
        s += c.sum(0)
        s_abs += c.abs().sum(0)
    return s, s_abs


def bf16_ulp(torch, x):
    """One bf16 step at each |x| (2^(e - 8) for |x| = f 2^e, f in [0.5, 1))."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_server_step(rec, torch, ops, ref, gen, out):
    """The server step's two passes and the round tail with the mean in its
    pass, at ``SERVER_SHAPES``: x_s' against ``torch.mean`` (f32 within
    2 (d + 2) u of each column's mean |u|, d the kernel's summation depth
    ``round_tail.depth_on`` and u = 2^-24, and within (d + 2) u of the float64
    mean; bf16 within one bf16 step), lam' bitwise the plain dual given the
    kernel's x_s' and given a random row, lam's column sum against
    ``torch.sum`` (within 2 (d + 2) u of each column's sum |lam|, (d + 2) u
    of the float64 sum; given the random row the sums are O(m), so a lost
    row block shows), both passes on integer data, where every order sums
    exactly (the mean the exact mean rounded once, the column sum exact: one
    lost row or column shows), the round tail's mean bitwise
    ``client_mean`` of its uplink, and two runs bitwise equal; each timed
    beside its plain composition and its bound."""
    from repro_torch.kernels import round_tail as RT

    dev = gen.device
    rho = 2.5
    f32 = torch.float32
    res = out["server_step"] = {}

    def colsum_err(cs, lam, d):
        """cs's largest error from torch.sum, having checked it against
        torch.sum and the float64 sum within their depth tolerances."""
        c64, ca64 = column_sums_f64(torch, lam)
        ctol = (d + 2) * UNIT_ROUNDOFF * ca64
        err_t = (cs.double() - torch.sum(lam.to(f32), dim=0).double()).abs()
        err_64 = (cs.double() - c64).abs()
        ok = bool((err_t <= 2 * ctol).all()) and bool((err_64 <= ctol).all())
        return ok, float(err_t.max()), float(err_64.max()), float(c64.abs().max())

    for label, m, w, dname in SERVER_SHAPES:
        dt = getattr(torch, dname)
        es = torch.empty((), dtype=dt).element_size()
        u = (torch.randn(m, w, generator=gen, device=dev) + 0.5).to(dt)
        d = RT.depth_on(u)
        x_k = ops.client_mean(u)
        x_t = torch.mean(u, dim=0)
        s64, a64 = column_sums_f64(torch, u)
        mean_abs = a64 / m
        err_t = (x_k.double() - x_t.double()).abs()
        err_64 = (x_k.double() - s64 / m).abs()
        tol = (d + 2) * UNIT_ROUNDOFF * mean_abs
        if dt == f32:
            check(bool((err_t <= 2 * tol).all()) and bool((err_64 <= tol).all()),
                  f"client_mean {label}: {float(err_t.max())} from torch.mean, "
                  f"{float(err_64.max())} from float64 (depth {d})")
        else:
            step = torch.maximum(bf16_ulp(torch, x_k), bf16_ulp(torch, x_t)).double()
            check(bool((err_t <= torch.maximum(step, tol)).all()),
                  f"client_mean {label}: {float(err_t.max())} from torch.mean (bf16)")
        del s64, a64
        lam_k, cs_k = ops.server_dual(u, x_k, rho)
        lam_p = ref.dual_from_uplink_ref(u, x_k, rho)
        lam_err = max_err(lam_k, lam_p)
        check(same_bits(torch, lam_k, lam_p),
              f"dual_from_uplink {label}: lam differs from the plain dual by {lam_err}")
        del lam_p
        ok, cerr_t, cerr_64, _ = colsum_err(cs_k, lam_k, d)
        check(ok, f"server_dual {label}: column sum {cerr_t} from torch.sum, {cerr_64} from "
                  f"float64 (depth {d})")
        again = ops.server_step(u, rho)
        check(all(same_bits(torch, a, b) for a, b in zip(again, (x_k, lam_k, cs_k))),
              f"server_step {label}: two runs differ")
        del again, lam_k
        # the dual given a random row, not the mean: lam's columns do not
        # cancel, their sums are O(m)
        x_r = torch.randn(w, generator=gen, device=dev).to(dt)
        lam_r, cs_r = ops.server_dual(u, x_r, rho)
        check(same_bits(torch, lam_r, ref.dual_from_uplink_ref(u, x_r, rho)),
              f"dual_from_uplink {label}: lam differs from the plain dual (a random row)")
        ok, rerr_t, rerr_64, rmax = colsum_err(cs_r, lam_r, d)
        check(ok, f"server_dual {label}: column sum {rerr_t} from torch.sum, {rerr_64} from "
                  f"float64, given a random row (largest sum {rmax}, depth {d})")
        del lam_r, cs_r, x_r
        # integer data: u in [0, 4], x_s a random integer row, rho 2, so
        # every partial sum is an integer below 2^24 and exact in f32 (and
        # lam's entries exact in bf16): the mean must be the exact mean
        # rounded once to f32, then to the dtype, the column sum exact
        u_i = torch.randint(0, 5, (m, w), generator=gen, device=dev).to(dt)
        x_i = torch.randint(0, 5, (w,), generator=gen, device=dev).to(dt)
        sum_i = torch.sum(u_i, dim=0, dtype=f32).double()
        check(same_bits(torch, ops.client_mean(u_i), (sum_i / m).to(f32).to(dt)),
              f"client_mean {label}: not the exact mean of integer data")
        lam_i, cs_i = ops.server_dual(u_i, x_i, 2.0)
        check(same_bits(torch, lam_i, ref.dual_from_uplink_ref(u_i, x_i, 2.0)),
              f"dual_from_uplink {label}: lam differs from the plain dual (integer data)")
        exact = (2.0 * (sum_i - m * x_i.double())).to(f32)
        check(same_bits(torch, cs_i, exact)
              and same_bits(torch, cs_i, torch.sum(lam_i.to(f32), dim=0)),
              f"server_dual {label}: column sum of integer data off by "
              f"{max_err(cs_i, exact)}")
        del u_i, x_i, sum_i, lam_i, cs_i, exact
        # the round tail with the mean in its pass
        xr, lm = (torch.randn(m, w, generator=gen, device=dev).to(dt) for _ in range(2))
        xs = torch.randn(w, generator=gen, device=dev).to(dt)
        li, up, xm = ops.round_tail_mean(xr, lm, xs, rho, with_lam_is=True)
        li_p, up_p = ref.round_tail_ref(xr, lm, xs, rho)
        ulp = 2.0 ** (-23 if dt == f32 else -7)
        up_err = max_err(up, up_p)
        check(same_bits(torch, li, li_p), f"round_tail_mean {label}: lam_is differs")
        check(up_err <= 2 * ulp * max(1.0, float(up_p.float().abs().max())),
              f"round_tail_mean {label}: uplink error {up_err}")
        check(same_bits(torch, xm, ops.client_mean(up)),
              f"round_tail_mean {label}: its mean differs from client_mean's")
        tail_mean_err = max_err(xm, torch.mean(up, dim=0))
        del li, li_p, up_p
        res[label] = row = {"m": m, "W": w, "dtype": dname, "depth": d,
                            "mean_err_vs_torch": float(err_t.max()),
                            "colsum_err_vs_torch": cerr_t,
                            "colsum_err_vs_torch_random_row": rerr_t,
                            "colsum_max_random_row": rmax,
                            "round_tail_mean_uplink_err": up_err,
                            "round_tail_mean_mean_err_vs_torch": tail_mean_err}
        errs = {"client_mean": float(err_t.max()),
                "dual_from_uplink": max(lam_err, cerr_t, rerr_t),
                "round_tail_mean": max(up_err, tail_mean_err)}
        iters = 200 if m * w < 1 << 22 else 20
        n = m * w
        calls = {
            "client_mean": (lambda: ops.client_mean(u), lambda: ref.client_mean_ref(u),
                            lambda: torch.mean(u, dim=0), es * (n + w), n),
            "dual_from_uplink": (lambda: ops.server_dual(u, x_k, rho),
                                 lambda: ref.server_dual_ref(u, x_k, rho), None,
                                 es * (2 * n + w) + 4 * w, 3 * n),
            "round_tail_mean": (lambda: ops.round_tail_mean(xr, lm, xs, rho, with_lam_is=False),
                                lambda: ref.round_tail_mean_ref(xr, lm, xs, rho,
                                                                with_lam_is=False), None,
                                es * (3 * n + 2 * w), 6 * n),
        }
        for name, (fn, plain, lib, nbytes, flops) in calls.items():
            rec.kernel(name, errs[name], fn, plain, iters, nbytes, flops, library_fn=lib)
            row[name] = {k: rec.rows[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                        "library_ms", "bound_ms", "bound_by",
                                                        "enqueue_ms")}
        # the two passes against their plain composition (torch.mean, the
        # plain dual, torch.sum)
        row["server_step"] = {"ms": cuda_time_ms(lambda: ops.server_step(u, rho), iters),
                              "plain_ms": cuda_time_ms(lambda: ref.server_step_ref(u, rho),
                                                       iters),
                              "bound_ms": bound_ms(es * (3 * n + w) + 4 * w, 4 * n)[0]}
        log(f"server step {label} (m {m}, W {w}, {dname}, depth {d}): mean err vs torch.mean "
            f"{row['mean_err_vs_torch']:.3e}, column sum err vs torch.sum "
            f"{row['colsum_err_vs_torch']:.3e} (given a random row {rerr_t:.3e} of sums up to "
            f"{rmax:.3e}); round tail's uplink err {up_err:.3e}, its mean's vs torch.mean "
            f"{tail_mean_err:.3e}; " + "; ".join(
                f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, bound {v['bound_ms']:.5f})"
                for k, v in row.items() if isinstance(v, dict)))
        del u, x_k, cs_k, xr, lm, xs, up, xm
        torch.cuda.empty_cache()
    for name in ("client_mean", "dual_from_uplink", "round_tail_mean"):
        rec.rows[name]["shapes"] = {label: {k: r[k] for k in ("m", "W", "dtype")} | r[name]
                                    for label, r in res.items()}
    for name, label in (("client_mean", "pop_1e6"), ("dual_from_uplink", "pop_1e6")):
        rec.rows[name].update(res[label][name])  # the population's row
    torch.cuda.synchronize()


# kernels 4 and 6 at the reference benchmark's LM shapes
# (benchmarks/round_bench.py:60-72): lm_flat, one (2^20,) leaf, is the
# arena; lm_tree's six leaves step in one launch on the pytree path
LM_TREE = dict(m=8, K=4, eta=0.1, rounds=10,
               shapes={"embed": (512, 384), "blk0_w1": (768, 512), "blk0_w2": (512, 768),
                       "blk1_w1": (768, 512), "blk1_w2": (512, 768), "bias": (768,)})
ACC_MODES = ("first", "add", "last", "only")


def step_cases(torch, gen, dtype=None):
    """The step's operands at lm_flat (the (8, 2^20) arena, x_s a row) and
    lm_tree (six leaves at m = 8, server leaves without the client dim):
    per case (x, g, server, lam, acc) lists, f32 unless ``dtype``."""
    dt = dtype or torch.float32
    rnd = lambda s: torch.randn(s, generator=gen, device=gen.device).to(dt)  # noqa: E731
    m = LM_TREE["m"]
    cases = {}
    tree = tuple(LM_TREE["shapes"].values())
    for name, shapes in (("lm_flat", ((1 << 20,),)), ("lm_tree", tree)):
        x, g, lam, acc = ([rnd((m,) + s) for s in shapes] for _ in range(4))
        cases[name] = (x, g, [rnd(s) for s in shapes], lam, acc)
    return cases


def step_bytes(case) -> int:
    """Each input read once and each output written once: x, g, lam and
    acc read, x' and acc written, the server leaves read once."""
    x, _, srv, _, _ = case
    return sum(6 * t.numel() * t.element_size() for t in x) + sum(
        t.numel() * t.element_size() for t in srv)


def step_pair(ops, case, step, rho, arena):
    """One client step as the parent's rounds ran it, for every leaf (the
    ``arena``'s one buffer, or each leaf): the step kernel (no running
    sum), then the plain pass xsum + x'."""
    x, g, srv, lam, acc = case
    for xx, gg, ss, ll, aa in zip(x, g, srv, lam, acc):
        if arena:
            out = ops.fused_update_arena(xx, gg, ss, ll, step, rho)
        else:
            out = ops.fused_update(xx, gg, ss, ll, step, rho)
        aa + out


def step_fused(ops, case, step, rho, arena):
    """The same step as one launch with the running sum in its pass."""
    x, g, srv, lam, acc = case
    if arena:
        ops.fused_update_arena(x[0], g[0], srv[0], lam[0], step, rho, acc=acc[0])
    else:
        ops.fused_update_leaves(x, g, srv, lam, step, rho, accs=acc)


def check_step_kernel(rec, torch, ops, ref, gen, out):
    """Kernels 4 and 6, one kernel over a table of segments: bitwise its
    plain version in f32 and bf16 on the arena (lm_flat), one leaf and
    lm_tree's six leaves in one launch, in every acc mode, scalar and
    per-client steps; then timed at lm_flat and lm_tree (lam, acc "add")
    beside the pair it replaces (the step without the sum, then the plain
    add), and host-paced on 1 and 6 small leaves."""
    from repro_torch.kernels import fused_update as FU

    m, rho, step = LM_TREE["m"], 2.5, 0.05
    steps = torch.rand(m, generator=gen, device=gen.device)
    for dt in (torch.float32, torch.bfloat16):
        for name, (x, g, srv, lam, acc0) in step_cases(torch, gen, dt).items():
            for mode in ACC_MODES:
                for st in (step, steps):
                    a_got, a_want = [a.clone() for a in acc0], [a.clone() for a in acc0]
                    ops.reset_launches()
                    if name == "lm_flat":
                        got = [ops.fused_update_arena(x[0], g[0], srv[0], lam[0], st, rho,
                                                      acc=a_got[0], acc_mode=mode,
                                                      acc_scale=0.25)]
                        want = [ref.fused_update_arena_ref(x[0], g[0], srv[0], lam[0], st,
                                                           rho, acc=a_want[0], acc_mode=mode,
                                                           acc_scale=0.25)]
                    else:
                        got = ops.fused_update_leaves(x, g, srv, lam, st, rho, accs=a_got,
                                                      acc_mode=mode, acc_scale=0.25)
                        want = ref.fused_update_leaves_ref(x, g, srv, lam, st, rho,
                                                           accs=a_want, acc_mode=mode,
                                                           acc_scale=0.25)
                    check(sum(ops.launches().values()) == 1,
                          f"step kernel {name}: {ops.launches()} launches for one step")
                    for a, b in zip(got + a_got, want + a_want):
                        check(same_bits(torch, a, b), f"step kernel {name} {dt} {mode}: differs")
            # one leaf, the server leaf broadcast and full
            for s_ in (srv[0], acc0[0]):
                got = ops.fused_update(x[0], g[0], s_, lam[0], steps, rho)
                check(same_bits(torch, got, ref.fused_update_ref(x[0], g[0], s_, lam[0], steps,
                                                                 rho)),
                      f"one leaf {name} {dt}: differs")
    log(f"step kernel: bitwise its plain version (f32, bf16; lm_flat arena, lm_tree's six "
        f"leaves in one launch, one leaf; modes {ACC_MODES}; scalar and per-client steps); "
        f"at most {FU.max_segments()} segments a launch")
    rows = {}
    for name, case in step_cases(torch, gen).items():
        kern = "fused_update_arena" if name == "lm_flat" else "fused_update"
        arena = name == "lm_flat"
        ms = cuda_time_ms(lambda: step_fused(ops, case, step, rho, arena), 20)
        pair_ms = cuda_time_ms(lambda: step_pair(ops, case, step, rho, arena), 20)
        b, by = bound_ms(step_bytes(case), 8 * sum(t.numel() for t in case[0]))
        rows[name] = dict(kernel=kern, ms=ms, pair_ms=pair_ms, bound_ms=b, bound_by=by,
                          bytes=step_bytes(case), launches_fused=1, launches_pair=len(case[0]))
        log(f"step kernel at {name} (f32, lam, acc): {ms:.4f} ms, bound {b:.4f} ms ({by}; "
            f"{step_bytes(case) / 1e6:.1f} MB), {b / ms:.2f} of the bound; the pair it replaces "
            f"(step kernel + plain add, {len(case[0])} leaves) {pair_ms:.4f} ms")
        rec.rows[kern].setdefault("at", {})[name] = rows[name]
    # host-paced: the host's cost of a call of 1 and 6 small leaves
    small = [torch.randn(m, 16, generator=gen, device=gen.device) for _ in range(6)]
    for n in (1, 6):
        lv = small[:n]
        rows[f"host_{n}_leaves_ms"] = cuda_time_ms(
            lambda: ops.fused_update_leaves(lv, lv, lv, lv, step, rho, accs=lv), 200,
            prefill=False)
    log(f"step kernel host-paced: 1 leaf {rows['host_1_leaves_ms']:.4f} ms, 6 leaves "
        f"{rows['host_6_leaves_ms']:.4f} ms a call")
    rec.rows["fused_update"]["host_paced_ms"] = {
        "1_leaf": rows["host_1_leaves_ms"], "6_leaves": rows["host_6_leaves_ms"]}
    out["step_kernel"] = rows
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


# kernels 9-10 timed at three shapes: (m, W, mc, buffers), f32
#   the Fig. 2 cohort round at p = 0.1 (50 of 500, lam and x_c, or u_hat
#   and x_c), the reference's bench_cohort at lm_flat p = 0.5
#   (round_bench.py:312-331: 4 of 8 rows of 2^20), and its population sweep's
#   largest point (round_bench.py:361-374: m = 10^6, W = 1,024, cohort 64;
#   lam, x_c and u_hat, GPDMM's gather with EF21 or faults)
ROW_SHAPES = {"fig2_p10": (500, 512, 50, 2), "lm_flat_p50": (8, 1 << 20, 4, 2),
              "pop_1e6": (10 ** 6, 1024, 64, 3)}
# bitwise at these (m, W, mc): the arenas of phases 4-9 and a population
# whose offsets pass 2^31 bytes
ROW_CHECKS = ((500, 512, 50), (500, 512, 250), (10, 7936, 5), (65536, 512, 656))


def row_tables(torch, gen, m, w, mc, dev):
    """A (population buffers, cohort rows) pair of f32 tables, a bf16 one
    and a mixed one (f32 of width w, bf16 of w / 2 rounded to 8, f32 of 8), with
    distinct ascending ids."""
    f32, bf16 = torch.float32, torch.bfloat16
    specs = {"f32": [(f32, w), (f32, w)], "bf16": [(bf16, w), (bf16, w)],
             "mixed": [(f32, w), (bf16, max(8, w // 16 * 8)), (f32, 8)]}
    idx = torch.sort(torch.randperm(m, generator=gen, device=dev)[:mc]).values
    out = {}
    for name, spec in specs.items():
        pops = tuple(torch.randn(m, wd, generator=gen, device=dev).to(dt) for dt, wd in spec)
        rows = tuple(torch.randn(mc, wd, generator=gen, device=dev).to(dt) for dt, wd in spec)
        out[name] = (pops, rows)
    return idx, out


def check_row_kernels(torch, ops, ref, gen):
    """Kernels 9-10 bitwise against their plain versions (index_select,
    index_copy_) at ``ROW_CHECKS``: f32, bf16 and mixed tables, int64 and
    int32 ids, one buffer and a table; the in-place scatter writes the
    cohort's rows and leaves every other row's bits as they were; the
    functional scatter leaves its input as it was."""
    dev = gen.device
    for m, w, mc in ROW_CHECKS:
        idx, tables = row_tables(torch, gen, m, w, mc, dev)
        silent = torch.ones(m, dtype=torch.bool, device=dev)
        silent[idx] = False
        for name, (pops, rows) in tables.items():
            for ids in (idx, idx.to(torch.int32)):
                what = f"({m}, {w}) mc={mc} {name} {ids.dtype}"
                check(same_bits(torch, ops.row_gather(pops[0], ids),
                                ref.row_gather_ref(pops[0], ids)), f"row_gather {what}")
                for got, a in zip(ops.row_gather_buffers(pops, ids), pops, strict=True):
                    check(same_bits(torch, got, ref.row_gather_ref(a, ids)),
                          f"row_gather table {what}")
                before = tuple(a.clone() for a in pops)
                got = ops.row_scatter(pops[0], ids, rows[0])
                check(torch.equal(pops[0], before[0]), "row_scatter wrote its input")
                check(same_bits(torch, got, before[0].index_copy(0, idx, rows[0])),
                      f"row_scatter {what}: differs from the plain version")
                done = ops.row_scatter_buffers_(pops, ids, rows)
                for d, a, b, r in zip(done, pops, before, rows, strict=True):
                    check(d is a, "row_scatter_buffers_ returned another tensor")
                    check(same_bits(torch, a[silent], b[silent]),
                          f"row_scatter_ {what}: a row outside the cohort changed")
                    check(same_bits(torch, a, b.index_copy(0, idx, r)),
                          f"row_scatter_ {what}: differs from the plain version")
        del tables
    log("row_gather / row_scatter: bitwise at (500, 512) mc 50 and 250, (10, 7936) mc 5, "
        "(65536, 512) mc 656; f32, bf16 and mixed tables; int64 and int32 ids; the in-place "
        "scatter left every other row as it was, the functional one its input")


def time_row_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 9-10 timed at ``ROW_SHAPES`` (f32 tables, int64 ids as
    ``cohort_indices`` gives them) beside their plain versions and the
    library calls (``index_select``, in-place ``index_copy_``, one per
    buffer), and the functional scatter (a copy of each buffer, then the
    kernel) beside its bound.  The first shape is the kernels' row in the
    JSON line; every shape goes under ``row_shapes``."""
    dev = gen.device
    res = out["row_shapes"] = {}
    for label, (m, w, mc, nb) in ROW_SHAPES.items():
        pops = tuple(torch.randn(m, w, generator=gen, device=dev) for _ in range(nb))
        rows = tuple(torch.randn(mc, w, generator=gen, device=dev) for _ in range(nb))
        idx = torch.sort(torch.randperm(m, generator=gen, device=dev)[:mc]).values
        for got, a in zip(ops.row_gather_buffers(pops, idx), pops, strict=True):
            check(same_bits(torch, got, ref.row_gather_ref(a, idx)), f"row_gather {label}")
        want = tuple(a.index_copy(0, idx, r) for a, r in zip(pops, rows))
        ops.row_scatter_buffers_(pops, idx, rows)
        check(all(same_bits(torch, a, b) for a, b in zip(pops, want)), f"row_scatter {label}")
        del want
        iters = 200 if m * w < 1 << 22 else 50
        moved = 2 * mc * w * 4 * nb + 8 * mc
        row = {"m": m, "W": w, "mc": mc, "buffers": nb}
        calls = {
            "row_gather": (lambda: ops.row_gather_buffers(pops, idx),
                           lambda: [ref.row_gather_ref(a, idx) for a in pops],
                           lambda: [torch.index_select(a, 0, idx) for a in pops]),
            "row_scatter": (lambda: ops.row_scatter_buffers_(pops, idx, rows),
                            lambda: [ref.row_scatter_ref_(a, idx, r) for a, r in zip(pops, rows)],
                            lambda: [a.index_copy_(0, idx, r) for a, r in zip(pops, rows)]),
        }
        for name, (fn, plain, lib) in calls.items():
            if label == "fig2_p10":
                rec.kernel(name, 0.0, fn, plain, iters, moved, 0, library_fn=lib)
                row[name] = {k: rec.rows[name][k]
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            else:
                row[name] = {"ms": cuda_time_ms(fn, iters),
                             "plain_ms": cuda_time_ms(plain, iters),
                             "library_ms": cuda_time_ms(lib, iters),
                             "bound_ms": bound_ms(moved, 0)[0]}
        # the functional route: a copy of every population buffer (read and
        # write), then the in-place kernel
        b, _ = bound_ms(2 * m * w * 4 * nb + moved, 0)
        row["row_scatter_functional"] = {
            "ms": cuda_time_ms(lambda: ops.row_scatter_buffers(pops, idx, rows),
                               iters if m * w < 1 << 26 else 10), "bound_ms": b}
        res[label] = row
        log(f"rows {label} (m {m}, W {w}, mc {mc}, {nb} buffers): " + "; ".join(
            f"{k} {v['ms']:.5f} ms (bound {v['bound_ms']:.5f}"
            + (f", plain {v['plain_ms']:.5f}, library {v['library_ms']:.5f})" if "plain_ms" in v
               else ")") for k, v in row.items() if isinstance(v, dict)))
        del pops, rows
    for name in ("row_gather", "row_scatter"):
        rec.rows[name]["shapes"] = {
            label: {"m": r["m"], "W": r["W"], "mc": r["mc"], "buffers": r["buffers"]} | r[name]
            | ({"functional": r["row_scatter_functional"]} if name == "row_scatter" else {})
            for label, r in res.items()}
    torch.cuda.synchronize()


def check_cohort_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 7-10 against their plain versions at phase 8's shapes, bitwise
    (f32 and bf16, a NaN in one client's leaf for EF21), then timed: the
    gather and scatter at ``ROW_SHAPES``, the EF21 pair at the full
    (500, 512) arena of run (c); the EF21 uplink in one pass
    (``ef21_update``) held and timed at ``EF21_CHECKS`` and ``EF21_TIMED``."""
    dev = gen.device
    check_row_kernels(torch, ops, ref, gen)
    time_row_kernels(rec, torch, ops, ref, gen, out)

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
    log("ef21_rowmax / ef21_apply: bitwise at (500, 512) leaves (4,) and (3, 1), "
        "(10, 7936) (62,); bits 8 and 4; f32 and bf16; a NaN in one client's leaf")
    check_ef21_update(torch, ops, ref, gen)

    m, w = 500, 512
    uh = torch.randn(m, w, generator=gen, device=dev)
    u = uh + 0.1 * torch.randn(m, w, generator=gen, device=dev)
    rm = ops.ef21_rowmax(u, uh)
    sc = ops._ef21_row_scales(rm, (w // 128,), 127.0)
    rec.kernel("ef21_rowmax", max_err(rm, ref.ef21_rowmax_ref(u, uh)),
               lambda: ops.ef21_rowmax(u, uh),
               lambda: ref.ef21_rowmax_ref(u, uh), 200, 2 * m * w * 4 + m * w // 128 * 4,
               3 * m * w)
    rec.kernel("ef21_apply", max_err(ops.ef21_apply(u, uh, sc, 8), ref.ef21_apply_ref(u, uh, sc, 8)),
               lambda: ops.ef21_apply(u, uh, sc, 8),
               lambda: ref.ef21_apply_ref(u, uh, sc, 8), 200,
               3 * m * w * 4 + m * w // 128 * 4, 7 * m * w)
    time_ef21_update(rec, torch, ops, ref, gen)
    torch.cuda.synchronize()


# the EF21 uplink in one pass (ops.ef21_update): held bitwise to its plain
# composition at phase 8's arenas and lm_flat, one leaf and two, on its own
# route and forced onto the wide one; timed at one leaf each
EF21_CHECKS = (((500, 512), ((4,), (3, 1))), ((10, 7936), ((62,),)),
               ((8, 1 << 20), ((8192,), (4096, 4096))))
EF21_TIMED = {"fig2": (500, 512, (4,)), "softmax": (10, 7936, (62,)),
              "lm_flat": (8, 1 << 20, (8192,))}


def check_ef21_update(torch, ops, ref, gen):
    """``ef21_update`` bit for bit its plain composition at ``EF21_CHECKS``:
    f32 and bf16, bits 8 and 4, a NaN in client 1's first leaf, an Inf and
    a -Inf in the last client's last leaf (each leaf NaN, the others as
    they were), client 0's last leaf with u = u_hat (scale 1e-12); a
    resident layout also on the wide route, whose apply pass also runs
    forwards; one launch a call on a resident route, two on the wide one."""
    from repro_torch.kernels import round_tail as rt

    dev = gen.device
    for (m, w), layouts in EF21_CHECKS:
        uh32 = torch.randn(m, w, generator=gen, device=dev)
        u32 = uh32 + 0.1 * torch.randn(m, w, generator=gen, device=dev)
        u32[1, 7] = float("nan")
        u32[m - 1, w - 5], u32[m - 1, w - 2] = float("inf"), -float("inf")
        for leaf_rows in layouts:
            u32z = u32.clone()
            last = 128 * leaf_rows[-1]
            u32z[0, w - last:] = uh32[0, w - last:]
            for dt in (torch.float32, torch.bfloat16):
                u, uh = u32z.to(dt), uh32.to(dt)
                own = rt.ef21_route(leaf_rows, dt)
                for bits in (8, 4):
                    want = ref.ef21_update_ref(u, uh, bits, leaf_rows)
                    for route, reverse in {(own, True), ("wide", True), ("wide", False)}:
                        n0 = ops.launches()["ef21_update"]
                        got = rt.ef21_update(u, uh, bits, leaf_rows, route, reverse=reverse)
                        n = ops.launches()["ef21_update"] - n0
                        check(same_bits(torch, got, want) and n == (2 if route == "wide" else 1),
                              f"ef21_update {dt} ({m}, {w}) {leaf_rows} bits={bits} {route} "
                              f"reverse={reverse}: differs or {n} launches")
                # the NaN's leaf of client 1 and the Infs' of the last client, whole
                n_nan = int(got.isnan().sum())
                check(n_nan == 128 * (leaf_rows[0] + leaf_rows[-1]),
                      f"ef21_update {dt} ({m}, {w}) {leaf_rows}: {n_nan} NaN values")
    log("ef21_update: bitwise its plain composition at (500, 512) (4,) and (3, 1), "
        "(10, 7936) (62,), (8, 2^20) (8192,) and (4096, 4096); f32 and bf16; bits 8 and 4; "
        "a NaN, an Inf and a -Inf, an all-zero leaf; the resident routes and the wide route "
        "(apply pass backwards and forwards)")


def time_ef21_update(rec, torch, ops, ref, gen):
    """``ef21_update`` at ``EF21_TIMED`` (f32, 8 bits, no NaN): its error,
    device and host-paced times, the plain composition's time and the
    tensor ops it dispatches besides ``torch.empty`` (none); beside it the two
    per-row kernels with the plain scales between them, and on the wide
    route its max pass alone and its apply pass walking forwards.  The
    bound counts u and u_hat read once and u_hat' written once; the wide
    route's own traffic reads them twice (``two_pass_bound_ms``)."""
    from repro_torch.kernels import round_tail as rt

    dev = gen.device
    rows = {}
    for label, (m, w, leaf_rows) in EF21_TIMED.items():
        uh = torch.randn(m, w, generator=gen, device=dev)
        u = uh + 0.1 * torch.randn(m, w, generator=gen, device=dev)
        fn = lambda: ops.ef21_update(u, uh, 8, leaf_rows)  # noqa: E731
        plain = lambda: ref.ef21_update_ref(u, uh, 8, leaf_rows)  # noqa: E731
        err = max_err(fn(), plain())
        check(err == 0.0, f"ef21_update {label}: error {err}")
        host_ops = round_ops(torch, fn)
        check(host_ops == 0, f"ef21_update {label}: {host_ops} tensor ops besides torch.empty")
        plan = rt.ef21_plan(leaf_rows, w, u.dtype)
        # 50 calls: the plain composition's ~13 launches a call stay within
        # the stream's queue of pending launches, so the device sets the pace
        iters = 50 if m * w < 1 << 22 else 40
        nbytes, flops = 3 * m * w * 4, 10 * m * w
        b, by = bound_ms(nbytes, flops)
        if label == "fig2":
            rec.kernel("ef21_update", err, fn, plain, iters, nbytes, flops)
        row = {"m": m, "W": w, "leaf_rows": list(leaf_rows), "route": plan.route,
               "threads": plan.threads, "chunks": plan.chunks, "max_abs_err": err,
               "ms": cuda_time_ms(fn, iters), "plain_ms": cuda_time_ms(plain, iters),
               "enqueue_ms": cuda_time_ms(fn, iters, prefill=False), "bound_ms": b,
               "bound_by": by, "host_ops": host_ops,
               "pair_ms": cuda_time_ms(lambda: ops.ef21_apply(u, uh, ops._ef21_row_scales(
                   ops.ef21_rowmax(u, uh), leaf_rows, 127.0), 8), iters)}
        if plan.route == "wide":
            _, c0, s0 = rt._ef21_launch_plan(tuple(leaf_rows), w, u.dtype, None)
            nleaf = len(plan.chunk0) - 1
            table = torch.empty((m, nleaf), dtype=torch.float32, device=dev)
            row.update(
                two_pass_bound_ms=bound_ms(5 * m * w * 4, flops)[0],
                max_pass_ms=cuda_time_ms(lambda: rt._ef21_launch(
                    rt.EF21_UPDATE, u, uh, None, table, 127.0, 0, rt.EF21_MAX, plan.threads,
                    plan.chunks, (c0, s0), plan.span0[-1], nleaf), iters),
                forward_ms=cuda_time_ms(lambda: rt.ef21_update(u, uh, 8, leaf_rows,
                                                               reverse=False), iters))
        rows[label] = row
        log(f"ef21_update {label} ({m}, {w}) {leaf_rows} {plan.route}: {row['ms']:.5f} ms "
            f"(bound {b:.5f}, plain {row['plain_ms']:.5f}, per-row kernels with plain scales "
            f"{row['pair_ms']:.5f}, host-paced {row['enqueue_ms']:.5f})"
            + (f"; max pass {row['max_pass_ms']:.5f}, apply forwards "
               f"{row['forward_ms']:.5f} ms, two-pass bound {row['two_pass_bound_ms']:.5f}"
               if plan.route == "wide" else ""))
        del u, uh
    rec.rows["ef21_update"]["shapes"] = rows


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


# screen_keep (kernel 11 with the keep rule in its launch) at the arena, the
# softmax arena, lm_flat (128 chunks a row), a ragged width and a masked
# screened round over 10^5 clients (past SELECT_ROWS: the cooperative
# select); timed f32 with the server row as ref and screen_mult 100 (the
# default); the JSON row at (500, 512)
KEEP_SHAPES = ((500, 512), (10, 7936), (8, 1 << 20), (5, 130), (10 ** 5, 1024))
KEEP_MULTS = (0.0, 100.0, 3.0)
# plain chains of tens of ops: few calls behind a long spin
CHAIN_ITERS, CHAIN_SPIN = 30, 8_000_000


def keep_cases(torch, gen, m, w, dtype, per_row):
    """``screen_keep``'s inputs at (m, W): ``fault_inputs``' rows (a NaN row,
    an Inf entry, a -Inf row, a blown-up row), ties (three distinct rows
    repeated), every row non-finite, and a NaN in the reference."""
    u, other, _, _, _, _ = fault_inputs(torch, gen, m, w, dtype, per_row)
    ties = (torch.arange(m, device=gen.device) % 3).float()[:, None].expand(m, w)
    nan_ref = other.clone()
    nan_ref.view(-1)[0] = float("nan")
    return (("faulted", u, other), ("ties", ties.to(dtype).contiguous(), torch.zeros_like(other)),
            ("all_non_finite", torch.full_like(u, float("nan")), other),
            ("nan_ref", u, nan_ref))


def check_screen_keep(rec, torch, ops, ref, gen, out):
    """``screen_keep`` against its plain rule on the card's own sq at
    ``KEEP_SHAPES``: f32 and bf16, a broadcast and a per-row reference, the
    cases of ``keep_cases``, screen_mult 0, 100 and 3; sq bitwise
    ``screen_uplink``'s, finite equal, the mask bitwise
    ``ref.keep_from_ref`` on them and the median bitwise
    ``ref.nanmedian_ref``; one launch (two on the select route), no tensor
    op besides ``torch.empty``, two runs equal.  Then, on the inputs it is
    timed on (f32, broadcast, screen_mult 100), the mask equal to the plain
    version's and sq within ``screen_uplink``'s rtol of the plain sum's (the
    row's ``max_abs_err``: the larger of the two errors); timed beside its bound (the uplink and the reference row read
    once, the mask written once), its plain version, and the card's old
    path (the ``screen_uplink`` kernel, then the plain rule), each also as
    the host enqueues it."""
    from repro_torch.kernels import screen as SC

    n_cases = 0
    for (m, w) in KEEP_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for per_row in (False, True):
                for label, u, r in keep_cases(torch, gen, m, w, dt, per_row):
                    fin_u, sq_u = ops.screen_uplink(u, r)
                    for mult in KEEP_MULTS:
                        route = SC.keep_route(m, mult > 0)
                        what = f"screen_keep {dt} ({m}, {w}) per_row={per_row} {label} {mult}"
                        n0 = ops.launches()["screen_keep"]
                        keep, fin, sq, med = SC.keep_parts(u, r, mult)
                        n = ops.launches()["screen_keep"] - n0
                        check(n == (2 if route == "select" else 1), f"{what}: {n} launches")
                        check(torch.equal(fin, fin_u) and same_bits(torch, sq, sq_u),
                              f"{what}: finite or sq differ from screen_uplink's")
                        check(torch.equal(keep, ref.keep_from_ref(fin_u, sq_u, mult)),
                              f"{what}: the mask differs from the plain rule's")
                        if mult > 0:
                            want = ref.nanmedian_ref(torch.where(fin_u, sq_u, math.nan))
                            check(same_bits(torch, med, want),
                                  f"{what}: median {float(med)} against {float(want)}")
                        check(torch.equal(ops.screen_keep(u, r, mult), keep),
                              f"{what}: differs from run to run")
                        n_cases += 1
                    del fin_u, sq_u
                del u, r
        torch.cuda.empty_cache()
    log(f"screen_keep: {n_cases} cases bitwise the plain rule on screen_uplink's sq (mask, "
        f"median, sq, finite) at {list(KEEP_SHAPES)}")

    rows = {}
    for (m, w) in KEEP_SHAPES:
        u, r, _, _, _, _ = fault_inputs(torch, gen, m, w, torch.float32, False)
        u = torch.where(torch.isfinite(u), u, 0.0)  # timed on finite rows
        ops.screen_keep(u, r, 100.0)
        host_ops = round_ops(torch, lambda: ops.screen_keep(u, r, 100.0))
        check(host_ops == 0, f"screen_keep ({m}, {w}): {host_ops} tensor ops besides torch.empty")
        fn = lambda: ops.screen_keep(u, r, 100.0)  # noqa: E731
        plain = lambda: ref.screen_keep_ref(u, r, 100.0)  # noqa: E731
        old = lambda: ref.keep_from_ref(*ops.screen_uplink(u, r), 100.0)  # noqa: E731
        # the error on the timed inputs, against the plain version (sq in
        # torch.sum's order): the masks equal, sq within screen_uplink's rtol
        keep, plain_keep = fn(), plain()
        check(torch.equal(keep, plain_keep),
              f"screen_keep ({m}, {w}): the mask differs from the plain version's "
              f"in {int((keep != plain_keep).sum())} rows")
        fin_p, sq_p = ref.screen_uplink_ref(u, r)
        _, fin_k, sq_k, _ = SC.keep_parts(u, r, 100.0)
        rtol = 1e-6 * math.sqrt(w / 128)
        sq_rel = float(((sq_k - sq_p).abs() / sq_p.abs().clamp(min=1e-30)).max())
        check(torch.equal(fin_k, fin_p) and sq_rel <= rtol,
              f"screen_keep ({m}, {w}): sq's relative error {sq_rel} > {rtol}, or finite differs")
        mask_err, sq_err = max_err(keep, plain_keep), max_err(sq_k, sq_p)
        iters = 200 if m * w < 1 << 22 else 30
        nbytes, flops = 4 * (m * w + w) + m, 3 * m * w
        b, by = bound_ms(nbytes, flops)
        if (m, w) == (500, 512):
            rec.kernel("screen_keep", max(mask_err, sq_err), fn, plain, iters, nbytes, flops,
                       plain_iters=CHAIN_ITERS, plain_spin=CHAIN_SPIN)
            rec.rows["screen_keep"].update(mask_max_abs_err=mask_err, sq_max_abs_err=sq_err,
                                           sq_max_rel_err=sq_rel)
        route = SC.keep_route(m, True)
        row = {"m": m, "W": w, "route": route, "mask_max_abs_err": mask_err,
               "sq_max_abs_err": sq_err, "sq_max_rel_err": sq_rel, "ms": cuda_time_ms(fn, iters),
               "plain_ms": cuda_time_ms(plain, CHAIN_ITERS, spin_cycles=CHAIN_SPIN),
               "old_path_ms": cuda_time_ms(old, CHAIN_ITERS, spin_cycles=CHAIN_SPIN),
               "enqueue_ms": cuda_time_ms(fn, iters, prefill=False),
               "old_path_enqueue_ms": cuda_time_ms(old, CHAIN_ITERS, prefill=False),
               "old_path_host_ops": round_ops(torch, old), "bound_ms": b, "bound_by": by}
        rows[f"{m}x{w}"] = row
        log(f"screen_keep ({m}, {w}) {route}: masks equal, sq within {sq_rel:.3e} of the plain "
            f"sum's (max abs {sq_err:.3e}); {row['ms']:.5f} ms (bound {b:.5f}, plain "
            f"{row['plain_ms']:.5f}, old path: screen_uplink + the plain rule "
            f"{row['old_path_ms']:.5f}); host-paced {row['enqueue_ms']:.5f} ms against "
            f"{row['old_path_enqueue_ms']:.5f} ({row['old_path_host_ops']} host ops)")
        del u, r
    rec.rows["screen_keep"]["shapes"] = rows
    out["screen_keep"] = rows
    torch.cuda.synchronize()


# SCAFFOLD's server step at the Fig. 2 arena, the softmax arena, lm_flat and
# a ragged width; timed f32 without a mask (the full round); the JSON row at
# (500, 512)
SCAFFOLD_SHAPES = ((500, 512), (10, 7936), (8, 1 << 20), (7, 130))


def after_mean_tol(torch, d, m, summed, mean_p, *steps, unit):
    """|card - plain| bound of a value the plain code forms from a column
    mean and a few rounded ops: the two means within 2 (d + 2) 2^-24 of the
    summed magnitudes over m and a rounding each (``unit``), then 3
    roundings of each later op's result (``steps``: (scale, magnitude))."""
    tol = 2 * (d + 2) * UNIT_ROUNDOFF * summed / m + 2 * unit * mean_p.abs()
    for scale, mag in steps:
        tol = scale * tol + 3 * unit * mag.abs()
    return tol


def old_scaffold_tail(torch, ops, ref, c_i, x_t, c_row, x_s, alpha, eta_g, mask):
    """The card's SCAFFOLD tail before the server step: the ``scaffold_cv``
    kernel, then the plain selects, means and column sum."""
    c_i_new = ops.scaffold_cv(c_i, x_t, c_row, x_s, alpha)
    x_up = x_t
    if mask is not None:
        c_i_new = torch.where(mask[:, None], c_i_new, c_i)
        x_up = torch.where(mask[:, None], x_t, x_s[None])
    x_s_new = x_s + ref.scalar_as(eta_g, x_s.dtype) * (torch.mean(x_up, dim=0) - x_s)
    c_new = c_row + torch.mean(c_i_new - c_i, dim=0)
    return c_i_new, x_s_new, c_new, torch.sum((c_i_new - c_new[None]).to(torch.float32), dim=0)


def check_scaffold_step(rec, torch, ops, ref, gen, out):
    """``scaffold_step`` at ``SCAFFOLD_SHAPES`` (f32 and bf16, scalar and
    per-client alpha, with and without a mask, eta_g 1 and 0.7): c_i'
    bitwise ``scaffold_cv``'s (c_i's bits on masked-out rows), x_s' and c'
    within ``after_mean_tol`` of the plain composition, the column sum of
    c_i' - c' within (d + 2) 2^-24 of its summed magnitudes from float64 and
    twice that from ``torch.sum`` (d = ``round_tail.depth_on``); on integer
    data (m a power of two, alpha 2, eta_g 0.5) c_i', x_s' and c' bitwise
    the plain ones; two launches a call, no ``scaffold_cv``, no tensor op
    besides ``torch.empty``, two runs equal.  Timed f32 without a mask
    beside its bound (c_i and x_t read, c_i' written, the rows once; the two
    passes' own traffic reads c_i' again: ``two_pass_bound_ms``), its plain
    version and the card's old tail (``scaffold_cv``, then plain ops)."""
    from repro_torch.kernels import round_tail as RT

    dev = gen.device
    f64 = torch.float64
    worst = {"x_s": 0.0, "c": 0.0, "colsum": 0.0}
    for (m, w) in SCAFFOLD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            ci, xt = (torch.randn(m, w, generator=gen, device=dev).to(dt) for _ in range(2))
            c, xs = (torch.randn(w, generator=gen, device=dev).to(dt) for _ in range(2))
            d = RT.depth_on(ci)
            unit = UNIT_ROUNDOFF if dt == torch.float32 else 2.0 ** -8
            for alpha in (2.5, 1.0 + 40.0 * torch.rand(m, generator=gen, device=dev)):
                for mask in (None, torch.rand(m, generator=gen, device=dev) < 0.6):
                    for eta_g in (1.0, 0.7):
                        what = (f"scaffold_step {dt} ({m}, {w}) alpha "
                                f"{'per-client' if torch.is_tensor(alpha) else alpha} "
                                f"mask={mask is not None} eta_g={eta_g}")
                        n0 = ops.launches()
                        got = ops.scaffold_step(ci, xt, c, xs, alpha, eta_g, mask)
                        n1 = ops.launches()
                        check(n1["scaffold_step"] - n0["scaffold_step"] == 2
                              and n1["scaffold_cv"] == n0["scaffold_cv"], f"{what}: launches")
                        want = ref.scaffold_step_ref(ci, xt, c, xs, alpha, eta_g, mask)
                        cv = ops.scaffold_cv(ci, xt, c, xs, alpha)
                        if mask is not None:
                            cv = torch.where(mask[:, None], cv, ci)
                        check(same_bits(torch, got[0], cv) and same_bits(torch, got[0], want[0]),
                              f"{what}: c_i' differs from scaffold_cv's")
                        x_up = xt if mask is None else torch.where(mask[:, None], xt, xs[None])
                        m_x = torch.mean(x_up, dim=0)
                        dx = (m_x - xs).to(f64)
                        tol_x = after_mean_tol(torch, d, m, column_sums_f64(torch, x_up)[1],
                                               m_x.to(f64), (1.0, dx), (eta_g, eta_g * dx),
                                               (1.0, want[1].to(f64)), unit=unit)
                        err_x = (got[1].to(f64) - want[1].to(f64)).abs()
                        delta = want[0] - ci
                        m_c = torch.mean(delta, dim=0)
                        tol_c = after_mean_tol(torch, d, m, column_sums_f64(torch, delta)[1],
                                               m_c.to(f64), (1.0, want[2].to(f64)), unit=unit)
                        err_c = (got[2].to(f64) - want[2].to(f64)).abs()
                        check(bool((err_x <= tol_x).all()) and bool((err_c <= tol_c).all()),
                              f"{what}: x_s' {float((err_x / tol_x).max())}, c' "
                              f"{float((err_c / tol_c).max())} of their tolerance")
                        terms = (got[0] - got[2][None]).to(torch.float32)
                        s64, a64 = column_sums_f64(torch, terms)
                        ctol = (d + 2) * UNIT_ROUNDOFF * a64
                        e64 = (got[3].to(f64) - s64).abs()
                        et = (got[3].to(f64) - torch.sum(terms, dim=0).to(f64)).abs()
                        check(bool((e64 <= ctol).all()) and bool((et <= 2 * ctol).all()),
                              f"{what}: column sum {float(e64.max())} from float64, "
                              f"{float(et.max())} from torch.sum (depth {d})")
                        worst["x_s"] = max(worst["x_s"], float((err_x / tol_x).max()))
                        worst["c"] = max(worst["c"], float((err_c / tol_c).max()))
                        worst["colsum"] = max(worst["colsum"], float((e64 / ctol).max()))
                        again = ops.scaffold_step(ci, xt, c, xs, alpha, eta_g, mask)
                        check(all(same_bits(torch, a, b) for a, b in zip(again, got)),
                              f"{what}: differs from run to run")
            del ci, xt, c, xs
        torch.cuda.empty_cache()
    # integer data: every sum of pass 1 exact in any order, every mean exact
    for (m, w) in ((512, 512), (8, 1 << 20), (4096, 128)):
        for dt in (torch.float32, torch.bfloat16):
            ci, xt = (torch.randint(-4, 5, (m, w), generator=gen, device=dev).to(dt)
                      for _ in range(2))
            c, xs = (torch.randint(-4, 5, (w,), generator=gen, device=dev).to(dt)
                     for _ in range(2))
            for mask in (None, torch.rand(m, generator=gen, device=dev) < 0.5):
                got = ops.scaffold_step(ci, xt, c, xs, 2.0, 0.5, mask)
                want = ref.scaffold_step_ref(ci, xt, c, xs, 2.0, 0.5, mask)
                check(all(same_bits(torch, a, b) for a, b in zip(got[:3], want[:3])),
                      f"scaffold_step {dt} ({m}, {w}) integer data: differs from the plain")
    out["scaffold_step_worst_over_tol"] = worst
    log(f"scaffold_step: c_i' bitwise scaffold_cv's; x_s', c' and the column sum within "
        f"{worst} of their tolerances; integer data bitwise; at {list(SCAFFOLD_SHAPES)}")

    rows = {}
    for (m, w) in SCAFFOLD_SHAPES[:3]:
        ci, xt = (torch.randn(m, w, generator=gen, device=dev) for _ in range(2))
        c, xs = (torch.randn(w, generator=gen, device=dev) for _ in range(2))
        fn = lambda: ops.scaffold_step(ci, xt, c, xs, 2.5, 1.0)  # noqa: E731
        plain = lambda: ref.scaffold_step_ref(ci, xt, c, xs, 2.5, 1.0)  # noqa: E731
        old = lambda: old_scaffold_tail(torch, ops, ref, ci, xt, c, xs, 2.5, 1.0,  # noqa: E731
                                        None)
        fn()
        host_ops = round_ops(torch, fn)
        check(host_ops == 0, f"scaffold_step ({m}, {w}): {host_ops} tensor ops")
        err = max(max_err(a, b) for a, b in zip(fn()[1:3], plain()[1:3]))
        iters = 200 if m * w < 1 << 22 else 30
        nbytes, flops = 4 * (3 * m * w + 4 * w) + 4 * w, 9 * m * w
        b, by = bound_ms(nbytes, flops)
        if (m, w) == (500, 512):
            rec.kernel("scaffold_step", err, fn, plain, iters, nbytes, flops,
                       plain_iters=CHAIN_ITERS, plain_spin=CHAIN_SPIN)
        row = {"m": m, "W": w, "max_abs_err_x_s_c": err, "ms": cuda_time_ms(fn, iters),
               "plain_ms": cuda_time_ms(plain, CHAIN_ITERS, spin_cycles=CHAIN_SPIN),
               "old_tail_ms": cuda_time_ms(old, CHAIN_ITERS, spin_cycles=CHAIN_SPIN),
               "enqueue_ms": cuda_time_ms(fn, iters, prefill=False),
               "old_tail_enqueue_ms": cuda_time_ms(old, CHAIN_ITERS, prefill=False),
               "old_tail_host_ops": round_ops(torch, old), "bound_ms": b, "bound_by": by,
               "pass1_bound_ms": bound_ms(4 * 3 * m * w, 0)[0],
               "pass2_bound_ms": bound_ms(4 * m * w, 0)[0],
               "two_pass_bound_ms": bound_ms(4 * (4 * m * w + 6 * w), 0)[0]}
        rows[f"{m}x{w}"] = row
        log(f"scaffold_step ({m}, {w}): {row['ms']:.5f} ms (bound {b:.5f}, passes' own "
            f"{row['two_pass_bound_ms']:.5f}; plain {row['plain_ms']:.5f}, old tail: "
            f"scaffold_cv + plain ops {row['old_tail_ms']:.5f}); host-paced "
            f"{row['enqueue_ms']:.5f} ms against {row['old_tail_enqueue_ms']:.5f} "
            f"({row['old_tail_host_ops']} host ops)")
        del ci, xt, c, xs
    rec.rows["scaffold_step"]["shapes"] = rows
    out["scaffold_step"] = rows
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
    # bf16 parameters: bf16 rows and f32 (H, c) into the inner loop; each
    # round from the CPU's state, within 4 bf16 ulps of each state's largest
    # value (the f32 loops differ by rounding, which can move a bf16 rounding)
    s_cpu = opt.init(torch.zeros(64, dtype=torch.bfloat16), 8)
    for _ in range(3):
        s_gpu = {k: v.cuda() for k, v in s_cpu.items()}
        s_cpu, _ = opt.round(s_cpu, prob.oracle(), prob.batch())
        s_gpu, _ = opt.round(s_gpu, gprob.oracle(), gprob.batch())
        for k in ("x_s", "lam_s", "x_c"):
            check(s_gpu[k].dtype == s_cpu[k].dtype == torch.bfloat16, f"bf16 round: {k} dtype")
            scale = max(1e-3, float(s_cpu[k].float().abs().max()))
            torch.testing.assert_close(s_gpu[k].cpu().float(), s_cpu[k].float(), rtol=0,
                                       atol=4 * 2.0 ** -8 * scale)
    log("small least squares, bf16 parameters: card == CPU (4 bf16 ulps) in 3 GPDMM rounds")


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


def x_bar_plain(torch, module, name, run) -> list:
    """Run ``run`` (one GPDMM round) with the inner loop ``module.name``
    wrapped: inside it every tensor op's outputs are kept alive (so no
    address is reused) and, for each call, the x_bar leaves it returns
    are looked up among them.  Returns per call (x_bar leaves, leaves a
    plain op wrote): 0 of them when the step kernel's running sum wrote
    x_bar, all of them when a plain pass (``xsum + x``, ``xsum * (1/K)``)
    did.  Allocations (``empty*``) write nothing and are not kept."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import tree_util as T

    class Keep(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.__name__.startswith("empty"):
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.outs.extend(t for t in outs if torch.is_tensor(t))
            return out

    inner, found = getattr(module, name), []

    def wrapped(*a, **kw):
        with Keep() as keep:
            x_K, x_bar = inner(*a, **kw)
        written = {t.untyped_storage().data_ptr() for t in keep.outs}
        bar = T.leaves(x_bar)
        found.append((len(bar), sum(t.untyped_storage().data_ptr() in written for t in bar)))
        return x_K, x_bar

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, inner)
    return found


def check_x_bar(torch, module, name, run, what) -> None:
    """The x_bar of every inner loop of one round is the step kernel's
    running sum: no plain op wrote it (``x_bar_plain``)."""
    found = x_bar_plain(torch, module, name, run)
    log(f"{what}: x_bar leaves written by a plain op, per inner loop (leaves, plain) {found}")
    check(bool(found) and all(n > 0 and p == 0 for n, p in found),
          f"{what}: a plain pass wrote x_bar {found}")


def lsq_phase(rec, prob, torch, ops, make, FederatedConfig, dev, prof=None):
    R, K, m = LSQ["rounds"], LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    rho = 1.0 / (K * eta)
    x0 = torch.zeros(prob.d, device=dev)
    d0 = float(prob.dist(x0))
    dists = {}
    per_round = {
        "gpdmm": dict(inner_loop_affine=1, round_tail_mean=1, dual_from_uplink=1),
        "agpdmm": dict(inner_loop_affine=1, round_tail_mean=1, dual_from_uplink=1),
        "scaffold": dict(inner_loop_affine=1, scaffold_step=2),
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
                v = invariants(torch, met, s, rho, m)
                if v is not None:
                    inv.append(v)

        state, metrics, counts, secs = run_rounds(
            torch, ops, opt, state, prob.oracle(), lambda r: prob.batch(), R, False, on_round)
        rec.add(counts)
        log(f"lsq {algo}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"||x - x*|| {d0:.4e} -> {trail}; launches {counts}; "
            f"invariant / (full, client-mean) rounding scale {readings(inv)}")
        check(counts == expected(ops, R, **per_round[algo]), f"lsq {algo}: launches {counts}")
        check(trail[-1] < trail[0] < d0, f"lsq {algo}: distance did not fall: {trail}")
        if algo in ("gpdmm", "agpdmm"):
            # full rounds: the client mean's scale alone, as before the
            # card's server step took the column sum in its own order
            check(max(v for _, v in inv) < 16.0,
                  f"lsq {algo}: dual-sum invariant (25) broken: {inv}")
        if algo == "scaffold":
            check(max(v for v, _ in inv) < 64.0,
                  f"lsq scaffold: sum_i (c_i - c) = 0 broken: {inv}")
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
              dict(fused_update_arena=SOFTMAX["K"], round_tail_mean=1, dual_from_uplink=1)),
    "agpdmm": (dict(algorithm="agpdmm"),
               dict(fused_update_arena=SOFTMAX["K"], round_tail_mean=1, dual_from_uplink=1)),
    "scaffold": (dict(algorithm="scaffold"),
                 dict(fused_update_arena=SOFTMAX["K"], scaffold_step=2)),
    "fedavg": (dict(algorithm="fedavg"), dict(fused_update_arena=SOFTMAX["K"])),
    "fedsplit_xs": (dict(algorithm="fedsplit", fedsplit_init="xs"),
                    dict(fused_update=SOFTMAX["K"])),
    "gpdmm_svrg": (dict(algorithm="gpdmm", variance_reduction="svrg"),
                   dict(fused_update_arena=SOFTMAX["K"], round_tail_mean=1,
                        dual_from_uplink=1)),
}


# ---------------------------------------------------------------------------
# phase 8: partial participation, the cohort engine and the EF21 uplink
# ---------------------------------------------------------------------------

# launches per round, read off the rounds' code: the cohort rounds gather
# the cohort's rows of every buffer they read in one launch and scatter the
# rows of every buffer they write in one, EF21 adds its one kernel and, on
# the cohort, the cached u_hat rows to the gather (FedAvg's only gather);
# the masked round selects with torch.where
PARTICIPATION_RUNS = {
    "a_gpdmm": (dict(algorithm="gpdmm", participation=0.1),
                dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                     row_gather=1, row_scatter=1)),
    "a_agpdmm": (dict(algorithm="agpdmm", participation=0.1),
                 dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                      row_gather=1, row_scatter=1)),
    "a_scaffold": (dict(algorithm="scaffold", participation=0.1),
                   dict(inner_loop_affine=1, scaffold_cv=1, row_gather=1, row_scatter=1)),
    "a_fedavg": (dict(algorithm="fedavg", participation=0.1),
                 dict(inner_loop_affine=1, row_scatter=1)),
    "b_gpdmm": (dict(algorithm="gpdmm", participation=0.1, uplink_bits=8),
                dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                     row_gather=1, row_scatter=1, ef21_update=1)),
    "b_agpdmm": (dict(algorithm="agpdmm", participation=0.1, uplink_bits=8),
                 dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                      row_gather=1, row_scatter=1, ef21_update=1)),
    "b_fedavg": (dict(algorithm="fedavg", participation=0.1, uplink_bits=8),
                 dict(inner_loop_affine=1, row_gather=1, row_scatter=1, ef21_update=1)),
    "c_gpdmm": (dict(algorithm="gpdmm", uplink_bits=8),
                dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                     ef21_update=1)),
    "d_gpdmm": (dict(algorithm="gpdmm", participation=0.1, cohort=False),
                dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1)),
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
                       dict(fused_update_arena=SOFTMAX["K"], round_tail=1, client_mean=1,
                            dual_from_uplink=1, row_gather=1, row_scatter=1,
                            ef21_update=1)),
    "fedavg_p50_ef21": (dict(algorithm="fedavg", participation=0.5, uplink_bits=8),
                        dict(fused_update_arena=SOFTMAX["K"], row_gather=1, row_scatter=1,
                             ef21_update=1)),
}


def invariants(torch, met, state, rho, m):
    """A round's invariant over its rounding scales, or None for FedAvg:
    (reading over the full scale, reading over the client mean's alone).

    (25) for GPDMM/AGPDMM: sum_i lam_i = rho m (mean u - x_s') is zero up to
    the f32 rounding of the client mean, ~ rho m eps ||x_s|| (the client
    mean's scale), and the roundings of lam's entries and of its column sum,
    eps |lam_ij| a term (the card's server step adds the column in its own
    order), ~ sqrt(m) eps ||lam||_F over the columns (the full scale adds
    it).  SCAFFOLD's sum_i (c_i - c) = 0 up to the rounding of the f32
    c-delta means, ~ m eps times a row of c_i (both readings)."""
    if "lam_sum_norm" in met:
        from repro_torch.core import tree_util as T

        lam_f = math.sqrt(sum(float(torch.sum(torch.square(x.float())))
                              for x in T.leaves(state["lam_s"])))
        mean_scale = F32_EPS * rho * m * max(1.0, float(torch.linalg.vector_norm(state["x_s"])))
        lsn = float(met["lam_sum_norm"])
        return lsn / (mean_scale + F32_EPS * math.sqrt(m) * lam_f), lsn / mean_scale
    if "c_sum_norm" in met:
        scale = m * F32_EPS * max(1.0, float(torch.linalg.vector_norm(state["c_i"]))
                                  / math.sqrt(m))
        return (float(met["c_sum_norm"]) / scale,) * 2
    return None


def readings(inv) -> list:
    """``invariants``' pairs for the log, rounded."""
    return [tuple(round(v, 3) for v in pair) for pair in inv]


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
            f"invariant / (full, client-mean) rounding scale {readings(inv)}")
        check(counts == expected(ops, R, **per_round), f"participation {label}: launches {counts}")
        check(trail[-1] < trail[0] < d0, f"participation {label}: distance did not fall: {trail}")
        if kw["algorithm"] in ("gpdmm", "agpdmm"):
            check(max(v for v, _ in inv) < 16.0,
                  f"participation {label}: invariant (25) broken: {inv}")
        if kw["algorithm"] == "scaffold":
            check(max(v for v, _ in inv) < 64.0,
                  f"participation {label}: sum_i (c_i - c) = 0 broken: {inv}")
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


# ---------------------------------------------------------------------------
# phase 8 population: the cohort round at the reference's population sweep
# ---------------------------------------------------------------------------

# round_bench.py:361-374 (POP_SWEEP_M, POP_WIDTH, POP_COHORT): the GPDMM
# cohort round at m = 10^5 and 10^6 clients of width 1,024 with a cohort of
# 64 (participation 64 / m), K = 4, eta 0.1 and the 0.3 x arena gradient of
# round_bench.py:115, the population in device memory (lam, x_c, u_hat:
# 12.3 GB at 10^6)
POPULATION = dict(ms=(10 ** 5, 10 ** 6), width=1024, cohort=64, K=4, eta=0.1, rounds=10)
POPULATION_LAUNCHES = dict(fused_update_arena=POPULATION["K"], round_tail=1, client_mean=1,
                           dual_from_uplink=1, row_gather=1, row_scatter=1)


def round_ops(torch, run) -> int:
    """The tensor ops ``run`` (one round) dispatches from the host,
    allocations (``empty*``) aside."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.__name__.startswith("empty")
            return func(*args, **(kwargs or {}))

    with Count() as c:
        run()
    return c.n


def ops_inside(torch, module, name, run) -> list:
    """Run ``run`` with ``module.name`` wrapped: the tensor ops (allocations
    aside) that each call of it dispatched."""
    inner, found = getattr(module, name), []

    def wrapped(*a, **kw):
        res = []
        found.append(round_ops(torch, lambda: res.append(inner(*a, **kw))))
        return res[0]

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, inner)
    return found


def population_setup(torch, make, make_oracle, FederatedConfig, m, dev, seed=59):
    """(opt, params, grad, batch) of the population cohort round at m."""
    P_ = POPULATION
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=P_["K"], eta=P_["eta"],
                               use_arena=True, participation=P_["cohort"] / m))
    gen = seeded(torch, seed)
    params = {"w": torch.randn(P_["width"], generator=gen, device=dev)}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    return opt, params, grad, {"d": torch.zeros(m, 1, device=dev)}


def population_run(torch, ops, opt, params, grad, batch, m, donate, rounds):
    """One population cell, with no other state alive: a fresh state, one
    warm-up round, then ``rounds`` rounds (``opt.round_`` when ``donate``):
    host-clock ms a round, launches, host ops and device-busy ms a round
    (``torch.profiler``, 3 more rounds) and the peak allocation of the
    timed rounds (``torch.cuda.max_memory_allocated``, the state
    included; ``peak_gb`` in all, ``round_peak_gb`` above what was allocated
    before the state was made).  Returns (numbers, launch counts)."""
    step = opt.round_ if donate else opt.round
    base = torch.cuda.memory_allocated()
    state, _ = step(opt.init(params, m), grad, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, metrics = step(state, grad, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / rounds
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          f"population m={m}: a metric is not finite")
    box = [state]

    def one():
        box[0], _ = step(box[0], grad, batch)

    n_ops = round_ops(torch, one)
    busy, _, events = device_profile(torch, lambda: [one() for _ in range(3)], 3)
    del state, box
    torch.cuda.empty_cache()
    got = {"round_ms": ms, "host_ops": n_ops, "device_busy_ms": busy, "peak_gb": peak / 1e9,
           "round_peak_gb": (peak - base) / 1e9,
           "launches": {k: v / rounds for k, v in counts.items() if v},
           "profile": events.table(sort_by="self_device_time_total", row_limit=10)}
    return got, counts


def population_phase(rec, torch, ops, make, make_oracle, FederatedConfig, dev, out):
    """The GPDMM cohort round at ``POPULATION``: functional and donated,
    each alone on the card (round ms, host ops, launches, device busy, peak
    allocation); one gather and one scatter a round; three donated rounds
    bitwise three functional ones, and the functional rounds leave their
    input as it was."""
    from repro_torch.core import tree_util as T

    res = out["population"] = {}
    R = POPULATION["rounds"]
    for m in POPULATION["ms"]:
        opt, params, grad, batch = population_setup(torch, make, make_oracle, FederatedConfig,
                                                    m, dev)
        s0 = opt.init(params, m)
        snap = {k: T.tmap(torch.clone, v) for k, v in s0.items()}
        sf = s0
        for _ in range(3):
            sf, _ = opt.round(sf, grad, batch)
        for k in s0:
            for a, b in zip(T.leaves(s0[k]), T.leaves(snap[k])):
                check(torch.equal(a, b), f"population m={m}: a functional round wrote {k}")
        del s0
        sd = snap
        for _ in range(3):
            sd, _ = opt.round_(sd, grad, batch)
        for k in sf:
            for a, b in zip(T.leaves(sf[k]), T.leaves(sd[k])):
                check(same_bits(torch, a, b) if a.is_floating_point() else torch.equal(a, b),
                      f"population m={m}: donated != functional in {k}")
        del sf, sd, snap
        torch.cuda.empty_cache()
        for mode in ("functional", "donated"):
            got, counts = population_run(torch, ops, opt, params, grad, batch, m,
                                         mode == "donated", R)
            rec.add(counts)
            check(counts == expected(ops, R, **POPULATION_LAUNCHES),
                  f"population m={m} {mode}: launches {counts}")
            res[f"m{m}_{mode}"] = got
            log(f"population m={m} W={POPULATION['width']} cohort {POPULATION['cohort']} "
                f"{mode}: {got['round_ms']:.4f} ms/round, busy {got['device_busy_ms']:.4f} ms, "
                f"{got['host_ops']} host ops, peak {got['peak_gb']:.3f} GB "
                f"({got['round_peak_gb']:.3f} GB the round's), "
                f"launches {got['launches']}")
            log(got["profile"])
    log("population: donated rounds bitwise the functional ones at m = 10^5 and 10^6")


# ---------------------------------------------------------------------------
# phase "popstore": the host-resident population store on the card
# ---------------------------------------------------------------------------

# (a) the Fig. 2 problem at participation 0.1 (a cohort of 50), 10 rounds of
# each variant against the device cohort round from the same start
POPSTORE_ROUNDS = 10
POPSTORE_VARIANTS = {
    "gpdmm": dict(algorithm="gpdmm"),
    "agpdmm": dict(algorithm="agpdmm"),
    "scaffold": dict(algorithm="scaffold"),
    "fedavg": dict(algorithm="fedavg"),
    "gpdmm_ef21": dict(algorithm="gpdmm", uplink_bits=8),
    "agpdmm_ef21": dict(algorithm="agpdmm", uplink_bits=8),
    "fedavg_ef21": dict(algorithm="fedavg", uplink_bits=8),
    "gpdmm_screened": dict(algorithm="gpdmm", faults=dict(dropout=0.1, seed=7), screen=True),
}
# launches a popstore round (the LSQ oracle): the lazy dual and the round
# tail for GPDMM/AGPDMM, SCAFFOLD's control-variate refresh; no row kernels
POPSTORE_LAUNCHES = {
    "gpdmm": dict(inner_loop_affine=1, dual_from_uplink=1, round_tail=1),
    "agpdmm": dict(inner_loop_affine=1, dual_from_uplink=1, round_tail=1),
    "scaffold": dict(inner_loop_affine=1, scaffold_cv=1),
    "fedavg": dict(inner_loop_affine=1),
}
POPSTORE_LM_FLAT = dict(m=8, width=1 << 20, K=4, eta=0.1, participation=0.5, rounds=10)
POPSTORE_HOST_ATOL = 1e-5  # tests/test_popstore.py: atol after scaling by max(1, max |a|)


def scaled_err(torch, got, want) -> float:
    """max |got - want| / max(1, max |want|) (tests/test_popstore.py's
    ``_close``), both read in f32 on the host."""
    import numpy as np

    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = want.detach().float().cpu().numpy() if torch.is_tensor(want) else np.asarray(want,
                                                                                      np.float32)
    g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    return float(np.abs(g - w).max()) / scale


def popstore_conformance(rec, prob, torch, ops, make, FederatedConfig, FaultConfig, popstore,
                         dev, out):
    """(a) Each variant: ``Runner.round`` against the device cohort round
    from the same start, x_s and every store buffer within
    ``POPSTORE_HOST_ATOL`` (scaled), GPDMM's lazy dual against the device
    round's lam_s; the popstore rounds' launches as the body's code gives
    them.  EF21 variants start each popstore round from the device round's
    state (its quantiser rounds to a grid: a rounding apart, an element can
    land a step apart and a free-running pair would carry it)."""
    import numpy as np

    from repro_torch.core import resolved_rho

    res = out["popstore_conformance"] = {}
    R, K, m = POPSTORE_ROUNDS, LSQ["K"], LSQ["m"]
    eta = 0.5 / prob.L
    x0 = torch.zeros(prob.d, device=dev)
    for label, kw in POPSTORE_VARIANTS.items():
        kw = dict(kw)
        if "faults" in kw:
            kw["faults"] = FaultConfig(**kw["faults"])
        cfg = FederatedConfig(**kw, inner_steps=K, eta=eta, use_arena=True, participation=0.1,
                              cohort=True, popstore=True)
        algo, ef21 = cfg.algorithm, cfg.uplink_bits is not None
        rho = resolved_rho(cfg)
        opt = make(cfg)
        runner = popstore.Runner(cfg, prob.oracle())
        ds, ps = opt.init(x0, m), runner.init(x0, m)
        per_round = dict(POPSTORE_LAUNCHES[algo])
        if ef21:
            per_round["ef21_update"] = 1
        if cfg.screen is True:
            per_round["screen_keep"] = 1
        total = {k.name: 0 for k in ops.KERNELS}
        worst = {}
        for r in range(R):
            if ef21 and r:
                ps = {"x_s": ds["x_s"], "round": r,
                      "pop": {n: ds[n].cpu().numpy() for n in popstore.POP_BUFFERS[algo]},
                      "pop_sum": popstore._col_sum64(ds["u_hat"].cpu().numpy()),
                      "pop_sum_comp": np.zeros(ds["u_hat"].shape[1])}
            ds, _ = opt.round(ds, prob.oracle(), prob.batch())
            torch.cuda.synchronize()
            ops.reset_launches()
            ps, met = runner.round(ps, prob.batch())
            torch.cuda.synchronize()
            for k, v in ops.launches().items():
                total[k] += v
            errs = {"x_s": scaled_err(torch, runner.server_params(ps), ds["x_s"])}
            for n in popstore.POP_BUFFERS[algo]:
                errs[n] = scaled_err(torch, ps["pop"][n], ds[n])
            if algo == "scaffold":
                errs["c"] = scaled_err(torch, ps["c"], ds["c"])
            if algo == "gpdmm":
                x_row = runner._spec.pack(runner.server_params(ps)).cpu().numpy()
                errs["lazy_dual"] = scaled_err(torch, rho * (ps["pop"]["u_hat"] - x_row[None]),
                                               ds["lam_s"])
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            check(all(v <= POPSTORE_HOST_ATOL for v in errs.values()),
                  f"popstore {label} round {r}: against the device cohort round {errs}")
            check(float(met["used_popstore"]) == 1.0, f"popstore {label}: used_popstore")
        rec.add(total)
        check(total == expected(ops, R, **per_round), f"popstore {label}: launches {total}")
        res[label] = {"worst_scaled_err": worst, "ring": [runner.ring_hits, runner.ring_misses],
                      "launches_per_round": {k: v / R for k, v in total.items() if v}}
        log(f"popstore {label}: {R} rounds == device cohort round, worst scaled errors "
            f"{ {k: f'{v:.2e}' for k, v in worst.items()} }; ring hits/misses "
            f"{runner.ring_hits}/{runner.ring_misses}; launches/round "
            f"{res[label]['launches_per_round']}")


def host_round_ms(torch, step, rounds):
    """Host-clock ms a round over ``rounds`` calls of ``step`` (each ends
    in the round's own sync for the store; a device round is synchronized
    after the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / rounds


def popstore_lm_flat(rec, torch, ops, make, make_oracle, FederatedConfig, popstore, gen, dev,
                     out):
    """(b) The reference benchmark's lm_flat cell (``round_bench.py:405-425``):
    m = 8, one 2^20 leaf, GPDMM, K = 4, eta = 0.1, participation 0.5, the
    native 0.3 x gradient; host-clock ms a round of the store against the
    device cohort round at the same key, ring hits and misses, and both
    runs' server rows within the store's tolerance."""
    from repro_torch.core import tree_util as T

    c = POPSTORE_LM_FLAT
    m, K, R = c["m"], c["K"], c["rounds"]
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=K, eta=c["eta"], use_arena=True,
                          participation=c["participation"], cohort=True, popstore=True,
                          popstore_min_clients=1)
    params = {"w": torch.randn(c["width"], generator=gen, device=dev)}
    grad = make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                       grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
    batch = {"dummy": torch.zeros(m, 1, device=dev)}
    opt = make(cfg)
    runner = popstore.Runner(cfg, grad)
    box = {"pop": runner.init(params, m), "dev": opt.init(params, m)}

    def pop_round():
        box["pop"], _ = runner.round(box["pop"], batch)

    def dev_round():
        box["dev"], _ = opt.round_(box["dev"], grad, batch)

    pop_round()
    dev_round()
    ops.reset_launches()
    pop_ms = host_round_ms(torch, pop_round, R)
    counts = ops.launches()
    rec.add(counts)
    check(counts == expected(ops, R, fused_update_arena=K, dual_from_uplink=1, round_tail=1),
          f"popstore lm_flat: launches {counts}")
    dev_ms = host_round_ms(torch, dev_round, R)
    err = scaled_err(torch, box["pop"]["x_s"]["w"], box["dev"]["x_s"]["w"])
    check(err <= POPSTORE_HOST_ATOL, f"popstore lm_flat: x_s against the device round {err}")
    spans = traced_spans(torch, pop_round, 3)
    got = {"popstore_ms": pop_ms, "device_cohort_ms": dev_ms, "x_s_scaled_err": err,
           "span_ms": spans,
           "ring": [runner.ring_hits, runner.ring_misses],
           "device_bytes": popstore.device_bytes(cfg, c["width"], m)}
    out["popstore_lm_flat"] = got
    log(f"popstore lm_flat (m={m}, W=2^20, cohort {T.cohort_count(m, c['participation'])}): "
        f"{pop_ms:.4f} ms/round against the device cohort round's {dev_ms:.4f}; ring "
        f"hits/misses {runner.ring_hits}/{runner.ring_misses}; x_s scaled error {err:.2e}; "
        f"median span ms {spans}")


def traced_spans(torch, step, rounds) -> dict:
    """Median ms of each ``popstore/*`` span over ``rounds`` calls of
    ``step`` with the global tracer on (no file: the events are drained)."""
    from repro_torch import telemetry

    tr = telemetry.get_tracer()
    tr.configure(enabled=True)
    try:
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
    finally:
        tr.configure(enabled=False)
    spans = {}
    for e in tr.drain():
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in spans.items()}


def mem_available_bytes():
    """``MemAvailable`` of /proc/meminfo (``round_bench.py:376-384``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def body_syncs(torch, runner, state, batch) -> list:
    """The host syncs that one popstore body makes (the draw, the staging
    and the copies back aside): the body alone under
    ``torch.cuda.set_sync_debug_mode("warn")``; (file:line, message) of
    each."""
    import warnings

    r = int(state["round"])
    staged = runner._take_prefetch(r, state["pop"]) or runner._stage_host(r, state["pop"])
    if staged.dev_rows is None:
        runner._h2d(staged)
    runner._next = staged
    round_t = torch.full((), r, dtype=torch.int32, device=runner.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner._body({"x_s": state["x_s"]}, staged.dev_rows, staged.idx_dev, round_t, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno} {str(w.message)[:60]}" for w in caught
            if "called a synchronizing" in str(w.message)]


def popstore_population(rec, torch, ops, make, make_oracle, FederatedConfig, popstore, dev,
                        out):
    """(c) The population sweep of ``POPULATION`` through the store: ms a
    round, the draw's ms, launches, device-busy ms, ring hits and misses,
    the peak device allocation of the timed rounds above what was allocated
    before the store was made (below 1 GB at 10^6), and the incremental sum
    against a dense f64 column sum of the store after the run; beside it
    phase "8 population"'s device-resident figures of this run.  An m whose
    host store does not fit twice into ``MemAvailable`` is skipped with a
    line that says so."""
    import numpy as np

    from repro_torch.core import tree_util as T
    from repro_torch.core.gpdmm import participation_key

    P_ = POPULATION
    res = out["popstore_population"] = {}
    R, K, W = P_["rounds"], P_["K"], P_["width"]
    avail = mem_available_bytes()
    for m in P_["ms"]:
        host_bytes = 2 * m * W * 4
        if avail is not None and 2 * host_bytes > avail:
            log(f"popstore population m={m}: SKIPPED, the host store needs "
                f"{host_bytes / 1e9:.2f} GB x2 and {avail / 1e9:.2f} GB are available")
            res[f"m{m}"] = {"skipped": True, "host_bytes": host_bytes, "available": avail}
            continue
        cfg = FederatedConfig(algorithm="gpdmm", inner_steps=K, eta=P_["eta"], use_arena=True,
                              participation=P_["cohort"] / m, cohort=True, popstore=True)
        _, params, grad, batch = population_setup(torch, make, make_oracle, FederatedConfig,
                                                  m, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        runner = popstore.Runner(cfg, grad)
        box = [runner.init(params, m)]
        init_s = time.perf_counter() - t0

        def one():
            box[0], _ = runner.round(box[0], batch)

        one()  # warm-up
        syncs = body_syncs(torch, runner, box[0], batch)
        # the prefetch overlaps the body only if the body never waits for
        # the device
        check(not syncs, f"popstore population m={m}: the body synchronizes {syncs}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ms = host_round_ms(torch, one, R)
        counts = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        rec.add(counts)
        check(counts == expected(ops, R, fused_update_arena=K, dual_from_uplink=1,
                                 round_tail=1),
              f"popstore population m={m}: launches {counts}")
        busy, _, events = device_profile(torch, lambda: [one() for _ in range(3)], 3)
        draws = []
        for r in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            T.cohort_indices(participation_key(cfg, r), m, cfg.participation, dev)
            torch.cuda.synchronize()
            draws.append(1e3 * (time.perf_counter() - t1))
        draw_ms = sorted(draws)[len(draws) // 2]
        state = box[0]
        t1 = time.perf_counter()
        dense = popstore._col_sum64(state["pop"]["u_hat"])
        dense_s = time.perf_counter() - t1
        scale = max(1.0, float(np.abs(dense).max()))
        sum_err = float(np.abs(state["pop_sum"] - dense).max()) / scale
        check(sum_err <= F32_EPS / 2, f"popstore population m={m}: running sum {sum_err:.3e}")
        x_row = state["x_s"]["w"].cpu().numpy().astype(np.float64)
        mean32 = (dense / m).astype(np.float32).astype(np.float64)
        ulps = float(np.max(np.abs(x_row - mean32) / np.spacing(np.abs(mean32).astype(np.float32))))
        check(ulps <= 1.0, f"popstore population m={m}: x_s {ulps} f32 ulps from the dense mean")
        round_peak = (peak - base) / 1e9
        if m >= 10 ** 6:
            check(round_peak < 1.0, f"popstore population m={m}: peak {round_peak:.3f} GB")
        device_resident = out.get("population", {}).get(f"m{m}_donated", {})
        got = {"round_ms": ms, "draw_ms": draw_ms, "device_busy_ms": busy,
               "peak_gb": peak / 1e9, "round_peak_gb": round_peak,
               "ring": [runner.ring_hits, runner.ring_misses], "init_s": init_s,
               "host_bytes": host_bytes, "device_bytes": popstore.device_bytes(cfg, W, m),
               "body_syncs": syncs, "sum_scaled_err": sum_err, "x_s_ulps": ulps,
               "dense_sum_s": dense_s,
               "launches": {k: v / R for k, v in counts.items() if v},
               "device_resident": {k: device_resident.get(k) for k in
                                   ("round_ms", "device_busy_ms", "peak_gb", "round_peak_gb")},
               "profile": events.table(sort_by="self_device_time_total", row_limit=10)}
        res[f"m{m}"] = got
        spans = traced_spans(torch, one, 3)
        got["span_ms"] = spans
        log(f"popstore population m={m} W={W} cohort {P_['cohort']}: {ms:.4f} ms/round "
            f"(draw {draw_ms:.4f} ms), busy {busy:.4f} ms, peak {peak / 1e9:.3f} GB "
            f"({round_peak:.4f} GB above the set-up), ring hits/misses "
            f"{runner.ring_hits}/{runner.ring_misses}, body host syncs {syncs}, host store "
            f"{host_bytes / 1e9:.2f} GB (init {init_s:.2f} s), running sum scaled error "
            f"{sum_err:.2e}, x_s {ulps:.0f} ulps from the dense mean; launches "
            f"{got['launches']}; the device-resident donated round of phase 8: "
            f"{got['device_resident']}; median span ms {spans}")
        log(got["profile"])
        del box, state, runner
        torch.cuda.empty_cache()


def popstore_telemetry(torch, make, make_oracle, FederatedConfig, popstore, dev, out):
    """(d) One population round at m = 10^5 with the global tracer on,
    writing a trace file that must load back with every ``popstore/*`` span
    and the ring counter; the same round's host-clock ms with tracing off
    and on, alternately (median of 5 each)."""
    import tempfile

    from repro_torch import telemetry

    P_ = POPULATION
    m = P_["ms"][0]
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=P_["K"], eta=P_["eta"],
                          use_arena=True, participation=P_["cohort"] / m, cohort=True,
                          popstore=True)
    _, params, grad, batch = population_setup(torch, make, make_oracle, FederatedConfig, m, dev)
    runner = popstore.Runner(cfg, grad)
    box = [runner.init(params, m)]

    def one():
        box[0], _ = runner.round(box[0], batch)

    one()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "popstore_trace.json"
        times = {"off": [], "on": []}
        try:
            for _ in range(5):
                for mode in ("off", "on"):
                    telemetry.configure(enabled=mode == "on", trace_out=path)
                    times[mode].append(host_round_ms(torch, one, 1))
        finally:
            telemetry.close()
            telemetry.configure(enabled=False)
        events = telemetry.load_trace(path)
    names = {e["name"] for e in events}
    want = {"popstore/h2d_stage", "popstore/prefetch_draw", "popstore/device_round",
            "popstore/prefetch_gather", "popstore/device_sync", "popstore/scatter_back",
            "popstore/ring"}
    check(want <= names, f"popstore telemetry: spans {sorted(names)}")
    ring = [e for e in events if e["name"] == "popstore/ring"]
    check(all(e["ph"] == "C" for e in ring) and len(ring) == 5,
          f"popstore telemetry: ring counter {ring}")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    out["popstore_telemetry"] = {"round_ms_off": med["off"], "round_ms_on": med["on"],
                                 "events": len(events),
                                 "span_ms": {k: sorted(v)[len(v) // 2] for k, v in spans.items()}}
    log(f"popstore telemetry m={m}: {len(events)} events, spans {sorted(names)}; round "
        f"{med['off']:.4f} ms tracing off, {med['on']:.4f} ms on (medians of 5, alternated); "
        f"median span ms {out['popstore_telemetry']['span_ms']}")


def lazy_dual_cost(rec, torch, ops, ref, gen, out):
    """The lazy dual on the card is ``server_dual`` with its column sum
    dropped: at a cohort of 64 x 1,024 its time beside the plain elementwise
    dual, and the bounds with and without the column sum."""
    u = torch.randn(64, 1024, generator=gen, device=gen.device)
    x = torch.randn(1024, generator=gen, device=gen.device)
    rho = 0.5
    ms = cuda_time_ms(lambda: ops.dual_from_uplink(u, x, rho), 200)
    plain = cuda_time_ms(lambda: ref.dual_from_uplink_ref(u, x, rho), 200)
    err = max_err(ops.dual_from_uplink(u, x, rho), ref.dual_from_uplink_ref(u, x, rho))
    elem, _ = bound_ms((2 * 64 + 1) * 1024 * 4, 0)
    with_sum, _ = bound_ms((2 * 64 + 2) * 1024 * 4, 0)
    out["lazy_dual"] = {"ms": ms, "plain_ms": plain, "bound_ms": elem,
                        "bound_with_sum_ms": with_sum, "max_abs_err": err}
    check(err == 0.0, f"lazy dual: {err}")
    log(f"lazy dual (64, 1024): dual_from_uplink {ms:.5f} ms (the column sum computed and "
        f"dropped) against the plain elementwise dual {plain:.5f} ms; bound {elem:.6f} ms, "
        f"with the sum's write {with_sum:.6f} ms")


def popstore_phase(rec, prob, torch, ops, ref, make, make_oracle, FederatedConfig, FaultConfig,
                   dev, out):
    from repro_torch.core import popstore

    popstore_conformance(rec, prob, torch, ops, make, FederatedConfig, FaultConfig, popstore,
                         dev, out)
    popstore_lm_flat(rec, torch, ops, make, make_oracle, FederatedConfig, popstore,
                     seeded(torch, 83), dev, out)
    popstore_population(rec, torch, ops, make, make_oracle, FederatedConfig, popstore, dev, out)
    popstore_telemetry(torch, make, make_oracle, FederatedConfig, popstore, dev, out)
    lazy_dual_cost(rec, torch, ops, ref, seeded(torch, 89), out)


# ---------------------------------------------------------------------------
# phase "theory": Theorem 1's linear rate and the KKT residuals on the card
# ---------------------------------------------------------------------------

# benchmarks/theory_rate.py: its problem (key 3), 40 traced rounds, the
# AGPDMM/GPDMM contraction over 30
THEORY = dict(key=3, m=10, n=400, d=64, K=5, rounds=40, contraction_rounds=30)
THEORY_FIG2 = dict(K=5, rounds=25)  # the paper's Fig. 2 size on the arena
THEORY_KKT = dict(key=3, m=6, n=80, d=16, K=5, rounds=300)  # tests/test_theory.py


def q_trajectory(torch, ops, theory, opt, cfg, prob, grad, rounds, x0):
    """Q^r over ``rounds`` traced GPDMM rounds from x0 (x_i^{0,K} = x0) and
    the rounds' launches."""
    from repro_torch.core import tree_util as T

    s = opt.init(x0, prob.m)
    lam_star = prob.lam_star()
    x_c_prev = T.tree_broadcast(x0, prob.m)
    qs = []
    ops.reset_launches()
    for _ in range(rounds):
        s, met = opt.round(s, grad, prob.batch(), return_trace=True)
        tr = met["trace"]
        qs.append(float(theory.q_functional(
            cfg, x_c_prev=x_c_prev, x_bar=tr["x_bar"], lam_is=tr["lam_is"],
            x_star=prob.x_star, lam_star=lam_star, L=prob.L, mu=prob.mu)))
        x_c_prev = tr["x_K"]
    return qs, ops.launches()


def theory_phase(rec, prob, torch, ops, make, FederatedConfig, quadratic, dev, out):
    """(a) ``benchmarks/theory_rate.py`` on its own problem (the reference's
    key 3 through ``core.prng``): 40 traced GPDMM rounds on the default
    config (the pytree path, the plain grad), every Q ratio <= beta + 1e-3,
    then 30 rounds each of AGPDMM and GPDMM: AGPDMM's contraction of
    ||x_s - x*|| at least GPDMM's and within beta; (b) the Fig. 2 problem
    on the arena (``use_avg``, ``oracle()``), 25 traced rounds: the
    problem's mu is not positive in f32 (n = d), so Theorem 1's beta is
    undefined there and Q's ratios are logged, not held to a bound; (c)
    ``kkt_residuals`` after 300 arena rounds at tests/test_theory.py's
    size, to its thresholds."""
    from repro_torch.core import prng, resolved_rho, theory

    res = out["theory"] = {}
    c = THEORY
    p = quadratic.generate_from_key(prng.key(c["key"]), m=c["m"], n=c["n"], d=c["d"],
                                    device="cuda")
    K, eta = c["K"], 0.5 / p.L
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=K, eta=eta)
    beta = theory.gpdmm_beta(p.L, p.mu, eta, resolved_rho(cfg))
    x0 = torch.zeros(p.d, device=dev)
    qs, counts = q_trajectory(torch, ops, theory, make(cfg), cfg, p, p.grad, c["rounds"], x0)
    rec.add(counts)
    check(counts == expected(ops, c["rounds"], fused_update=K), f"theory (a): launches {counts}")
    ratios = [b / max(a, 1e-30) for a, b in zip(qs, qs[1:])]
    log(f"theory (a) m={c['m']} n={c['n']} d={c['d']} K={K}: beta {beta:.6f}, Q ratios max "
        f"{max(ratios):.6f} median {sorted(ratios)[len(ratios) // 2]:.6f}, Q^40 / Q^1 "
        f"{qs[-1] / qs[0]:.3e}; ratios {[round(x, 4) for x in ratios]}")
    check(all(x <= beta + 1e-3 for x in ratios),
          f"theory (a): a Q ratio above beta {beta}: {max(ratios)}")
    rates = {}
    for algo in ("gpdmm", "agpdmm"):
        opt = make(FederatedConfig(algorithm=algo, inner_steps=K, eta=eta))
        s = opt.init(x0, p.m)
        dists = []
        ops.reset_launches()
        for _ in range(c["contraction_rounds"]):
            s, _ = opt.round(s, p.grad, p.batch())
            dists.append(float(p.dist(opt.server_params(s))))
        n = ops.launches()
        rec.add(n)
        check(n == expected(ops, c["contraction_rounds"], fused_update=K),
              f"theory (a) {algo}: launches {n}")
        seg = [x for x in dists if x > 1e-5]
        rates[algo] = (seg[-1] / seg[0]) ** (1.0 / max(1, len(seg) - 1))
    log(f"theory (a) contraction of ||x_s - x*|| a round: {rates}, beta {beta:.6f}")
    check(rates["agpdmm"] <= rates["gpdmm"] + 1e-6, f"theory (a): AGPDMM slower {rates}")
    check(rates["agpdmm"] <= beta, f"theory (a): AGPDMM outside beta {rates}")
    res["a"] = {"beta": beta, "max_ratio": max(ratios), "ratios": ratios,
                "q_last_over_first": qs[-1] / qs[0], "contraction": rates}

    c2 = THEORY_FIG2
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=c2["K"], eta=0.5 / prob.L,
                          use_avg=True, use_arena=True)
    qs, counts = q_trajectory(torch, ops, theory, make(cfg), cfg, prob, prob.oracle(),
                              c2["rounds"], torch.zeros(prob.d, device=dev))
    rec.add(counts)
    check(counts == expected(ops, c2["rounds"], inner_loop_affine=1, round_tail_mean=1,
                             dual_from_uplink=1), f"theory (b): launches {counts}")
    check(all(math.isfinite(q) for q in qs), "theory (b): Q not finite")
    ratios = [b / max(a, 1e-30) for a, b in zip(qs, qs[1:])]
    res["b"] = {"L": prob.L, "mu": prob.mu, "max_ratio": max(ratios), "ratios": ratios,
                "q_last_over_first": qs[-1] / qs[0]}
    log(f"theory (b) Fig. 2 arena m=n=d={prob.m}: mu {prob.mu:.4e} (beta undefined), Q "
        f"ratios max {max(ratios):.6f}, Q^25 / Q^1 {qs[-1] / qs[0]:.3e}")

    c3 = THEORY_KKT
    pk = quadratic.generate_from_key(prng.key(c3["key"]), m=c3["m"], n=c3["n"], d=c3["d"],
                                     device="cuda")
    opt = make(FederatedConfig(algorithm="gpdmm", inner_steps=c3["K"], eta=0.5 / pk.L,
                               use_arena=True))
    s = opt.init(torch.zeros(pk.d, device=dev), pk.m)
    ops.reset_launches()
    for _ in range(c3["rounds"]):
        s, _ = opt.round(s, pk.grad, pk.batch())
    n = ops.launches()
    rec.add(n)
    check(n == expected(ops, c3["rounds"], fused_update_arena=c3["K"], round_tail_mean=1,
                        dual_from_uplink=1), f"theory (c): launches {n}")
    from repro_torch.core import arena

    spec = arena.ArenaSpec.from_tree(s["x_s"])
    kkt = {k: float(v) for k, v in theory.kkt_residuals(pk, s["x_s"],
                                                        spec.unpack_stacked(s["lam_s"])).items()}
    res["c"] = kkt
    log(f"theory (c) kkt residuals after {c3['rounds']} arena rounds: {kkt}")
    check(kkt["dual_sum"] < 1e-3 and kkt["primal_gap"] < 1e-2 and kkt["grad_match"] < 1e-1,
          f"theory (c): {kkt}")


def table1_data(dev):
    """Table I's data (``benchmarks/tab1_softmax.py:54-56``): the reference's
    ``gaussian_mixture_images(key(0), 600, 120, sep=0.12)`` drawn by the
    port, one class per client, features scaled by 1/10."""
    from repro_torch.core import prng
    from repro_torch.data import partition, synthetic

    ds = synthetic.gaussian_mixture_images(prng.key(0), SOFTMAX["n"], 120, sep=0.12,
                                           device=dev)
    xs, ys = partition.by_class(ds.x_train, ds.y_train, SOFTMAX["C"])
    return xs / 10.0, ys


def softmax_phase(rec, torch, ops, make, FederatedConfig, SoftmaxRegression, dev, runs,
                  prof=None):
    """Softmax regression at the Table I size over ``runs`` (label ->
    (config keywords, launches per round)): ``SOFTMAX_RUNS`` in phase 5,
    ``SOFTMAX_PARTIAL`` in phase 8."""
    F, C, m, B, K, R, n = (SOFTMAX[k] for k in ("F", "C", "m", "B", "K", "rounds", "n"))
    prob = SoftmaxRegression(F, C)
    xs, ys = table1_data(dev)
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
        if runs is SOFTMAX_RUNS and label in ("gpdmm", "gpdmm_svrg"):
            from repro_torch.core import gpdmm

            check_x_bar(torch, gpdmm, "inner_steps_arena",
                        lambda: opt.round(state, prob.oracle(), batch_of(R), True),
                        f"softmax {label}")
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
                if method == "gpdmm" and K > 1:
                    from repro_torch.core import gpdmm

                    check_x_bar(torch, gpdmm, "inner_steps",
                                lambda: opt.round(state, prob.grad, prob.batch()),
                                f"fig2 m={m} K={K} gpdmm")
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


def lm_tree_phase(rec, torch, ops, make, FederatedConfig, gen, dev, out, prof=None):
    """The reference benchmark's lm_tree (``benchmarks/round_bench.py:62-72``:
    m = 8, six f32 leaves, 1.77 M values a client, K = 4, eta = 0.1, the
    0.3 x tree gradient) on the pytree path: 10 rounds each of GPDMM,
    AGPDMM, SCAFFOLD and FedAvg after 2 warm-up rounds, one
    ``fused_update`` launch a step for all six leaves and no other kernel,
    no plain op for GPDMM's x_bar, finite states; one GPDMM round on the
    card equals the CPU's (rtol = atol = 1e-5: the client mean sums in
    another order)."""
    c = LM_TREE
    m, K, R = c["m"], c["K"], c["rounds"]
    params = {k: torch.randn(s, generator=gen, device=dev) for k, s in c["shapes"].items()}
    grad = lambda p, b: {k: 0.3 * v for k, v in p.items()}  # noqa: E731
    batch = {"d": torch.zeros(m, 1, device=dev)}
    for algo in ("gpdmm", "agpdmm", "scaffold", "fedavg"):
        kw = dict(algorithm=algo, inner_steps=K, eta=c["eta"], use_arena=False)
        opt = make(FederatedConfig(**kw))
        state = opt.init(params, m)
        state, _, _, _ = run_rounds(torch, ops, opt, state, grad, lambda r: batch, 2, False)
        state, metrics, counts, secs = run_rounds(torch, ops, opt, state, grad,
                                                  lambda r: batch, R, False)
        rec.add(counts)
        out[f"lm_tree_{algo}_ms_per_round"] = 1e3 * secs / R
        log(f"lm_tree {algo}: {R} rounds in {secs:.3f} s ({1e3 * secs / R:.3f} ms/round); "
            f"launches {counts}")
        check(counts == expected(ops, R, fused_update=K), f"lm_tree {algo}: launches {counts}")
        check(float(metrics["used_arena"]) == 0.0, f"lm_tree {algo}: left the pytree path")
        for k, v in state.items():
            if k != "round":
                check(all(bool(torch.isfinite(x).all()) for x in v.values()),
                      f"lm_tree {algo}: {k} not finite")
        if algo == "gpdmm":
            from repro_torch.core import gpdmm

            check_x_bar(torch, gpdmm, "inner_steps", lambda: opt.round(state, grad, batch),
                        "lm_tree gpdmm")
            s_cpu = {k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v.cpu())
                     for k, v in state.items()}
            s_gpu, _ = opt.round(state, grad, batch)
            s_cpu, _ = opt.round(s_cpu, grad, {"d": torch.zeros(m, 1)})
            for k in ("x_s", "lam_s", "x_c"):
                for n in params:
                    torch.testing.assert_close(s_gpu[k][n].cpu(), s_cpu[k][n], rtol=1e-5,
                                               atol=1e-5)
            log("lm_tree gpdmm: card == CPU after one round (rtol = atol = 1e-5)")
        if prof is not None and algo in ("gpdmm", "agpdmm"):
            prof(f"lm_tree_{algo}", lambda: run_rounds(torch, ops, opt, state, grad,
                                                       lambda r: batch, 3, False),
                 1e3 * secs / R, 3)


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
ARENA_TAIL = dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1)
# launches per round, read off the rounds' code: every screened arena round
# screens once, the keep rule in the launch (screen="auto" screens a
# delay-only schedule too), a SCAFFOLD round that is not async ends in its
# server step's two passes (the async one keeps scaffold_cv), every
# async arena round mixes once, the cohort gathers the cached u_hat rows
# for its keep select with its lam and carry rows (one launch) and scatters
# u_hat and the carry (one launch); the pytree path screens and mixes as
# plain tensor code
FAULT_RUNS = {
    "a_gpdmm": (dict(algorithm="gpdmm", **SCREENED), ARENA_TAIL | dict(screen_keep=1)),
    "a_agpdmm": (dict(algorithm="agpdmm", **SCREENED), ARENA_TAIL | dict(screen_keep=1)),
    "a_scaffold": (dict(algorithm="scaffold", **SCREENED),
                   dict(inner_loop_affine=1, scaffold_step=2, screen_keep=1)),
    "a_fedavg": (dict(algorithm="fedavg", **SCREENED), dict(inner_loop_affine=1, screen_keep=1)),
    "b_gpdmm": (dict(algorithm="gpdmm", participation=0.1, **SCREENED),
                ARENA_TAIL | dict(screen_keep=1, row_gather=1, row_scatter=1)),
    "b_gpdmm_finite": (dict(algorithm="gpdmm", participation=0.1, **FINITE_ONLY),
                       ARENA_TAIL | dict(screen_keep=1, row_gather=1, row_scatter=1)),
    "b_gpdmm_finite_masked": (dict(algorithm="gpdmm", participation=0.1, cohort=False,
                                   **FINITE_ONLY), ARENA_TAIL | dict(screen_keep=1)),
    "c_gpdmm_sync": (dict(algorithm="gpdmm", faults=DELAYED["faults"], async_rounds=False),
                     ARENA_TAIL | dict(screen_keep=1)),
    "c_gpdmm_ms0": (dict(algorithm="gpdmm", max_staleness=0, **DELAYED),
                    ARENA_TAIL | dict(screen_keep=1, stale_mix=1)),
    "c_gpdmm_ms2": (dict(algorithm="gpdmm", max_staleness=2, **DELAYED),
                    ARENA_TAIL | dict(screen_keep=1, stale_mix=1)),
    "c_gpdmm_ms4": (dict(algorithm="gpdmm", max_staleness=4, **DELAYED),
                    ARENA_TAIL | dict(screen_keep=1, stale_mix=1)),
    "c_agpdmm_ms2": (dict(algorithm="agpdmm", max_staleness=2, **DELAYED),
                     ARENA_TAIL | dict(screen_keep=1, stale_mix=1)),
    "c_fedavg_ms2": (dict(algorithm="fedavg", max_staleness=2, **DELAYED),
                     dict(inner_loop_affine=1, screen_keep=1, stale_mix=1)),
    "c_scaffold_ms2": (dict(algorithm="scaffold", max_staleness=2, **DELAYED),
                       dict(inner_loop_affine=1, scaffold_cv=1, screen_keep=1, stale_mix=1)),
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
            f"||x - x*|| {d0:.4e} -> {trail}; launches {counts}; invariant / (full, "
            f"client-mean) rounding scale {readings(inv)}; totals {tot}")
        check(float(metrics["used_arena"]) == (0.0 if pytree else 1.0),
              f"faults {label}: took the wrong path")
        check(counts == expected(ops, R, **per_round), f"faults {label}: launches {counts}")
        check(all(bool(f) for f in finite), f"faults {label}: x_s not finite in some round")
        check(trail[-1] < trail[0] < d0, f"faults {label}: distance did not fall: {trail}")
        if kw["algorithm"] in ("gpdmm", "agpdmm"):
            check(max(v for v, _ in inv) < 16.0, f"faults {label}: invariant (25) broken: {inv}")
        if kw["algorithm"] == "scaffold":
            check(max(v for v, _ in inv) < 64.0,
                  f"faults {label}: sum_i (c_i - c) = 0 broken: {inv}")
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

    # the screen from the uplink to the mask, and SCAFFOLD's tail, dispatch
    # no tensor op: one screen_keep launch a round, scaffold_step's two passes
    for label in ("a_gpdmm", "b_gpdmm", "a_scaffold", "b_gpdmm_finite_masked"):
        kw, per_round = FAULT_RUNS[label]
        opt = make(fault_cfg(FederatedConfig, FaultConfig, kw, inner_steps=K, eta=eta,
                             use_arena=True))
        state, _ = opt.round(opt.init(x0, m), prob.oracle(), prob.batch())

        def one_round():
            ops.reset_launches()
            opt.round(state, prob.oracle(), prob.batch())

        screen_ops = ops_inside(torch, faults, "screen_keep", one_round)
        counts = ops.launches()
        check(screen_ops == [0] and counts == expected(ops, 1, **per_round),
              f"faults {label}: the screen dispatched {screen_ops} tensor ops, launches {counts}")
        tail = ""
        if kw["algorithm"] == "scaffold":
            tail_ops = ops_inside(torch, ops, "scaffold_step", one_round)
            check(tail_ops == [0] and ops.launches()["scaffold_cv"] == 0,
                  f"faults {label}: SCAFFOLD's tail dispatched {tail_ops} tensor ops")
            tail = f"; scaffold_step's tensor ops {tail_ops}"
        log(f"faults {label}: tensor ops from the uplink to the mask {screen_ops}{tail}; "
            f"launches a round {({k: v for k, v in counts.items() if v})}")
        del opt, state

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
    tail = dict(fused_update_arena=K, round_tail=1, client_mean=1, dual_from_uplink=1,
                screen_keep=1)
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
        check_x_bar(torch, pdmm_graph, "inner_steps_graph",
                    lambda: opt.round(state, grad, batch), f"graph lm_flat {name}")
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
    check(counts == expected(ops, LSQ["rounds"], inner_loop_affine=1, round_tail_mean=1,
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
        check(counts == expected(ops, ran, fused_update_arena=K, round_tail_mean=1,
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


# ---------------------------------------------------------------------------
# phase 11: the model slice -- serving olmo-1b and rwkv6-1.6b at full width
# ---------------------------------------------------------------------------

# the prefill shapes of the serve runs below: olmo-1b (B, S, H, hd) and
# rwkv6-1.6b (B, S, H, K), batch 4, prompt 1024
FLASH_SHAPE = (4, 1024, 16, 128)
FLASH_GQA = (32, 8)  # (H, Hkv) of the grouped shape, hd 128
FLASH_WINDOW = 256
WKV_SHAPE = (4, 1024, 32, 64)
# the edges of flash's tiles of 128 queries and 128 keys, (B, Sk, H, Hkv, hd,
# dtype, window, Sq): Sq and Sk off the tiles with a query offset of 800 (not
# tile-aligned), hd 64 and 128 and 80 (two boxes, the second partial) in
# bf16, GQA 4:1, a window below one tile, and a bf16 hd the tensor-core
# route does not take (72: the CUDA-core route)
FLASH_EDGES = (
    (2, 1000, 8, 8, 128, "bf16", None, 200),
    (2, 1000, 8, 8, 64, "bf16", None, 200),
    (2, 333, 8, 2, 128, "bf16", 40, None),
    (2, 200, 8, 2, 64, "bf16", None, None),
    (1, 130, 4, 1, 80, "bf16", 100, 77),
    (1, 100, 2, 2, 72, "bf16", None, None),
)
WKV_EDGES = (1, 63, 65, 100)  # lengths around the 64-step chunk
# kernel 16 at the head dims of the archs served below, (label, (B, S, H, Hkv,
# hd, vd), window): deepseek-v2-lite's MLA prefill (hd 192, vd 128),
# recurrentgemma-9b's local attention (16 query heads on one kv head, hd
# 256, its 2,048-key window) at prompt 1024 and at 4,096 keys, where the
# window binds, and stablelm-12b's hd 160
FLASH_HEAD_DIMS = (
    ("mla", (4, 1024, 16, 16, 192, 128), None),
    ("recurrentgemma", (4, 1024, 16, 1, 256, 256), 2048),
    ("recurrentgemma_4096", (2, 4096, 16, 1, 256, 256), 2048),
    ("stablelm", (4, 1024, 32, 8, 160, 160), None),
)
# (B, Sk, H, Hkv, hd, vd, dtype, window, Sq): the same head dims in f32 (the
# CUDA-core route), the edges of the 64-key tiles that hd or vd above 128
# take on the tensor cores (Sq and Sk off the tiles, a query offset, a window
# below a tile, vd above and below hd), and a bf16 pair off the tensor-core
# route (hd 200, vd 136: CUDA cores)
FLASH_HEAD_DIM_EDGES = (
    (1, 200, 4, 4, 192, 128, "f32", None, None),
    (1, 200, 4, 1, 256, 256, "f32", 64, None),
    (1, 200, 4, 2, 160, 160, "f32", None, None),
    (2, 333, 4, 1, 256, 256, "bf16", 40, 77),
    (1, 130, 4, 2, 192, 128, "bf16", None, 77),
    (1, 130, 2, 2, 160, 160, "bf16", 100, None),
    (1, 100, 2, 2, 64, 256, "bf16", None, None),
    (1, 100, 2, 2, 256, 64, "bf16", None, None),
    (1, 100, 2, 1, 200, 136, "bf16", None, None),
)
LRU_SHAPE = (4, 1024, 4096)  # recurrentgemma-9b's prefill: batch 4, prompt 1024, d_rnn 4096
LRU_EDGES = (1, 511, 513)  # lengths around the kernel's 32-step groups, at (2, S, 300)
SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
SERVE_ARCHS = ("olmo-1b", "rwkv6-1.6b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
               "stablelm-12b", "llava-next-mistral-7b", "musicgen-large",
               "llama4-maverick-400b-a17b")
CARD_VS_CPU_ARCHS = ("olmo-1b", "rwkv6-1.6b")  # phase "11 card vs cpu"
# full depth, but for llama4-maverick: 2 layers, its one (dense, moe) unit at
# full width (18.6e9 parameters, 37 GB in bf16); its 48 layers (~800 GB) do
# not fit four cards; and stablelm-12b, llava-next and musicgen-large at 2
# layers of their 40, 32 and 48, widths unchanged, which pays for phase "12
# train archs" within the script's time (their full depth served in PR 28:
# PERF.md section 5); kernel 16 at their shapes is timed in (a) as before;
# deepseek-v2-lite-16b at 8 of its 27 layers (its dense first and seven MoE
# layers; PERF.md section 5 has its full depth), which pays for phase "12 eta
# auto"
SERVE_LAYERS = {"llama4-maverick-400b-a17b": 2, "stablelm-12b": 2,
                "llava-next-mistral-7b": 2, "musicgen-large": 2, "deepseek-v2-lite-16b": 8}
# per prefill, one kernel per block of the model (attention blocks: kernel 16;
# rwkv: 17; RG-LRU: lru_scan), none per decode token
SERVE_LAUNCHES = {"olmo-1b": {"flash_attention": 16}, "rwkv6-1.6b": {"wkv6": 24},
                  "deepseek-v2-lite-16b": {"flash_attention": 8},
                  "recurrentgemma-9b": {"flash_attention": 12, "lru_scan": 26},
                  "stablelm-12b": {"flash_attention": 2},
                  "llava-next-mistral-7b": {"flash_attention": 2},
                  "musicgen-large": {"flash_attention": 2},
                  "llama4-maverick-400b-a17b": {"flash_attention": 2}}
# MoE archs: decode is at full capacity, so decode against prefill runs a
# drop-free pipeline (``exact_moe``) on these many batch rows (rows are
# independent without drops; maverick's drop-free prefill of all four rows,
# (128, 4224, 8192) expert activations, does not fit beside its weights)
MOE_CHECK_ROWS = {"deepseek-v2-lite-16b": 4, "llama4-maverick-400b-a17b": 1}
# decode against prefill in f32 at full width: (layers, batch, prompt); 4
# layers, batch 2, 256 tokens, but maverick: its one MoE layer holds 64 GB of
# f32 experts, so 2 layers, batch 1, 128 tokens; and deepseek, where its bf16
# check takes ``LOGITS_MOE_REL``, at 4 layers, batch 1, 128 tokens (at full
# depth, 63 GB of f32 weights, it held 3.7e-5, as ``LOGITS_MOE_REL``'s note
# says; cut to pay for phase "12 eta auto")
F32_CHECK = {"llama4-maverick-400b-a17b": (2, 1, 128), "deepseek-v2-lite-16b": (4, 1, 128)}
F32_CHECK_DEFAULT = (4, 2, 256)
# tolerances, relative to the largest magnitude of the reference value: a
# kernel against its plain version rounds its f32 result once to bf16 (2^-8)
# after sums taken in another order; a bf16 model's logits pass 16-24 layers
# of bf16 activations whose products the two paths round at other points
# (decode's one-row products against prefill's (B S)-row ones, the card's
# against the CPU's; measured 1.3e-2 and 3.8e-2 for decode against prefill,
# 8.5e-3 and 1.4e-2 for the card against the CPU).  The same comparison in
# f32, at full width with 4 layers, holds to 1e-4: there the two paths differ
# only in the order of their sums
KERNEL_BF16_REL = 2.0 ** -7
KERNEL_F32_REL = 1e-4
LOGITS_REL = 6e-2
LOGITS_F32_REL = 1e-4
# bf16 decode against prefill of an MoE arch, every token routed as the
# extended prefill routed it: the bf16 roundings of decode's one-row
# products and MLA's absorbed f32 attention against prefill's grow through
# DeepSeek's 26 MoE layers (measured on an H100 at batch 1, prompt 256:
# 0.013 at 2 layers, 0.031 at 4, 0.047 at 8, 0.089 at 16, 0.157 at 27;
# 0.165 with the loop dispatch in decode too, so not its bf16 combine); the
# same comparison holds 1e-4 in f32 at full depth (3.7e-5), so the cache is
# right.  The reference's own bf16 decode drifts from its prefill the same
# way: at a reduced width and 27 layers, routed alike, 0.058-0.197 over
# four seeds against the port's 0.065-0.183 (on the CPU,
# tests/test_torch_archs.py::test_moe_bf16_decode_drift_is_the_references)
LOGITS_MOE_REL = 0.25
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores


def rel_err(torch, got, want) -> float:
    want = want.float()
    return max_err(got, want) / max(float(want.abs().max()), 1e-30)


def flash_flops(B, H, Sq, Sk, hd, window=None, vd=None) -> float:
    """Operations (2 a multiply-add) of q k^T (hd) and p v (vd, default hd)
    over the valid (query, key) pairs, the queries at the last Sq of Sk
    positions."""
    vd = hd if vd is None else vd
    pairs = 0
    for i in range(Sk - Sq, Sk):
        lo = 0 if window is None else max(0, i - window + 1)
        pairs += i + 1 - lo
    return 2.0 * B * H * (hd + vd) * pairs


def check_model_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 16-17 against their plain versions at the serve runs' shapes
    (and a grouped, a windowed, an f32 and a suffix-query flash, and the
    edges of the tensor-core route's tiles, each on its expected route;
    ``wkv6`` at lengths around its chunk), timed with their bounds; flash
    beside ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as _fa

    dev = gen.device
    bf16 = torch.bfloat16

    def flash_case(B, S, H, Hkv, hd, dt, window=None, Sq=None):
        Sq = S if Sq is None else Sq
        q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dt)
        off = S - Sq
        got = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=off)
        want = ref.flash_attention_ref(q, k, v, torch.arange(off, S, device=dev),
                                       torch.arange(S, device=dev), causal=True, window=window)
        e = rel_err(torch, got, want)
        tol = KERNEL_BF16_REL if dt == bf16 else KERNEL_F32_REL
        what = f"flash_attention {(B, Sq, S, H, Hkv, hd)} {dt} window {window}"
        check(e <= tol, f"{what}: rel error {e} > {tol}")
        log(f"{what}: rel error {e:.3e}")
        return q, k, v, max_err(got, want)

    B, S, H, hd = FLASH_SHAPE
    flash_case(B, S, H, H, hd, bf16, window=FLASH_WINDOW)
    flash_case(B, S, FLASH_GQA[0], FLASH_GQA[1], hd, bf16)
    flash_case(B, S, H, H, hd, torch.float32)
    flash_case(2, 384, 8, 2, 64, torch.float32, Sq=128)  # suffix queries, offset 256
    for case in FLASH_EDGES:  # the edges of the tensor-core route's tiles
        b_, sk, h_, hkv, d_, dname, window, sq = case
        dt = {"bf16": bf16, "f32": torch.float32}[dname]
        flash_case(b_, sk, h_, hkv, d_, dt, window=window, Sq=sq)
        want_route = "wgmma" if dt == bf16 and d_ % 16 == 0 else "cuda_cores"
        check(_fa.last_route == want_route,
              f"flash_attention {case}: route {_fa.last_route}, expected {want_route}")
    q, k, v, err = flash_case(B, S, H, H, hd, bf16)
    check(_fa.last_route == "wgmma", f"flash_attention {FLASH_SHAPE} bf16: route "
                                     f"{_fa.last_route}, expected wgmma")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(S, device=dev)
    rec.kernel("flash_attention", err,
               lambda: ops.flash_attention(q, k, v, causal=True, q_offset=0),
               lambda: ref.flash_attention_ref(q, k, v, pos, pos, causal=True), 10,
               2 * 4 * B * S * H * hd, flash_flops(B, H, S, S, hd),
               library_fn=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
               flop_per_s=BF16_FLOP_PER_S)

    B, S, H, K = WKV_SHAPE
    r, kk, vv = (torch.randn(B, S, H, K, generator=gen, device=dev).to(bf16) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(B, S, H, K, generator=gen, device=dev) - 1.0))
    u = 0.1 * torch.randn(H, K, generator=gen, device=dev)
    s0 = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
    y, s = ops.wkv6(r, kk, vv, w, u, s0)
    y_w, s_w = ref.wkv6_ref(r, kk, vv, w, u, s0)
    e_y, e_s = rel_err(torch, y, y_w), rel_err(torch, s, s_w)
    check(e_y <= KERNEL_BF16_REL, f"wkv6 y: rel error {e_y} > {KERNEL_BF16_REL}")
    check(e_s <= KERNEL_F32_REL, f"wkv6 state: rel error {e_s} > {KERNEL_F32_REL}")
    log(f"wkv6 {WKV_SHAPE} bf16, s0 != 0: y rel error {e_y:.3e}, state rel error {e_s:.3e}")
    # a ragged last chunk and near-zero decay, f32
    r2, k2, v2 = (torch.randn(2, 100, 4, 64, generator=gen, device=dev) for _ in range(3))
    w2 = torch.full((2, 100, 4, 64), 1e-30, device=dev)
    w2[:, ::3] = 0.9
    u2 = 0.1 * torch.randn(4, 64, generator=gen, device=dev)
    s02 = torch.randn(2, 4, 64, 64, generator=gen, device=dev)
    got2, want2 = ops.wkv6(r2, k2, v2, w2, u2, s02), ref.wkv6_ref(r2, k2, v2, w2, u2, s02)
    e2 = max(rel_err(torch, a, b) for a, b in zip(got2, want2))
    check(e2 <= KERNEL_F32_REL and bool(torch.isfinite(got2[0]).all()),
          f"wkv6 ragged, extreme decay: rel error {e2}")
    log(f"wkv6 (2, 100, 4, 64) f32, ragged chunk, decay 1e-30: rel error {e2:.3e}")
    for S_edge in WKV_EDGES:  # lengths around the 64-step chunk, zero and nonzero s0
        for s0_zero in (True, False):
            r3, k3, v3 = (torch.randn(2, S_edge, 4, 64, generator=gen, device=dev)
                          for _ in range(3))
            w3 = torch.exp(-torch.exp(0.5 * torch.randn(2, S_edge, 4, 64, generator=gen,
                                                        device=dev) - 1.0))
            s03 = (torch.zeros(2, 4, 64, 64, device=dev) if s0_zero
                   else torch.randn(2, 4, 64, 64, generator=gen, device=dev))
            got3 = ops.wkv6(r3, k3, v3, w3, u2, s03)
            want3 = ref.wkv6_ref(r3, k3, v3, w3, u2, s03)
            e3 = max(rel_err(torch, a, b) for a, b in zip(got3, want3))
            check(e3 <= KERNEL_F32_REL and bool(torch.isfinite(got3[0]).all()),
                  f"wkv6 S={S_edge} s0 {'= 0' if s0_zero else '!= 0'}: rel error {e3}")
            log(f"wkv6 (2, {S_edge}, 4, 64) f32, s0 {'= 0' if s0_zero else '!= 0'}: "
                f"rel error {e3:.3e}")
    chunks = -(-S // 64)
    flops = B * H * chunks * (2 * 64 * K * K * 2 + 2 * (64 * 63 // 2) * K * 2)
    nbytes = 2 * (3 * B * S * H * K) + 4 * B * S * H * K + 2 * B * S * H * K + 4 * H * K \
        + 2 * 4 * B * H * K * K
    rec.kernel("wkv6", max(max_err(y, y_w), max_err(s, s_w)),
               lambda: ops.wkv6(r, kk, vv, w, u, s0),
               lambda: ref.wkv6_ref(r, kk, vv, w, u, s0), 10, nbytes, flops)
    out["model_kernel_errors"] = {"wkv6_y_rel": e_y, "wkv6_s_rel": e_s}
    check_flash_head_dims(rec, torch, ops, ref, gen, out)
    check_lru_scan(rec, torch, ops, ref, gen, out)
    torch.cuda.synchronize()


def sdpa_forward(torch, q, k, v, window, backend: str):
    """One call of ``scaled_dot_product_attention`` computing kernel 16's
    function on (B, S, H, d) tensors (views in SDPA's layout), under
    ``backend``: causal, grouped heads through ``enable_gqa``, a window that
    binds as a boolean mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, H, Hkv = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"enable_gqa": True} if Hkv != H else {}
    if window is None or window >= S:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def run():
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return run


def sdpa_forward_fastest(torch, q, k, v, window) -> dict:
    """SDPA (``sdpa_forward``) under each of ``SDPA_BACKENDS`` that takes
    these operands, medians of 3 trials of 10 calls: every backend's time
    (or why it did not run) and the fastest's name and time (None when no
    backend takes them)."""
    every = {}
    for backend in SDPA_BACKENDS:
        run = sdpa_forward(torch, q, k, v, window, backend)
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as e:  # the backend does not take these operands here
            every[backend] = f"not run: {str(e).splitlines()[0][:120]}"
            continue
        every[backend] = med_ms(run, 10, 3)[0]
    ran = [b for b, t in every.items() if not isinstance(t, str)]
    best = min(ran, key=lambda b: every[b]) if ran else None
    return {"sdpa_ms": None if best is None else every[best], "sdpa": best, "sdpa_also": every}


def check_flash_head_dims(rec, torch, ops, ref, gen, out):
    """Kernel 16 at the head dims of the archs this phase serves
    (``FLASH_HEAD_DIMS``: hd 192 / vd 128, hd 256 on one kv head with a
    window, at 4,096 keys too, hd 160) and at ``FLASH_HEAD_DIM_EDGES``,
    against its plain version, each on its expected route; the
    ``FLASH_HEAD_DIMS`` shapes timed (medians of 3 trials) with their bounds
    and the fastest SDPA backend that takes them (each pinned in turn)."""
    from repro_torch.kernels import flash_attention as _fa

    dev = gen.device
    bf16 = torch.bfloat16

    def held(B, S, H, Hkv, hd, vd, dt, window, Sq=None):
        Sq = S if Sq is None else Sq
        q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, vd, generator=gen, device=dev).to(dt)
        off = S - Sq
        got = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=off)
        want_route = ("wgmma" if dt == bf16 and hd % 16 == 0 and vd % 16 == 0
                      else "cuda_cores")
        what = f"flash_attention {(B, Sq, S, H, Hkv, hd, vd)} {dt} window {window}"
        check(_fa.last_route == want_route,
              f"{what}: route {_fa.last_route}, expected {want_route}")
        want = ref.flash_attention_ref(q, k, v, torch.arange(off, S, device=dev),
                                       torch.arange(S, device=dev), causal=True, window=window)
        check(tuple(got.shape) == (B, Sq, H, vd), f"{what}: shape {tuple(got.shape)}")
        e = rel_err(torch, got, want)
        tol = KERNEL_BF16_REL if dt == bf16 else KERNEL_F32_REL
        check(e <= tol, f"{what}: rel error {e} > {tol}")
        log(f"{what}: {_fa.last_route}, rel error {e:.3e}")
        return q, k, v, e, max_err(got, want)

    rows = {}
    for label, (B, S, H, Hkv, hd, vd), window in FLASH_HEAD_DIMS:
        q, k, v, e, err = held(B, S, H, Hkv, hd, vd, bf16, window)
        route = _fa.last_route
        pos = torch.arange(S, device=dev)
        ms = med_ms(lambda: ops.flash_attention(q, k, v, causal=True, window=window,
                                                q_offset=0), 10, 3)[0]
        plain_ms = cuda_time_ms(lambda: ref.flash_attention_ref(q, k, v, pos, pos, causal=True,
                                                                window=window), 3)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * H * vd)
        b, by = bound_ms(nbytes, flash_flops(B, H, S, S, hd, window, vd), BF16_FLOP_PER_S)
        rows[label] = {"shape": [B, S, H, Hkv, hd, vd], "window": window, "route": route,
                       "rel_err": e, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b, "bound_by": by} | sdpa_forward_fastest(torch, q, k, v,
                                                                             window)
        r = rows[label]
        sdpa = "none" if r["sdpa_ms"] is None else f"{r['sdpa_ms']:.4f} ms ({r['sdpa']})"
        log(f"flash_attention {label} {tuple(r['shape'])} window {window}: {ms:.4f} ms on "
            f"{route}, plain {plain_ms:.4f}, bound {b:.4f} ({by}), fastest SDPA {sdpa}; "
            f"every SDPA backend {r['sdpa_also']}")
        del q, k, v
    for case in FLASH_HEAD_DIM_EDGES:
        b_, sk, h_, hkv, hd, vd, dname, window, sq = case
        held(b_, sk, h_, hkv, hd, vd, {"bf16": bf16, "f32": torch.float32}[dname], window, sq)
    rec.rows["flash_attention"]["head_dims"] = rows
    out["flash_head_dims"] = rows


def check_lru_scan(rec, torch, ops, ref, gen, out):
    """``lru_scan`` bitwise its plain sequential version at
    recurrentgemma-9b's prefill shape and at ``LRU_EDGES``, a in [0, 1) as
    the RG-LRU's decays, h0 nonzero; timed with its bound (each input read
    and each output written once)."""
    dev = gen.device

    def held(B, S, D):
        a = torch.rand(B, S, D, generator=gen, device=dev)
        b = torch.randn(B, S, D, generator=gen, device=dev)
        h0 = torch.randn(B, D, generator=gen, device=dev)
        y, h = ops.lru_scan(a, b, h0)
        y_w, h_w = ref.lru_ref(a, b, h0)
        check(torch.equal(y, y_w) and torch.equal(h, h_w),
              f"lru_scan {(B, S, D)}: not bitwise the plain recurrence (max error "
              f"{max(max_err(y, y_w), max_err(h, h_w))})")
        log(f"lru_scan {(B, S, D)}: bitwise the plain recurrence")
        return a, b, h0

    for S in LRU_EDGES:
        held(2, S, 300)
    B, S, D = LRU_SHAPE
    a, b, h0 = held(B, S, D)
    rec.kernel("lru_scan", 0.0, lambda: ops.lru_scan(a, b, h0), lambda: ref.lru_ref(a, b, h0),
               20, 4 * (3 * B * S * D + 2 * B * D), 2.0 * B * S * D, plain_iters=2,
               plain_spin=50_000_000, trials=3)
    out["lru_scan"] = {k: rec.rows["lru_scan"][k] for k in ("ms", "plain_ms", "bound_ms")}


def serve_phase(rec, torch, ops, dev, out):
    """``serve.run`` at full width for every arch of ``SERVE_ARCHS`` (full
    depth but for ``SERVE_LAYERS``), the weights drawn once, one warm-up
    prefill before the timed prefill and decode; the launches of the run
    read (the warm-up's prefill included), the route of kernel 16, finite
    logits and token shapes, the peak allocation of the draw and of the
    serving; then the last decode step's logits against a prefill of the
    extended prompt (``decode_against_prefill``), a profile of prefill and
    decode, and the same comparison in f32 (``decode_against_prefill_f32``)."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.launch import serve

    res = out["serve"] = {}
    for arch in SERVE_ARCHS:
        torch.cuda.empty_cache()
        ops.reset_launches()
        _fa.last_route = None
        got = serve.run(arch, reduced=False, device="cuda", layers=SERVE_LAYERS.get(arch),
                        quiet=True, **SERVE)
        torch.cuda.synchronize()
        counts = ops.launches()
        rec.add(counts)
        want = {n: 0 for n in counts} | {n: 2 * c for n, c in SERVE_LAUNCHES[arch].items()}
        check(counts == want, f"serve {arch}: launches {counts}, expected {want} (two "
                              f"prefills: the warm-up and the timed one)")
        if counts["flash_attention"]:  # every bf16 prefill: the tensor-core route
            check(_fa.last_route == "wgmma",
                  f"serve {arch}: flash_attention took the {_fa.last_route} route, not wgmma")
        check(bool(torch.isfinite(got.logits).all()), f"serve {arch}: logits not finite")
        cfg = got.model.cfg
        want_tok = ((SERVE["batch"], cfg.n_codebooks, SERVE["new_tokens"]) if cfg.n_codebooks > 1
                    else (SERVE["batch"], SERVE["new_tokens"]))
        check(tuple(got.tokens.shape) == want_tok, f"serve {arch}: tokens {tuple(got.tokens.shape)}")
        res[arch] = {"layers": cfg.n_layers, "prefill_ms": got.prefill_ms,
                     "decode_ms_per_token": got.decode_ms_per_token, "init_s": got.init_s,
                     "init_peak_gb": got.init_peak_bytes / 1e9,
                     "serve_peak_gb": got.serve_peak_bytes / 1e9,
                     "launches": {n: c for n, c in counts.items() if c}}
        res[arch] |= decode_against_prefill(torch, got, arch)
        log(f"serve {arch} ({cfg.n_layers} layers): weights drawn in {got.init_s:.2f} s, peak "
            f"{res[arch]['init_peak_gb']:.2f} GB; prefill {got.prefill_ms:.2f} ms, decode "
            f"{got.decode_ms_per_token:.3f} ms/token, serving peak "
            f"{res[arch]['serve_peak_gb']:.2f} GB; launches {res[arch]['launches']}")
        res[arch] |= profile_serve(torch, got, arch)
        del got
        torch.cuda.empty_cache()
        res[arch]["decode_vs_prefill_f32_rel"] = decode_against_prefill_f32(torch, arch)


def moe_routes(M, record: list, forced=None):
    """A stand-in for ``models.moe.top_k``: it appends each call's chosen
    experts (rows of k ids) to ``record`` and, given ``forced`` (call
    number -> rows of k ids), takes those experts instead, their gates as
    the values; returns (the plain function, the stand-in).  The caller
    sets ``M.top_k`` back."""
    plain = M.top_k

    def top_k(gates, k):
        vals, idx = plain(gates, k)
        record.append(idx)
        if forced is not None:
            idx = forced(len(record) - 1)
            vals = gates.gather(-1, idx)
        return vals, idx
    return plain, top_k


def routes_differing(torch, decode_routes, prefill_routes, n_moe, rows, S0, S_ext) -> int:
    """Top-k choices (of all decode steps' tokens, every MoE layer) that the
    decode steps route to other experts than the prefill of the extended
    prompt: for step i, layer l, row b, k less the experts both choose for
    the token at position S0 + i."""
    n = 0
    for i in range(len(decode_routes) // n_moe):
        for layer in range(n_moe):
            dec = decode_routes[i * n_moe + layer]  # (rows, k)
            pre = prefill_routes[layer].reshape(rows, S_ext, -1)[:, S0 + i]
            for b in range(rows):
                n += dec.shape[-1] - len(set(dec[b].tolist()) & set(pre[b].tolist()))
    return n


def decode_against_prefill(torch, got, arch) -> dict:
    """The last decode step's logits against a prefill of the extended
    prompt (prompt and generated tokens; llava's patches kept) within
    ``LOGITS_REL``.

    An MoE arch reruns the served pipeline drop-free (prefill and the
    extended prefill with ``exact_moe``; decode is always at full capacity)
    on its first ``MOE_CHECK_ROWS`` rows.  In bf16 the decode and the
    prefill round the hidden states at other points, a near-tied router
    row picks another expert, and the difference grows through the layers
    (at deepseek's 26 MoE layers the free-running decode ends far from the
    prefill).  So the free-running comparison and the number of top-k
    choices that differ are logged, and the check replays the decode on the
    same tokens with every MoE block routed as the extended prefill routed
    that token (the experts forced, their own gates as weights): that holds
    the cache and the decode step with the routing
    taken out, to ``LOGITS_MOE_REL``."""
    from repro_torch.launch import serve
    from repro_torch.models import moe as M

    model, params, cfg = got.model, got.params, got.model.cfg
    res = {}
    with torch.no_grad():
        if arch not in MOE_CHECK_ROWS:
            ext = dict(got.batch, tokens=torch.cat([got.prompts, got.tokens], dim=-1))
            full, _ = model.prefill(params, ext, ext["tokens"].shape[-1])
            logits = got.logits
        else:
            rows = MOE_CHECK_ROWS[arch]
            S0, n_new = SERVE["prompt_len"], SERVE["new_tokens"]
            batch = {k: v[:rows] for k, v in got.batch.items()}
            record: list = []
            plain, M.top_k = moe_routes(M, record)
            try:
                tokens, free, _, _ = serve.generate(model, params, batch, n_new, S0 + n_new,
                                                    exact_moe=True)
                n_moe = len(record) // (n_new + 1)
                decode_routes = record[n_moe:]
                record.clear()
                ext = dict(batch, tokens=torch.cat([batch["tokens"], tokens], dim=-1))
                S_ext = ext["tokens"].shape[-1]
                full, _ = model.prefill(params, ext, S_ext, exact_moe=True)
                routes = [r.reshape(rows, S_ext, -1) for r in record]
            finally:
                M.top_k = plain
            res["moe_choices_differing"] = routes_differing(
                torch, decode_routes, routes, n_moe, rows, S0, S_ext)
            res["moe_choices_decoded"] = len(decode_routes) * rows * cfg.top_k
            res["moe_free_rel"] = rel_err(torch, free, full)

            def forced(call):  # the prompt's prefill, then one decode step a token
                step, layer = divmod(call, n_moe)
                r = routes[layer]
                return (r[:, :S0] if step == 0 else r[:, S0 + step - 1]).reshape(-1, r.shape[-1])

            plain, M.top_k = moe_routes(M, [], forced)
            try:
                logits, cache = model.prefill(params, batch, S0 + n_new, exact_moe=True)
                for i in range(n_new):
                    logits, cache = model.decode(params, cache, tokens[..., i:i + 1])
            finally:
                M.top_k = plain
    e = rel_err(torch, logits, full)
    tol = LOGITS_MOE_REL if arch in MOE_CHECK_ROWS else LOGITS_REL
    moe = ("" if "moe_choices_differing" not in res else
           f" (drop-free, {rows} rows, routed as the extended prefill routed; free-running: "
           f"{res['moe_choices_differing']} of {res['moe_choices_decoded']} top-k choices "
           f"differ, rel error {res['moe_free_rel']:.3e})")
    log(f"serve {arch}: last decode logits vs prefill of the {ext['tokens'].shape[-1]}-token "
        f"prompt{moe}: rel error {e:.3e} (tolerance {tol})")
    check(e <= tol, f"serve {arch}: decode vs prefill rel error {e} > {tol}")
    return res | {"decode_vs_prefill_rel": e, "tolerance": tol}


def arch_batch(torch, cfg, B: int, S: int, gen) -> dict:
    """A random prompt batch for ``cfg`` on the card: tokens (B, [K,] S) and,
    for a vision frontend, its patches."""
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks > 1 else (B, S)
    b = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen, device="cuda")}
    if cfg.frontend == "vision":
        b["patches"] = torch.randn(B, cfg.n_prefix_tokens, cfg.frontend_dim, generator=gen,
                                   device="cuda")
    return b


def decode_against_prefill_f32(torch, arch) -> float:
    """Full width, f32, ``F32_CHECK`` layers, batch and prompt (4 layers,
    batch 2, 256 tokens by default): 4 greedy decode steps against a prefill
    of the extended prompt, drop-free for an MoE arch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build

    layers, B, S = F32_CHECK.get(arch, F32_CHECK_DEFAULT)
    model = build(dataclasses.replace(get_arch(arch), n_layers=layers, dtype="float32"))
    exact = arch in MOE_CHECK_ROWS
    with torch.no_grad():
        params = model.init(seeded(torch, 53))
        batch = arch_batch(torch, model.cfg, B, S, seeded(torch, 59))
        cap = S + 4 + model.cfg.n_prefix_tokens
        tokens, logits, _, _ = serve.generate(model, params, batch, 4, cap, exact_moe=exact)
        ext = dict(batch, tokens=torch.cat([batch["tokens"], tokens], dim=-1))
        full, _ = model.prefill(params, ext, cap, exact_moe=exact)
    e = rel_err(torch, logits, full)
    log(f"serve {arch} f32, full width, {layers} layers, batch {B}: last decode logits vs "
        f"prefill of the {S + 4}-token prompt: rel error {e:.3e}")
    check(e <= LOGITS_F32_REL, f"serve {arch} f32: decode vs prefill rel error {e}")
    del params
    torch.cuda.empty_cache()
    return e


def profile_serve(torch, got, arch) -> dict:
    """torch.profiler over one prefill and over 8 decode steps of the served
    model: device-busy time, the idle share of the host-clocked time and
    the kernel time by name ("where the time goes")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, params, batch = got.model, got.params, got.batch
    cap = batch["tokens"].shape[-1] + model.cfg.n_prefix_tokens + 8
    result = {}

    def prefill():
        return model.prefill(params, batch, cap)

    with torch.no_grad():
        _, cache = prefill()
        nxt = got.tokens[..., :1]

        def decode():
            nonlocal cache
            for _ in range(8):
                _, cache = model.decode(params, cache, nxt)

        for label, fn, n in (("prefill", prefill, 1), ("decode", decode, 8)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n
            if label == "decode":  # fill the cache back to the prompt's end
                _, cache = prefill()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                fn()
                torch.cuda.synchronize()
            events = p.key_averages()
            busy = 1e-3 * sum(e.self_device_time_total for e in events
                              if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
            busy /= n
            idle = max(0.0, 1.0 - busy / wall_ms)
            table = events.table(sort_by="self_device_time_total", row_limit=10)
            log(f"profile serve {arch} {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
                f"per {'prefill' if n == 1 else 'token'}; idle share {idle:.3f}")
            log(table)
            result[f"{label}_profile"] = {"busy_ms": busy, "wall_ms": wall_ms,
                                          "idle_share": idle, "table": table}
            if label == "prefill":
                _, cache = prefill()
    return result


def serve_against_cpu(torch, out):
    """The same parameters at full width, 2 layers, on the card and on the
    CPU (plain versions): prefill of one 256-token prompt and one decode
    step, last-token logits within ``LOGITS_REL``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import tree_util as T
    from repro_torch.models import build

    res = out["serve_card_vs_cpu"] = {}
    for arch in CARD_VS_CPU_ARCHS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        model = build(cfg)
        with torch.no_grad():
            p_gpu = model.init(seeded(torch, 43))
            p_cpu = T.tmap(lambda t: t.cpu(), p_gpu)
            gen = seeded(torch, 47)
            tok = torch.randint(0, cfg.vocab_size, (1, 257), generator=gen, device="cuda")
            errs = []
            for p, t in ((p_gpu, tok), (p_cpu, tok.cpu())):
                lg, cache = model.prefill(p, {"tokens": t[:, :256]}, 258)
                lg2, _ = model.decode(p, cache, t[:, 256:])
                errs.append((lg, lg2))
        e = max(rel_err(torch, a.cpu(), b) for a, b in zip(errs[0], errs[1]))
        log(f"{arch} at full width, 2 layers, batch 1, prompt 256: card vs CPU prefill and "
            f"one decode step, rel error {e:.3e}")
        check(e <= LOGITS_REL, f"{arch} card vs CPU: rel error {e} > {LOGITS_REL}")
        res[arch] = e


def device_profile(torch, run, rounds, host_ops: bool = True):
    """torch.profiler over ``run`` (``rounds`` rounds): device-busy ms and
    device activities (kernels, copies, fills) per round, and the profile's
    key averages; ``host_ops=False`` records the device alone (a round of
    many thousand host ops then profiles in a fraction of the time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    events = p.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return (1e-3 * sum(e.self_device_time_total for e in dev) / rounds,
            sum(e.count for e in dev) / rounds, events)


def profile_rounds(torch, label, run, round_ms, rounds, out):
    """torch.profiler over ``run`` (``rounds`` rounds): kernel time by name,
    device-busy time per round, and the device's idle share of the round
    time ``round_ms`` measured without the profiler."""
    busy_ms, _, events = device_profile(torch, run, rounds)
    idle = max(0.0, 1.0 - busy_ms / round_ms)
    log(f"profile {label}: device busy {busy_ms:.4f} ms/round of {round_ms:.4f} ms/round; "
        f"idle share {idle:.3f}")
    table = events.table(sort_by="self_device_time_total", row_limit=12)
    log(table)
    out[f"profile_{label}"] = {"busy_ms_per_round": busy_ms, "round_ms": round_ms,
                               "idle_share": idle, "table": table}



# ---------------------------------------------------------------------------
# phase 12: federated LM training, with the backward kernels 16b-17b
# ---------------------------------------------------------------------------

# 16b at the head dims of the archs phase "12 train archs" trains, (label,
# (B, S, H, Hkv, hd, vd), window): each at the training round's folded
# shape (m = 2 clients of 4 rows, 128 tokens) and at the prefill shape of
# phase 11 (batch 4, prompt 1,024; recurrentgemma's also at 4,096 keys,
# where its 2,048-key window binds); all on the warp tensor-core route
FLASH_BWD_HEAD_DIMS = (
    ("mla_train", (8, 128, 16, 16, 192, 128), None),
    ("mla", (4, 1024, 16, 16, 192, 128), None),
    ("recurrentgemma_train", (8, 128, 16, 1, 256, 256), 2048),
    ("recurrentgemma", (4, 1024, 16, 1, 256, 256), 2048),
    ("recurrentgemma_4096", (2, 4096, 16, 1, 256, 256), 2048),
    ("stablelm_train", (8, 128, 32, 8, 160, 160), None),
    ("stablelm", (4, 1024, 32, 8, 160, 160), None),
)
# (B, Sq, Sk, H, Hkv, hd, vd, dtype name, window, q_offset): olmo-1b's
# training and prefill shapes in bf16 and f32, the training round's folded
# batch (m = 2 clients of 4 rows), a small grouped, windowed case, one on the
# CUDA-core route (hd 24), two on the tensor-core route whose queries start
# past the first key (a continued prefill): Sq off the 64- and 128-row
# tiles, grouped, one windowed; then ``FLASH_BWD_HEAD_DIMS`` in bf16, MLA's
# training shape in f32 (the CUDA cores), and the warp tensor-core route's
# edges (Sq, Sk off its 64-row tiles, a query offset, one kv head with a
# window below a tile, vd above hd) and a bf16 pair off it (hd 200, vd 136:
# the CUDA cores)
FLASH_BWD_CASES = ((4, 128, 128, 16, 16, 128, 128, "bf16", None, 0),
                   (4, 1024, 1024, 16, 16, 128, 128, "bf16", None, 0),
                   (4, 128, 128, 16, 16, 128, 128, "f32", None, 0),
                   (4, 1024, 1024, 16, 16, 128, 128, "f32", None, 0),
                   (8, 128, 128, 16, 16, 128, 128, "bf16", None, 0),
                   (2, 256, 256, 8, 2, 64, 64, "bf16", 64, 0),
                   (2, 200, 200, 8, 2, 24, 24, "bf16", None, 0),
                   (2, 150, 280, 8, 2, 64, 64, "bf16", 100, 130),
                   (2, 90, 260, 8, 4, 128, 128, "bf16", None, 170)) + tuple(
    (B, S, S, H, Hkv, hd, vd, "bf16", window, 0)
    for _, (B, S, H, Hkv, hd, vd), window in FLASH_BWD_HEAD_DIMS) + (
    (8, 128, 128, 16, 16, 192, 128, "f32", None, 0),
    (1, 77, 200, 4, 1, 256, 256, "bf16", 40, 123),
    (2, 130, 130, 8, 2, 64, 128, "bf16", None, 0),
    (2, 100, 100, 4, 2, 160, 160, "bf16", 30, 0),
    (1, 100, 100, 2, 1, 200, 136, "bf16", None, 0))
# lru_scan_bwd: recurrentgemma-9b's prefill (batch 4, prompt 1,024, d_rnn
# 4,096) and the training round's folded batch (8, 128, 4,096)
LRU_BWD_SHAPES = ((4, 1024, 4096), (8, 128, 4096))
# rwkv6-1.6b's shape (B, S, H, K) with bf16 r, k, v; the training round's
# folded batch (m = 2 clients of 4 rows, one row of u a client) in bf16;
# then f32 with one row of u per pair of batch rows
WKV_BWD_CASES = ((4, 1024, 32, 64, "bf16", 1), (8, 128, 32, 64, "bf16", 2),
                 (4, 100, 4, 64, "f32", 2))
# vmap(grad) through ops.flash_attention and ops.wkv6 as a training round
# takes it: m clients of (B, S, H, hd) or (B, S, H, K), bf16
VMAP_GRAD = dict(m=2, flash=(4, 128, 16, 128), wkv=(4, 128, 32, 64))
# the timed shapes beside the prefill shapes: the training round's folded
# batch (m = 2 clients of 4 rows, sequences of 128)
FLASH_TRAIN_SHAPE = (8, 128, 16, 128)
WKV_TRAIN_SHAPE = (8, 128, 32, 64)
# 16b's library yardstick: SDPA's backward under each of its backends in
# turn (a pinned backend a timing), the fastest that takes the operands the
# library time and every one logged; every backward time a median of
# BWD_TRIALS trials of BWD_ITERS calls, the library's behind a spin long
# enough for autograd's host work
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")
BWD_TRIALS = 5
BWD_ITERS = 50
BWD_LIBRARY_SPIN = 2_000_000
# the backward against autograd of the plain forward: bf16 rounds P and dS
# (flash) or the operands (wkv6) before their products, two roundings of
# 2^-8 each; f32 sums in other orders
BWD_BF16_REL = 2.0 ** -6
BWD_F32_REL = 1e-4
# m = 2: at m = 4 the full-width GPDMM arena round held 63.6 GB when its
# drift metric asked for 17.5 GB more, past an H100 80GB's 79 GB; at m = 2
# the round peaks near 55 GB
TRAIN = dict(arch="olmo-1b", m=2, per_client_batch=4, seq_len=128, k=2, eta=0.05, rounds=3,
             more=2, seed=0)
TRAIN_RWKV = dict(arch="rwkv6-1.6b", n_layers=2, m=2, per_client_batch=4, seq_len=128, k=2,
                  eta=0.05, rounds=2)
# phase "12 train archs": GPDMM at full block width (m = 2, batch 4, 128
# tokens, K = 2, eta 0.05), cut in depth (deepseek: its dense first layer
# and one MoE layer; recurrentgemma: one (rec, rec, local) unit; stablelm: 2
# layers) and, where the untied (V, D) embedding and head would take the
# round past the card, in vocabulary (recurrentgemma's 256,000 alone are
# 2.10e9 parameters, ~155 GB of training state at olmo-1b's ~58 bytes a
# parameter at m = 2); no kernel's shape depends on V
TRAIN_ARCHS = {"deepseek-v2-lite-16b": dict(n_layers=2),
               "recurrentgemma-9b": dict(n_layers=3, vocab_size=32000),
               "stablelm-12b": dict(n_layers=2, vocab_size=32000)}
TRAIN_ARCH_RUN = dict(m=2, per_client_batch=4, seq_len=128, k=2, eta=0.05, rounds=3)
# the arch run twice more from the same seed, its logged rows bitwise equal
TRAIN_REPEAT = dict(arch="deepseek-v2-lite-16b", rounds=2)
# "12 train card vs cpu": the reduced configs in f32 at the full archs' head
# dims (MLA's 192 / 128, recurrentgemma's 256 on its one kv head, stablelm's
# 160), one round on the card against the same round on the CPU
TRAIN_CPU_HEADS = {"deepseek-v2-lite-16b": dict(nope_head_dim=128, rope_head_dim=64,
                                                v_head_dim=128),
                   "recurrentgemma-9b": dict(head_dim=256),
                   "stablelm-12b": dict(head_dim=160)}
TRAIN_CPU = dict(m=2, per_client_batch=4, seq_len=128, k=2, eta=0.05)
# the card's server parameters against the CPU's after one f32 round, of each
# leaf's largest magnitude: the same ops with sums in other orders (matrix
# products, 16b's tiles), carried through K = 2 steps
TRAIN_CPU_REL = 1e-4
POPSTORE_CKPT = dict(m=10 ** 5, width=1024, cohort=64, K=2, eta=0.1, rounds=2)
TRAIN_DIR = Path(__file__).resolve().parent / ".train_smoke"
# the LM example's small preset cut from 60 rounds: its check is finite losses
LM_EXAMPLE_ROUNDS = 6


def train_launches(n_attn: int, k: int, rounds: int, logged: int, n_rec: int = 0) -> dict:
    """A GPDMM arena round of the LM, read off the code: each of the K
    client gradients runs every attention layer forward (16) and backward
    (16b), and every RG-LRU layer's ``lru_scan`` and ``lru_scan_bwd``, once
    for all clients (the vmap rules fold them into the batch), the K steps
    are K ``fused_update_arena`` launches, the server step
    ``round_tail_mean`` + ``dual_from_uplink``; each logged row adds one
    vmapped forward of the server model."""
    want = dict(flash_attention=n_attn * (k * rounds + logged),
                flash_attention_bwd=n_attn * k * rounds, fused_update_arena=k * rounds,
                round_tail_mean=rounds, dual_from_uplink=rounds)
    if n_rec:
        want |= dict(lru_scan=n_rec * (k * rounds + logged), lru_scan_bwd=n_rec * k * rounds)
    return {n: c for n, c in want.items() if c}


def pytree_step_launches(torch, params) -> int:
    """``fused_update`` launches a step of a pytree round (a tree of mixed
    dtypes keeps the reference's pytree path, ``core.api.use_arena``): one
    per chunk of each dtype's segment table, as ``fused_update._launch``
    plans it."""
    from repro_torch.core import tree_util as T
    from repro_torch.kernels import fused_update as _fu

    groups: dict = {}
    for leaf in T.leaves(params):
        if leaf.numel():
            groups.setdefault(leaf.dtype, []).append(leaf.numel())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(len(_fu.plan(sizes, _fu._DTYPES[dt][1], _fu.max_segments(), sms))
               for dt, sizes in groups.items())


def flash_bwd_cost(B, S, H, hd, vd=None, Hkv=None, window=None,
                   itemsize=2) -> tuple[float, float]:
    """(bytes, operations) of 16b at a causal (B, S, H, hd) shape (vd
    default hd, Hkv default H, an optional window): q, k, v, o, do read and
    dq, dk, dv written once, in the operands' dtype, and lse f32; the
    products S, dk, dq of length hd and dP, dv of length vd over the visible
    (query, key) pairs (2.5 times the forward's at hd = vd)."""
    vd = hd if vd is None else vd
    Hkv = H if Hkv is None else Hkv
    nbytes = (itemsize * B * S * (H * (2 * hd + 2 * vd) + Hkv * (2 * hd + 2 * vd))
              + 4 * B * H * S)
    pairs2 = flash_flops(B, H, S, S, 1, window, vd=0)  # 2 B H pairs
    return nbytes, pairs2 * (3 * hd + 2 * vd)


def wkv_bwd_cost(B, S, H, K, n_u) -> tuple[float, float]:
    """(bytes, operations) of 17b at (B, S, H, K) bf16, V = K: per chunk att,
    dr and dk take C^2 K / 2 multiply-adds each with an exp, datt and dv
    C^2 V / 2, and four products of C K V: S0 dy (dr), dS v (dk), dS^T ec
    (dv) and the state gradient's (r e^la)^T dy."""
    nc, C, V = -(-S // 64), 64, K
    flops = 2.0 * B * H * nc * (3 * C * C * K / 2 + 2 * C * C * V / 2 + 4 * C * K * V)
    nbytes = (2 * 4 * B * S * H * K + 4 * B * S * H * K + 4 * H * K * n_u
              + 4 * 3 * B * H * K * K + 4 * B * H * nc * K * K      # read
              + 2 * 3 * B * S * H * K + 4 * B * S * H * K + 4 * H * K * n_u
              + 4 * B * H * K * K)                                  # written
    return nbytes, flops


def wkv_jvp_cost(B, S, H, K, n_u, itemsize=2) -> tuple[float, float]:
    """(bytes, operations) of 17j at (B, S, H, K), V = K: r, k, v and their
    tangents read and y' written once in the operands' dtype, w, w', u, u',
    s0, s0' and the forward's chunk states read and S_final' written in f32;
    the function's products per chunk: att and its tangent (r' k, r k', r k
    E': four of length K a pair), att' v and att v' (two of V a pair), and
    four of C K V (y''s r' S and r S', S''s k' v and k v')."""
    nc, C, V = -(-S // 64), 64, K
    flops = 2.0 * B * H * nc * ((4 * K + 2 * V) * C * C / 2 + 4 * C * K * V)
    nbytes = (itemsize * B * S * H * (4 * K + 3 * V) + 8 * B * S * H * K + 8 * H * K * n_u
              + 4 * B * H * K * V * (2 + nc))  # the states entering chunks 1 .. nc - 1
    return nbytes, flops


def wkv_bwd_jvp_cost(B, S, H, K, n_u, itemsize=2) -> tuple[float, float]:
    """(bytes, operations) of 17bj at (B, S, H, K), V = K: r, k, v, dy and
    their tangents read and dr', dk', dv' written once in the operands'
    dtype; w, w', u, u', s0, s0', s_out, ds_final, ds_final' and the
    forward's chunk states read and dw', du', ds0' written in f32.  The
    function's products per chunk, each primal that a tangent needs
    counted once beside its tangent: att (4 of K a pair with its tangent),
    datt (3 of V), dr's and dk's pair sums (4 of K each), dv''s pairs (2 of
    V), and 13 of C K V (S dy, dS v and the state gradient's (r e^la)^T dy,
    each with its two tangent products; dv''s dS' and dS terms; S''s k' v
    and k v')."""
    nc, C, V = -(-S // 64), 64, K
    flops = 2.0 * B * H * nc * ((12 * K + 5 * V) * C * C / 2 + 13 * C * K * V)
    nbytes = (itemsize * B * S * H * (6 * K + 5 * V) + 12 * B * S * H * K + 12 * H * K * n_u
              + 4 * B * H * K * V * (5 + nc))
    return nbytes, flops


def sdpa_backward(torch, q, k, v, do, backend: str, window=None):
    """One call of SDPA's autograd backward on (B, S, H, d) tensors
    (transposed to SDPA's layout) under ``backend``, as ``sdpa_forward``
    forms kernel 16's function: causal, grouped heads through
    ``enable_gqa``, a window that binds as a boolean mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, H, Hkv = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kw = {"enable_gqa": True} if Hkv != H else {}
    if window is None or window >= S:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    with sdpa_kernel(getattr(SDPBackend, backend)):
        ot = F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def run():
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    return run


def sdpa_fastest(torch, q, k, v, do, window=None, iters=BWD_ITERS, trials=BWD_TRIALS) -> dict:
    """SDPA's backward (``sdpa_backward``) under each of ``SDPA_BACKENDS``,
    medians of ``trials`` trials of ``iters`` calls: ``library_ms`` is the
    fastest backend's, ``library`` names it, ``library_trials`` are its
    trials and ``library_also`` holds every backend's median (or why it did
    not run: a backend that refuses the operands, e.g. vd != hd)."""
    every, trials_of = {}, {}
    for backend in SDPA_BACKENDS:
        try:
            every[backend], trials_of[backend] = med_ms(
                sdpa_backward(torch, q, k, v, do, backend, window), iters, trials,
                BWD_LIBRARY_SPIN)
        except RuntimeError as e:  # the backend does not take these operands here
            every[backend] = f"not run: {str(e).splitlines()[0][:120]}"
    ran = [b for b in SDPA_BACKENDS if b in trials_of]
    check(bool(ran), f"no SDPA backend ran at {tuple(q.shape)}: {every}")
    best = min(ran, key=lambda b: every[b])
    return dict(library_ms=every[best], library_trials=trials_of[best], library_also=every,
                library=f"autograd of scaled_dot_product_attention (causal), {best}, the "
                        f"fastest of {len(ran)} backends")


def check_backward_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 16b and 17b against autograd of their plain versions on the
    card, every case twice (the two runs bitwise equal); timed at olmo-1b's
    and rwkv6-1.6b's prefill shapes (``FLASH_SHAPE``, ``WKV_SHAPE``) and at
    the training round's folded shapes (``FLASH_TRAIN_SHAPE``,
    ``WKV_TRAIN_SHAPE``) with their bounds, the kernels and flash's library
    call (autograd of ``scaled_dot_product_attention`` under each backend,
    the fastest kept; ``sdpa_fastest``) as medians of ``BWD_TRIALS`` trials
    of ``BWD_ITERS`` calls."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import wkv6 as _wk

    dev = gen.device
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    res = out["backward_kernels"] = {}

    def twice(what, fn):
        """fn() twice; the two results bitwise equal."""
        a, b = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{what}: two runs differ")
        return a

    for B, Sq, Sk, H, Hkv, hd, vd, dn, window, off in FLASH_BWD_CASES:
        dt = dts[dn]
        q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Sk, Hkv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Sk, Hkv, vd, generator=gen, device=dev).to(dt)
        do = torch.randn(B, Sq, H, vd, generator=gen, device=dev).to(dt)
        o, lse = _fa.flash_attention(q, k, v, window=window, q_offset=off, lse=True)
        q_pos, k_pos = off + torch.arange(Sq, device=dev), torch.arange(Sk, device=dev)
        lse_w = ref.flash_attention_lse_ref(q, k, q_pos, k_pos, window=window)
        what = (f"flash_attention_bwd {(B, Sq, Sk, H, Hkv, hd, vd)} {dn} window {window} "
                f"q_offset {off}")
        got = twice(what, lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do, window=window,
                                                          q_offset=off))
        check(_fa.last_bwd_route == _fa.bwd_route(dt, hd, vd),
              f"{what}: route {_fa.last_bwd_route}")
        want = ref.flash_attention_bwd_ref(q, k, v, do, q_pos, k_pos, window=window)
        errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
        e_lse = max_err(lse, lse_w)
        tol = BWD_BF16_REL if dt == torch.bfloat16 else BWD_F32_REL
        check(max(errs) <= tol and e_lse <= KERNEL_F32_REL * max(1.0, float(lse_w.abs().max())),
              f"{what}: dq/dk/dv rel errors {errs} (tol {tol}), lse abs error {e_lse}")
        log(f"{what} ({_fa.last_bwd_route}): dq, dk, dv rel errors "
            f"{['%.3e' % e for e in errs]}, lse {e_lse:.3e}; two runs bitwise equal")
        res[f"flash {(B, Sq, Sk, H, Hkv, hd, vd)} {dn} {window} {off}"] = errs
        del q, k, v, do, o, lse, lse_w, got, want

    for B, S, H, K, dn, n_u in WKV_BWD_CASES:
        dt = dts[dn]
        r, kk, vv, dy = (torch.randn(B, S, H, K, generator=gen, device=dev).to(dt)
                         for _ in range(4))
        w = torch.exp(-torch.exp(0.5 * torch.randn(B, S, H, K, generator=gen, device=dev) - 1.0))
        u = 0.1 * torch.randn(*((n_u,) if n_u > 1 else ()), H, K, generator=gen, device=dev)
        s0 = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
        dsf = torch.randn(B, H, K, K, generator=gen, device=dev)
        y, s_out, states = _wk.wkv6(r, kk, vv, w, u, s0, keep_states=True)
        what = f"wkv6_bwd {(B, S, H, K)} {dn}, {n_u} row(s) of u"
        got = twice(what, lambda: _wk.wkv6_bwd(r, kk, vv, w, u, s0, s_out, states, dy, dsf))
        want = ref.wkv6_bwd_ref(r, kk, vv, w, u, s0, dy, dsf)
        errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
        tol = BWD_BF16_REL if dt == torch.bfloat16 else BWD_F32_REL
        check(max(errs) <= tol, f"{what}: dr dk dv dw du ds0 rel errors {errs} (tol {tol})")
        log(f"{what}: dr dk dv dw du ds0 rel errors {['%.3e' % e for e in errs]}; two runs "
            f"bitwise equal")
        res[what] = errs

    def flash_inputs(shape):
        B, S, H, hd = shape
        q, k, v, do = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = _fa.flash_attention(q, k, v, lse=True)
        return q, k, v, o, lse, do

    def wkv_inputs(shape, n_u):
        B, S, H, K = shape
        r, kk, vv, dy = (torch.randn(B, S, H, K, generator=gen, device=dev).to(torch.bfloat16)
                         for _ in range(4))
        w = torch.exp(-torch.exp(0.5 * torch.randn(B, S, H, K, generator=gen, device=dev) - 1.0))
        u = 0.1 * torch.randn(*((n_u,) if n_u > 1 else ()), H, K, generator=gen, device=dev)
        s0 = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
        dsf = torch.randn(B, H, K, K, generator=gen, device=dev)
        y, s_out, states = _wk.wkv6(r, kk, vv, w, u, s0, keep_states=True)
        return r, kk, vv, w, u, s0, s_out, states, dy, dsf

    # the prefill shapes: the kernels' rows (errors, times, bounds, plain and library)
    q, k, v, o, lse, do = flash_inputs(FLASH_SHAPE)
    pos = torch.arange(FLASH_SHAPE[1], device=dev)
    got = _fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, pos, pos)
    rec.kernel("flash_attention_bwd", max(max_err(a, b) for a, b in zip(got, want)),
               lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do),
               lambda: ref.flash_attention_bwd_ref(q, k, v, do, pos, pos), BWD_ITERS,
               *flash_bwd_cost(*FLASH_SHAPE), flop_per_s=BF16_FLOP_PER_S, trials=BWD_TRIALS,
               plain_iters=10)
    row = rec.rows["flash_attention_bwd"]
    row.update(sdpa_fastest(torch, q, k, v, do))
    log(f"flash_attention_bwd {FLASH_SHAPE}: kernel {row['ms']:.4f} ms (trials "
        f"{['%.4f' % t for t in row['ms_trials']]}); SDPA's backward {row['library_ms']:.4f} "
        f"ms, {row['library']} (trials {['%.4f' % t for t in row['library_trials']]}); every "
        f"backend {row['library_also']}")
    del q, k, v, o, lse, do, got, want

    args = wkv_inputs(WKV_SHAPE, 1)
    got = _wk.wkv6_bwd(*args)
    want = ref.wkv6_bwd_ref(*args[:6], *args[8:])
    rec.kernel("wkv6_bwd", max(max_err(a, b) for a, b in zip(got, want)),
               lambda: _wk.wkv6_bwd(*args), lambda: ref.wkv6_bwd_ref(*args[:6], *args[8:]),
               BWD_ITERS, *wkv_bwd_cost(*WKV_SHAPE, 1), trials=BWD_TRIALS, plain_iters=10)
    del args, got, want

    # the training round's folded shapes: times beside their bounds
    q, k, v, o, lse, do = flash_inputs(FLASH_TRAIN_SHAPE)
    b, by = bound_ms(*flash_bwd_cost(*FLASH_TRAIN_SHAPE), BF16_FLOP_PER_S)
    ms, ms_all = med_ms(lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do), BWD_ITERS,
                        BWD_TRIALS)
    train = rec.rows["flash_attention_bwd"]["train"] = dict(
        shape=FLASH_TRAIN_SHAPE, ms=ms, ms_trials=ms_all, bound_ms=b, bound_by=by,
        **sdpa_fastest(torch, q, k, v, do))
    log(f"flash_attention_bwd at the training shape {FLASH_TRAIN_SHAPE}: {ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}); SDPA's backward {train['library_ms']:.4f} ms, "
        f"{train['library']}; every backend {train['library_also']}")
    del q, k, v, o, lse, do
    args = wkv_inputs(WKV_TRAIN_SHAPE, 2)
    b, by = bound_ms(*wkv_bwd_cost(*WKV_TRAIN_SHAPE, 2))
    ms, ms_all = med_ms(lambda: _wk.wkv6_bwd(*args), BWD_ITERS, BWD_TRIALS)
    rec.rows["wkv6_bwd"]["train"] = dict(shape=WKV_TRAIN_SHAPE, ms=ms, ms_trials=ms_all,
                                         bound_ms=b, bound_by=by)
    log(f"wkv6_bwd at the training shape {WKV_TRAIN_SHAPE}: {ms:.4f} ms, bound {b:.4f} ms "
        f"({by})")
    del args
    torch.cuda.synchronize()
    time_backward_head_dims(rec, torch, gen, out)
    check_lru_scan_bwd(rec, torch, ref, gen, out)
    check_backward_functions(torch, ops, ref, gen, out)


def time_backward_head_dims(rec, torch, gen, out):
    """16b at ``FLASH_BWD_HEAD_DIMS`` (bf16; their errors are held in
    ``check_backward_kernels``' cases): medians of 3 trials, the bound
    (bf16 tensor-core rate), the plain version's time and the fastest SDPA
    backward that takes the shape (each backend pinned in turn; which
    refuse, and why, logged)."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ref

    dev, bf = gen.device, torch.bfloat16
    rows = rec.rows["flash_attention_bwd"]["head_dims"] = {}
    for label, (B, S, H, Hkv, hd, vd), window in FLASH_BWD_HEAD_DIMS:
        q, do = (torch.randn(B, S, H, d, generator=gen, device=dev).to(bf) for d in (hd, vd))
        k, v = (torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(bf) for d in (hd, vd))
        o, lse = _fa.flash_attention(q, k, v, window=window, lse=True)
        pos = torch.arange(S, device=dev)
        iters = 20 if S <= 128 else 5
        ms, ms_all = med_ms(lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do, window=window),
                            iters, 3)
        plain_ms = cuda_time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do, pos, pos,
                                                                    window=window),
                                2, spin_cycles=50_000_000)
        b, by = bound_ms(*flash_bwd_cost(B, S, H, hd, vd, Hkv, window), BF16_FLOP_PER_S)
        rows[label] = dict(shape=[B, S, H, Hkv, hd, vd], window=window,
                           route=_fa.last_bwd_route, ms=ms, ms_trials=ms_all, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by,
                           **sdpa_fastest(torch, q, k, v, do, window, iters, 3))
        r = rows[label]
        log(f"flash_attention_bwd {label} {(B, S, H, Hkv, hd, vd)} window {window}: "
            f"{ms:.4f} ms on {r['route']} (trials {['%.4f' % t for t in ms_all]}), plain "
            f"{plain_ms:.4f}, bound {b:.4f} ({by}); SDPA's backward {r['library_ms']:.4f} ms, "
            f"{r['library']}; every backend {r['library_also']}")
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    out["flash_bwd_head_dims"] = rows


def check_lru_scan_bwd(rec, torch, ref, gen, out):
    """``lru_scan_bwd`` bitwise autograd of ``ref.lru_ref`` on the card at
    ``LRU_BWD_SHAPES`` (gradients into y and h_last, a in [0, 1) as the
    RG-LRU's decays, h0 nonzero), each run twice (bitwise equal); timed at
    the prefill shape with its bound (a, y, dy read and da, db written
    once, f32: 5 S D B floats) and autograd of the plain recurrence as the
    plain version, and at the training shape beside its bound."""
    from repro_torch.kernels import lru_scan as _lr

    dev = gen.device
    res = out["lru_scan_bwd"] = {}
    for B, S, D in LRU_BWD_SHAPES:
        a = torch.rand(B, S, D, generator=gen, device=dev)
        b, dy = (torch.randn(B, S, D, generator=gen, device=dev) for _ in range(2))
        h0, dh = (torch.randn(B, D, generator=gen, device=dev) for _ in range(2))
        y, _ = _lr.lru_scan(a, b, h0)

        def plain():
            ins = [t.clone().requires_grad_(True) for t in (a, b, h0)]
            return torch.autograd.grad(ref.lru_ref(*ins), ins, (dy, dh))

        got = _lr.lru_scan_bwd(a, y, h0, dy, dh)
        again = _lr.lru_scan_bwd(a, y, h0, dy, dh)
        want = plain()
        check(all(torch.equal(x, z) for x, z in zip(got, again)),
              f"lru_scan_bwd {(B, S, D)}: two runs differ")
        check(all(torch.equal(x, w) for x, w in zip(got, want)),
              f"lru_scan_bwd {(B, S, D)}: not bitwise autograd of the plain recurrence (max "
              f"errors {[max_err(x, w) for x, w in zip(got, want)]})")
        log(f"lru_scan_bwd {(B, S, D)}: da, db, dh0 bitwise autograd of the plain recurrence; "
            f"two runs bitwise equal")
        nbytes, flops = 4 * (5 * B * S * D + 3 * B * D), 3.0 * B * S * D
        if (B, S, D) == LRU_BWD_SHAPES[0]:
            rec.kernel("lru_scan_bwd", 0.0, lambda: _lr.lru_scan_bwd(a, y, h0, dy, dh), plain,
                       20, nbytes, flops, plain_iters=1, plain_spin=200_000_000, trials=3)
            res["prefill"] = {k: rec.rows["lru_scan_bwd"][k]
                              for k in ("ms", "plain_ms", "bound_ms")}
        else:
            bnd, by = bound_ms(nbytes, flops)
            ms, ms_all = med_ms(lambda: _lr.lru_scan_bwd(a, y, h0, dy, dh), 20, 3)
            res["train"] = rec.rows["lru_scan_bwd"]["train"] = dict(
                shape=[B, S, D], ms=ms, ms_trials=ms_all, bound_ms=bnd, bound_by=by)
            log(f"lru_scan_bwd at the training shape {(B, S, D)}: {ms:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
        del a, b, dy, h0, dh, y, got, again, want


def check_backward_functions(torch, ops, ref, gen, out):
    """``vmap(grad)`` through ``ops.flash_attention`` and ``ops.wkv6`` on the
    card, as a training round takes its client gradients (``VMAP_GRAD``:
    olmo-1b's and rwkv6-1.6b's shapes, bf16, one row of u a client, s0
    unbatched), against ``vmap(grad)`` of the plain forwards on the same card
    tensors: each gradient within ``BWD_BF16_REL`` of its largest magnitude,
    and one launch of each kernel for all the clients (the vmap rules fold
    them into the batch)."""
    dev = gen.device
    bf, m = torch.bfloat16, VMAP_GRAD["m"]
    res = out["backward_functions"] = {}

    def held(what, got, want, counts, kernels):
        errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
        shapes = all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, want))
        check(shapes and max(errs) <= BWD_BF16_REL,
              f"vmap(grad) {what}: rel errors {errs} (tol {BWD_BF16_REL}), shapes {shapes}")
        check(all(counts[k] == 1 for k in kernels),
              f"vmap(grad) {what}: launches {counts}, expected one of each of {kernels}")
        log(f"vmap(grad) {what}, m = {m}: rel errors {['%.3e' % e for e in errs]}; one launch "
            f"each of {kernels}")
        res[what] = errs

    B, S, H, hd = VMAP_GRAD["flash"]
    q, k, v = (torch.randn(m, B, S, H, hd, generator=gen, device=dev).to(bf) for _ in range(3))
    c = torch.randn(B, S, H, hd, generator=gen, device=dev)
    pos = torch.arange(S, device=dev)

    def f(q, k, v):
        return (ops.flash_attention(q, k, v, causal=True).float() * c).sum()

    def f_plain(q, k, v):
        return (ref.flash_attention_ref(q, k, v, pos, pos, causal=True).float() * c).sum()

    ops.reset_launches()
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    counts = ops.launches()
    want = torch.func.vmap(torch.func.grad(f_plain, argnums=(0, 1, 2)))(q, k, v)
    held(f"flash_attention {(B, S, H, hd)}", got, want, counts,
         ("flash_attention", "flash_attention_bwd"))
    del q, k, v, got, want

    B, S, H, K = VMAP_GRAD["wkv"]
    r, kk, vv = (torch.randn(m, B, S, H, K, generator=gen, device=dev).to(bf) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(m, B, S, H, K, generator=gen, device=dev) - 1.0))
    u = 0.1 * torch.randn(m, H, K, generator=gen, device=dev)
    s0 = torch.zeros(B, H, K, K, device=dev)
    cy = torch.randn(B, S, H, K, generator=gen, device=dev)
    cs = torch.randn(B, H, K, K, generator=gen, device=dev)

    def loss(fn):
        def f(r, k, v, w, u):
            y, s = fn(r, k, v, w, u, s0)
            return (y.float() * cy).sum() + (s * cs).sum()
        return f

    args = (0, 1, 2, 3, 4)
    ops.reset_launches()
    got = torch.func.vmap(torch.func.grad(loss(ops.wkv6), argnums=args))(r, kk, vv, w, u)
    torch.cuda.synchronize()
    counts = ops.launches()
    want = torch.func.vmap(torch.func.grad(loss(ref.wkv6_ref), argnums=args))(r, kk, vv, w, u)
    held(f"wkv6 {(B, S, H, K)}, u a client", got, want, counts, ("wkv6", "wkv6_bwd"))


# ---------------------------------------------------------------------------
# phase 12, forward mode: the tangent kernels 16j, 16bj and the RG-LRU's
# ---------------------------------------------------------------------------

# 16j and 16bj at the training round's folded batch (m = 2 clients of 4
# rows, 128 tokens), (label, (B, S, H, Hkv, hd, vd), window): olmo-1b, MLA's
# 192 / 128, recurrentgemma's 256 on one kv head with its window, stablelm's
# 160 with GQA; each in bf16 and f32
FLASH_JVP_CASES = (("olmo-1b", (8, 128, 16, 16, 128, 128), None),
                   ("deepseek MLA", (8, 128, 16, 16, 192, 128), None),
                   ("recurrentgemma local", (8, 128, 16, 1, 256, 256), 2048),
                   ("stablelm", (8, 128, 32, 8, 160, 160), None))
# lru_scan_jvp and lru_scan_bwd_jvp: recurrentgemma-9b's prefill shape and the
# training round's folded batch
LRU_JVP_SHAPES = ((4, 1024, 4096), (8, 128, 4096))
# the tangents against their plain versions, relative to the largest
# magnitude: f32 sums in other orders; bf16 one rounding of the f32 result
# (16j), 16bj's sums cancelling more (2^-6, as 16b's)
JVP_F32_REL = 1e-4
JVP_BF16_REL = 2.0 ** -7
BWD_JVP_BF16_REL = 2.0 ** -6
JVP_ITERS = 20
JVP_TRIALS = 3
# wkv6_jvp and wkv6_bwd_jvp (17j, 17bj), (B, S, H, K, dtype, rows of u,
# decay): rwkv6-1.6b's prefill shape in bf16 with s0 != 0 (timed), the
# training round's folded batch with two rows of u (timed), f32 at a ragged
# length, f32 at phase 11's extreme decay (w = 1e-30 mixed with 0.9), and
# f32 at a slow decay (w = exp(-0.02 exp(.)), about 0.6 over a chunk, where
# the model's leaves near 1e-11: the state and its tangent carried into the
# next chunk weigh in), the last also in bf16 at the training shape, nearer
# the model's initial decay (exp(-exp(-6))); w' = w x' throughout, the chain
# rule's form through the model's exp(-exp(.)).  Tolerances: y' as 16j's o', 17bj's outputs as 16bj's, f32
# as theirs; dw' at the extreme decay held as dw' w, since dw' = (dlw' - dlw
# w' / w) / w is rounding noise times 1e30 there in any order of sums
WKV_JVP_CASES = ((*WKV_SHAPE, "bf16", 1, "model"), (*WKV_TRAIN_SHAPE, "bf16", 2, "model"),
                 (2, 100, 4, 64, "f32", 2, "model"), (2, 100, 4, 64, "f32", 1, "extreme"),
                 (2, 200, 4, 64, "f32", 2, "slow"), (*WKV_TRAIN_SHAPE, "bf16", 2, "slow"))
WKV_JVP_ITERS = 10
# torch.func.jvp of SDPA under each backend, the yardstick of 16j
SDPA_JVP_BACKENDS = ("MATH", "CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def flash_jvp_cost(B, S, H, Hkv, hd, vd, window=None, itemsize=2) -> tuple[float, float]:
    """(bytes, operations) of 16j at a causal (B, S, H, hd) shape: q, k, v
    and their tangents read and o' written once in the operands' dtype, lse
    read and lse' written in f32; S (hd), S' (two of hd), and S' v, P v', P
    v (vd) over the visible (query, key) pairs."""
    nbytes = itemsize * B * S * (2 * H * hd + 2 * Hkv * (hd + vd) + H * vd) + 8 * B * H * S
    return nbytes, flash_flops(B, H, S, S, 1, window, vd=0) * (3 * hd + 3 * vd)


def flash_bwd_jvp_cost(B, S, H, Hkv, hd, vd, window=None, itemsize=2) -> tuple[float, float]:
    """(bytes, operations) of 16bj: q, k, v, o, do and their tangents read
    and dq', dk', dv' written once, lse read in f32; S and S' (three of hd),
    dP and dP' (three of vd), dq' and dk' (two of hd each), dv' (two of vd)
    over the visible pairs: 7 hd + 5 vd, the function's count (the kernel
    recomputes S, S', dP and dP' in its second grid)."""
    nbytes = (itemsize * B * S * (2 * H * (hd + 2 * vd) + 2 * Hkv * (hd + vd)
                                  + H * hd + Hkv * (hd + vd)) + 4 * B * H * S)
    return nbytes, flash_flops(B, H, S, S, 1, window, vd=0) * (7 * hd + 5 * vd)


def sdpa_jvp(torch, q, k, v, qt, kt, vt, backend: str, window=None):
    """One call of ``torch.func.jvp`` of ``scaled_dot_product_attention`` on
    (B, S, H, d) tensors (transposed to SDPA's layout) under ``backend``:
    (o, o'), the function 16j computes beside the forward's o."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, H, Hkv = q.shape[1], q.shape[2], k.shape[2]
    prim = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
    tang = tuple(t.transpose(1, 2).contiguous() for t in (qt, kt, vt))
    kw = {"enable_gqa": True} if Hkv != H else {}
    if window is None or window >= S:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def run():
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return torch.func.jvp(lambda a, b, c: F.scaled_dot_product_attention(a, b, c, **kw),
                                  prim, tang)
    run()
    return run


def sdpa_jvp_fastest(torch, q, k, v, qt, kt, vt, window=None) -> dict:
    """``sdpa_jvp`` under each of ``SDPA_JVP_BACKENDS``: the fastest that runs
    is ``library_ms``; every backend's median, or why it did not run, in
    ``library_also``; ``library_ms`` None when none runs."""
    every, trials_of = {}, {}
    for backend in SDPA_JVP_BACKENDS:
        try:
            every[backend], trials_of[backend] = med_ms(
                sdpa_jvp(torch, q, k, v, qt, kt, vt, backend, window), JVP_ITERS, JVP_TRIALS,
                BWD_LIBRARY_SPIN)
        except (RuntimeError, NotImplementedError) as e:
            every[backend] = f"not run: {str(e).splitlines()[0][:120]}"
    ran = [b for b in SDPA_JVP_BACKENDS if b in trials_of]
    if not ran:
        return dict(library_ms=None, library_also=every, library="none")
    best = min(ran, key=lambda b: every[b])
    return dict(library_ms=every[best], library_also=every,
                library=f"torch.func.jvp of scaled_dot_product_attention (causal), {best}, the "
                        f"fastest of {len(ran)} backends that ran")


def check_jvp_kernels(rec, torch, ops, ref, gen, out):
    """Kernels 16j and 16bj at ``FLASH_JVP_CASES`` (bf16 and f32) against
    their plain versions (``ref.flash_attention_jvp_ref``,
    ``flash_attention_bwd_jvp_ref``) at ``JVP_F32_REL`` / ``JVP_BF16_REL`` /
    ``BWD_JVP_BF16_REL``, and ``lru_scan_jvp``, ``lru_scan_bwd_jvp`` at
    ``LRU_JVP_SHAPES`` bitwise ``torch.func.jvp`` of ``ref.lru_ref`` and
    ``ref.lru_bwd_ref``; every case run twice, the two bitwise equal.
    Each bf16 flash case and each RG-LRU shape timed (medians of
    ``JVP_TRIALS`` trials) beside its bound and its plain version; the
    kernels' rows at olmo-1b's training shape in bf16 (16j beside the
    fastest ``torch.func.jvp`` of SDPA) and recurrentgemma's prefill shape."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import lru_scan as _lr

    dev = gen.device
    res = out["jvp_kernels"] = {"flash": {}, "lru": {}}

    def twice(what, fn):
        a, b = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{what}: two runs differ")
        return a

    def rel(got, want):
        return [rel_err(torch, a, b) for a, b in zip(got, want)]

    for label, (B, S, H, Hkv, hd, vd), window in FLASH_JVP_CASES:
        for dt in (torch.bfloat16, torch.float32):
            def rand(*shape):
                return torch.randn(*shape, generator=gen, device=dev).to(dt)

            q, qt, k, kt = rand(B, S, H, hd), rand(B, S, H, hd), rand(B, S, Hkv, hd), rand(
                B, S, Hkv, hd)
            v, vt, do, dot = rand(B, S, Hkv, vd), rand(B, S, Hkv, vd), rand(B, S, H, vd), rand(
                B, S, H, vd)
            o, lse = _fa.flash_attention(q, k, v, window=window, lse=True)
            pos = torch.arange(S, device=dev)
            what = f"{label} {(B, S, H, Hkv, hd, vd)} {dt} window {window}"

            def fwd():
                return _fa.flash_attention_jvp(q, k, v, lse, qt, kt, vt, window=window)

            def bwd():
                return _fa.flash_attention_bwd_jvp(q, k, v, o, lse, do, qt, kt, vt, ot, dot,
                                                   window=window)

            def fwd_plain():
                return ref.flash_attention_jvp_ref(q, k, v, lse, qt, kt, vt, pos, pos,
                                                   window=window)

            def bwd_plain():
                return ref.flash_attention_bwd_jvp_ref(q, k, v, o, lse, do, qt, kt, vt, ot, dot,
                                                       pos, pos, window=window)

            f32 = dt == torch.float32
            path = _fa.jvp_route(dt, hd, vd)
            check(path == ("cuda_cores" if f32 else "mma"), f"jvp route {path} for {what}")
            ot, lse_t = twice(f"flash_attention_jvp {what}", fwd)
            check(_fa.last_jvp_route == path, f"flash_attention_jvp {what}: ran on "
                                              f"{_fa.last_jvp_route}, not {path}")
            e_fwd = rel((ot, lse_t), fwd_plain())
            got = twice(f"flash_attention_bwd_jvp {what}", bwd)
            check(_fa.last_jvp_route == path, f"flash_attention_bwd_jvp {what}: ran on "
                                              f"{_fa.last_jvp_route}, not {path}")
            e_bwd = rel(got, bwd_plain())
            t_fwd, t_bwd = (JVP_F32_REL, JVP_F32_REL) if f32 else (JVP_BF16_REL, BWD_JVP_BF16_REL)
            check(e_fwd[0] <= t_fwd and e_fwd[1] <= JVP_F32_REL,
                  f"flash_attention_jvp {what}: o', lse' rel errors {e_fwd} (tol {t_fwd})")
            check(max(e_bwd) <= t_bwd,
                  f"flash_attention_bwd_jvp {what}: dq', dk', dv' rel errors {e_bwd} "
                  f"(tol {t_bwd})")
            row = {"o_t, lse_t": e_fwd, "dq_t, dk_t, dv_t": e_bwd, "route": path}
            log(f"jvp kernels {what} on {path}: 16j o', lse' rel errors "
                f"{['%.3e' % e for e in e_fwd]}; 16bj dq', dk', dv' "
                f"{['%.3e' % e for e in e_bwd]}; two runs bitwise equal")
            if not f32:
                for name, fn, plain_fn, cost in (
                        ("flash_attention_jvp", fwd, fwd_plain, flash_jvp_cost),
                        ("flash_attention_bwd_jvp", bwd, bwd_plain, flash_bwd_jvp_cost)):
                    nbytes, flops = cost(B, S, H, Hkv, hd, vd, window)
                    lib = (sdpa_jvp_fastest(torch, q, k, v, qt, kt, vt, window)
                           if name == "flash_attention_jvp" else
                           dict(library_ms=None, library="none"))
                    if label == FLASH_JVP_CASES[0][0]:
                        rec.kernel(name, max(max_err(a, b) for a, b in zip(fn(), plain_fn())),
                                   fn, plain_fn, JVP_ITERS, nbytes, flops,
                                   flop_per_s=BF16_FLOP_PER_S, trials=JVP_TRIALS, plain_iters=5)
                        rec.rows[name].update(lib, jvp_route=path)
                        row[name] = {k: rec.rows[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                                                    "bound_by", "library_ms")}
                    else:
                        ms, ms_all = med_ms(fn, JVP_ITERS, JVP_TRIALS)
                        b, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
                        plain_ms = cuda_time_ms(plain_fn, 5, spin_cycles=2_000_000)
                        row[name] = dict(ms=ms, ms_trials=ms_all, plain_ms=plain_ms, bound_ms=b,
                                         bound_by=by, route=path, **lib)
                        rec.rows[name].setdefault("head_dims", {})[label] = row[name]
                    r = row[name]
                    libt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                    log(f"{name} {what} on {path}: {r['ms']:.4f} ms, plain "
                        f"{r['plain_ms']:.4f}, library {libt}, bound {r['bound_ms']:.4f} "
                        f"({r['bound_by']})")
                    if "library_also" in lib:
                        log(f"{name}: {lib['library']}; every backend {lib['library_also']}")
            res["flash"][what] = row
            del q, qt, k, kt, v, vt, do, dot, o, lse, ot, lse_t, got
        torch.cuda.empty_cache()

    for B, S, D in LRU_JVP_SHAPES:
        a = torch.rand(B, S, D, generator=gen, device=dev)
        b, at, bt, dy, dyt = (torch.randn(B, S, D, generator=gen, device=dev) for _ in range(5))
        h0, h0t, dh, dht = (torch.randn(B, D, generator=gen, device=dev) for _ in range(4))
        y, _ = _lr.lru_scan(a, b, h0)

        def fwd():
            return _lr.lru_scan_jvp(a, y, h0, at, bt, h0t)

        def fwd_plain():
            return torch.func.jvp(ref.lru_ref, (a, b, h0), (at, bt, h0t))[1]

        yt, hlt = twice(f"lru_scan_jvp {(B, S, D)}", fwd)

        def bwd():
            return _lr.lru_scan_bwd_jvp(a, y, h0, dy, dh, at, yt, h0t, dyt, dht)

        def bwd_plain():
            return torch.func.jvp(ref.lru_bwd_ref, (a, y, h0, dy, dh), (at, yt, h0t, dyt, dht))[1]

        got = twice(f"lru_scan_bwd_jvp {(B, S, D)}", bwd)
        for name, g_, w_ in (("lru_scan_jvp", (yt, hlt), fwd_plain()),
                             ("lru_scan_bwd_jvp", got, bwd_plain())):
            check(all(torch.equal(x, w) for x, w in zip(g_, w_)),
                  f"{name} {(B, S, D)}: not bitwise torch.func.jvp of the plain version (max "
                  f"errors {[max_err(x, w) for x, w in zip(g_, w_)]})")
        log(f"lru_scan_jvp, lru_scan_bwd_jvp {(B, S, D)}: bitwise torch.func.jvp of the plain "
            f"recurrence and of its backward; two runs bitwise equal")
        row = res["lru"][str((B, S, D))] = {}
        # (bytes, operations): y' reads a, y, a', b' and writes y'; the
        # backward's reads a, y, dy and their tangents and writes da', db'
        costs = {"lru_scan_jvp": (4 * (5 * B * S * D + 3 * B * D), 4.0 * B * S * D),
                 "lru_scan_bwd_jvp": (4 * (8 * B * S * D + 5 * B * D), 9.0 * B * S * D)}
        for name, fn, plain_fn in (("lru_scan_jvp", fwd, fwd_plain),
                                   ("lru_scan_bwd_jvp", bwd, bwd_plain)):
            nbytes, flops = costs[name]
            if (B, S, D) == LRU_JVP_SHAPES[0]:
                rec.kernel(name, 0.0, fn, plain_fn, JVP_ITERS, nbytes, flops, plain_iters=1,
                           plain_spin=400_000_000, trials=JVP_TRIALS)
                row[name] = {k: rec.rows[name][k] for k in ("ms", "plain_ms", "bound_ms")}
            else:
                bnd, by = bound_ms(nbytes, flops)
                ms, ms_all = med_ms(fn, JVP_ITERS, JVP_TRIALS)
                row[name] = rec.rows[name]["train"] = dict(
                    shape=[B, S, D], ms=ms, ms_trials=ms_all, bound_ms=bnd, bound_by=by)
                log(f"{name} at the training shape {(B, S, D)}: {ms:.4f} ms, bound {bnd:.4f} ms "
                    f"({by})")
        del a, b, at, bt, dy, dyt, h0, h0t, dh, dht, y, yt, hlt, got
    torch.cuda.empty_cache()
    check_wkv_jvp_kernels(rec, torch, ref, gen, out)


def check_wkv_jvp_kernels(rec, torch, ref, gen, out):
    """Kernels 17j and 17bj at ``WKV_JVP_CASES`` against their plain versions
    (``ref.wkv6_jvp_ref``, ``ref.wkv6_bwd_jvp_ref``), every case run twice
    (the two bitwise equal) and each wrapper one launch a call; timed at
    rwkv6-1.6b's prefill shape (the kernels' rows: bound at the bf16
    operands' tensor-core rate, as 16j's, plain version; no library call
    computes the RWKV-6 recurrence or its tangents) and at the training
    round's folded shape (bound and plain time beside it)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as _wk

    dev = gen.device
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    res = out["jvp_kernels"]["wkv"] = {}

    def twice(what, fn):
        a, b = fn(), fn()
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{what}: two runs differ")
        return a

    for B, S, H, K, dn, n_u, decay in WKV_JVP_CASES:
        dt = dts[dn]

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        r, kk, rt, kt, vv, vt, dy, dyt = (rn(B, S, H, K).to(dt) for _ in range(8))
        if decay == "extreme":
            w = torch.full((B, S, H, K), 1e-30, device=dev)
            w[:, ::3] = 0.9
        else:
            w = torch.exp(-(0.02 if decay == "slow" else 1.0)
                          * torch.exp(0.5 * rn(B, S, H, K) - 1.0))
        wt = w * rn(B, S, H, K)
        u_shape = (n_u, H, K) if n_u > 1 else (H, K)
        u, ut = 0.1 * rn(*u_shape), 0.1 * rn(*u_shape)
        s0, s0t = 0.1 * rn(B, H, K, K), 0.1 * rn(B, H, K, K)
        dsf, dsft = rn(B, H, K, K), rn(B, H, K, K)
        y, s_out, states = _wk.wkv6(r, kk, vv, w, u, s0, keep_states=True)
        what = f"{(B, S, H, K)} {dn}, {n_u} row(s) of u, decay {decay}"

        def fwd():
            return _wk.wkv6_jvp(r, kk, vv, w, u, s0, states, rt, kt, vt, wt, ut, s0t)

        def bwd():
            return _wk.wkv6_bwd_jvp(r, kk, vv, w, u, s0, s_out, states, dy, dsf, rt, kt, vt, wt,
                                    ut, s0t, dyt, dsft)

        def fwd_plain():
            return ref.wkv6_jvp_ref(r, kk, vv, w, u, s0, rt, kt, vt, wt, ut, s0t)

        def bwd_plain():
            return ref.wkv6_bwd_jvp_ref(r, kk, vv, w, u, s0, dy, dsf, rt, kt, vt, wt, ut, s0t,
                                        dyt, dsft)

        ops.reset_launches()
        got_j = twice(f"wkv6_jvp {what}", fwd)
        got_b = list(twice(f"wkv6_bwd_jvp {what}", bwd))
        counts = ops.launches()
        check(counts["wkv6_jvp"] == 2 and counts["wkv6_bwd_jvp"] == 2,
              f"wkv6 tangents {what}: launches {counts}")
        want_j, want_b = fwd_plain(), list(bwd_plain())
        if decay == "extreme":
            got_b[3], want_b[3] = got_b[3] * w, want_b[3] * w
        e_j = [rel_err(torch, a, b) for a, b in zip(got_j, want_j)]
        e_b = [rel_err(torch, a, b) for a, b in zip(got_b, want_b)]
        f32 = dt == torch.float32
        t_j, t_b = (JVP_F32_REL, JVP_F32_REL) if f32 else (JVP_BF16_REL, BWD_JVP_BF16_REL)
        check(e_j[0] <= t_j and e_j[1] <= JVP_F32_REL,
              f"wkv6_jvp {what}: y', s_final' rel errors {e_j} (tol {t_j})")
        check(max(e_b[:3]) <= t_b and max(e_b[3:]) <= JVP_F32_REL,
              f"wkv6_bwd_jvp {what}: dr' dk' dv' dw' du' ds0' rel errors {e_b} (tol {t_b})")
        check(all(bool(torch.isfinite(x).all()) for x in (*got_j, *got_b)),
              f"wkv6 tangents {what}: not finite")
        log(f"wkv6 tangents {what}: 17j y', s_final' rel errors {['%.3e' % e for e in e_j]}; "
            f"17bj dr' dk' dv' dw'{' w' if decay == 'extreme' else ''} du' ds0' "
            f"{['%.3e' % e for e in e_b]}; two runs bitwise equal")
        row = res[what] = {"y_t, s_final_t": e_j, "dr_t dk_t dv_t dw_t du_t ds0_t": e_b}
        timed = (B, S, H, K) in (WKV_SHAPE, WKV_TRAIN_SHAPE) and dn == "bf16" and decay == "model"
        for name, fn, plain_fn, cost in (("wkv6_jvp", fwd, fwd_plain, wkv_jvp_cost),
                                         ("wkv6_bwd_jvp", bwd, bwd_plain, wkv_bwd_jvp_cost)):
            if not timed:
                continue
            nbytes, flops = cost(B, S, H, K, n_u)
            if (B, S, H, K) == WKV_SHAPE:
                err = max(max_err(a, b) for a, b in zip(fn(), plain_fn()))
                rec.kernel(name, err, fn, plain_fn, WKV_JVP_ITERS, nbytes, flops,
                           flop_per_s=BF16_FLOP_PER_S, plain_iters=2,
                           plain_spin=100_000_000, trials=JVP_TRIALS)
                rec.rows[name]["library"] = ("none: no PyTorch call computes the RWKV-6 "
                                             "recurrence or its tangents")
                r_ = row[name] = {k: rec.rows[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                                                 "bound_by")}
            else:
                ms, ms_all = med_ms(fn, WKV_JVP_ITERS, JVP_TRIALS)
                b_, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
                plain_ms = cuda_time_ms(plain_fn, 2, spin_cycles=100_000_000)
                r_ = row[name] = rec.rows[name]["train"] = dict(
                    shape=[B, S, H, K], ms=ms, ms_trials=ms_all, plain_ms=plain_ms, bound_ms=b_,
                    bound_by=by)
            log(f"{name} {what}: {r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f}, bound "
                f"{r_['bound_ms']:.4f} ({r_['bound_by']}); library none")
        del r, kk, rt, kt, vv, vt, dy, dyt, w, wt, u, ut, s0, s0t, dsf, dsft, y, s_out, states
        del got_j, got_b, want_j, want_b
        torch.cuda.empty_cache()


def _rows_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        (a[k] == b[k]) or (a[k] != a[k] and b[k] != b[k]) for k in a)


def train_phase(rec, torch, ops, out):
    """olmo-1b at full width and depth through ``launch.train.run``: 3
    rounds into a checkpoint, 2 more with ``resume``, against 5 rounds
    uninterrupted (every logged value bitwise equal); finite loss and drift,
    ``lam_sum_norm`` at its rounding scale, the launches as derived; then
    ms a round, peak allocation and the idle share of the same round."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch import train

    res = out["train"] = {}
    cfg = get_arch(TRAIN["arch"])
    n_attn = cfg.n_layers
    m = TRAIN["m"]
    kw = dict(reduced=False, algorithm="gpdmm", k=TRAIN["k"], eta=TRAIN["eta"],
              per_client_batch=TRAIN["per_client_batch"], seq_len=TRAIN["seq_len"],
              seed=TRAIN["seed"], log_every=1, device="cuda")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    free = shutil.disk_usage(TRAIN_DIR.parent).free
    log(f"train: free disk {free / 1e9:.1f} GB, host MemAvailable "
        f"{(mem_available_bytes() or 0) / 1e9:.1f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = train.run(TRAIN["arch"], steps=TRAIN["rounds"], m=m, ckpt_dir=str(TRAIN_DIR),
                      ckpt_keep=1, **kw)
    torch.cuda.synchronize()
    counts = ops.launches()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec.add(counts)
    want = {n: 0 for n in counts} | train_launches(n_attn, TRAIN["k"], TRAIN["rounds"],
                                                   TRAIN["rounds"])
    log(f"train {TRAIN['arch']} full width, m={m}: {TRAIN['rounds']} rounds + checkpoint in "
        f"{first_s:.1f} s; peak allocation {peak / 1e9:.2f} GB; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    check(counts == want, f"train: launches {counts}, expected {want}")
    for row in first:
        log(f"train row {row}")
        check(all(math.isfinite(v) for v in row.values()), f"train: row not finite {row}")
    res |= {"m": m, "peak_allocated_gb": peak / 1e9, "first_run_s": first_s, "rows": first}

    t0 = time.perf_counter()
    resumed = train.run(TRAIN["arch"], steps=TRAIN["rounds"] + TRAIN["more"], m=m,
                        ckpt_dir=str(TRAIN_DIR), ckpt_keep=1, resume=True, **kw)
    resume_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    whole = train.run(TRAIN["arch"], steps=TRAIN["rounds"] + TRAIN["more"], m=m, **kw)
    whole_s = time.perf_counter() - t0
    log(f"train: resumed {TRAIN['more']} rounds in {resume_s:.1f} s; "
        f"{TRAIN['rounds'] + TRAIN['more']} uninterrupted rounds in {whole_s:.1f} s")
    check([r["round"] for r in resumed] == [r["round"] for r in whole[TRAIN["rounds"]:]],
          f"train resume: rounds {[r['round'] for r in resumed]}")
    for a, b in zip(first + resumed, whole):
        check(_rows_equal(a, b), f"train resume: {a} != uninterrupted {b}")
    log("train: save at 3 + resume == 5 uninterrupted rounds, every logged value bitwise")
    res |= {"resume_s": resume_s, "whole_s": whole_s, "resumed_rows": resumed,
            "whole_rows": whole}
    t0 = time.perf_counter()
    res |= train_round_profile(torch, m)
    res["profile_s"] = time.perf_counter() - t0
    log(f"train: the round's profile in {res['profile_s']:.1f} s")


def check_wide_arena(torch, ops, ref, gen, out):
    """Kernels 4, 2 and 3 (``fused_update_arena``, ``round_tail_mean``,
    ``server_dual``) once each on seeded bf16 data at the (m, W) arena of
    the olmo-1b training above, whose m W elements pass 2^31, against their
    plain versions over every column, a slice of columns at a time: the
    step, the running sum, the dual flip and the dual refresh (given the
    kernel's uplink and mean) bitwise; the uplink within one bf16 step of
    each entry and 2^-21 |lam_is / rho| (the plain version multiplies by
    1/rho, the kernel divides); the client mean within
    one bf16 step of ``torch.mean`` of the kernel's uplink; lam's
    column sum within 2 (d + 2) u of each column's sum |lam| of
    ``torch.sum`` (d the kernel's summation depth, u = 2^-24)."""
    from repro_torch.kernels import round_tail as RT

    m, W = TRAIN["m"], out["train"]["arena_width"]
    check(m * W > 2 ** 31, f"wide arena: m W = {m * W} does not pass 2^31")
    dev, bf, f32 = gen.device, torch.bfloat16, torch.float32
    rho, step, cols = 2.5, 0.05, 1 << 26
    slices = [slice(c, min(c + cols, W)) for c in range(0, W, cols)]

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf)

    x, g, lam, acc0 = draw(m, W), draw(m, W), draw(m, W), draw(m, W)
    xs = draw(W)
    acc = acc0.clone()
    ops.reset_launches()
    got = ops.fused_update_arena(x, g, xs, lam, step, rho, acc=acc, acc_mode="last",
                                 acc_scale=1.0 / TRAIN["k"])
    for sl in slices:
        a = acc0[:, sl].clone()
        want = ref.fused_update_arena_ref(x[:, sl], g[:, sl], xs[sl], lam[:, sl], step, rho,
                                          acc=a, acc_mode="last", acc_scale=1.0 / TRAIN["k"])
        check(same_bits(torch, got[:, sl], want) and same_bits(torch, acc[:, sl], a),
              f"wide arena: fused_update_arena differs in columns {sl.start}:{sl.stop}")
    del x, g, acc0, acc, got

    x_ref = draw(m, W)
    lam_is, up, mean = ops.round_tail_mean(x_ref, lam, xs, rho, with_lam_is=True)
    lam_n, colsum = ops.server_dual(up, mean, rho)
    d = RT.depth_on(up)
    counts = ops.launches()
    check(counts["fused_update_arena"] == 1 and counts["round_tail_mean"] == 1
          and counts["dual_from_uplink"] == 1, f"wide arena: launches {counts}")
    for sl in slices:
        li, u = ref.round_tail_ref(x_ref[:, sl], lam[:, sl], xs[sl], rho)
        check(same_bits(torch, lam_is[:, sl], li),
              f"wide arena: round_tail_mean's flip differs in {sl.start}:{sl.stop}")
        # the kernel divides lam_is by rho where the plain version multiplies
        # by 1/rho: up to 2^-22 |lam_is / rho| apart in f32, then one bf16
        # rounding each (the uplink may cancel far below |lam_is / rho|)
        q = (rho * (xs[sl].float() - x_ref[:, sl].float()) - lam[:, sl].float()).abs() / rho
        steps = torch.maximum(bf16_ulp(torch, up[:, sl]), bf16_ulp(torch, u)) + 2.0 ** -21 * q
        check(bool(((up[:, sl].float() - u.float()).abs() <= steps).all()),
              f"wide arena: uplink off by more than a bf16 step in {sl.start}:{sl.stop}")
        u = up[:, sl]
        mt = torch.mean(u, dim=0)
        steps = torch.maximum(bf16_ulp(torch, mean[sl]), bf16_ulp(torch, mt))
        check(bool(((mean[sl].float() - mt.float()).abs() <= steps).all()),
              f"wide arena: client mean off by more than a bf16 step in {sl.start}:{sl.stop}")
        ln = ref.dual_from_uplink_ref(u, mean[sl], rho)
        check(same_bits(torch, lam_n[:, sl], ln),
              f"wide arena: server_dual's lam differs in {sl.start}:{sl.stop}")
        lf = ln.to(f32)
        tol = 2 * (d + 2) * UNIT_ROUNDOFF * lf.abs().sum(0)
        check(bool(((colsum[sl] - lf.sum(0)).abs() <= tol).all()),
              f"wide arena: lam's column sum off in {sl.start}:{sl.stop} (depth {d})")
    log(f"wide arena ({m}, {W}) bf16, {m * W} elements (element 2^31 is row "
        f"{2 ** 31 // W}, column {2 ** 31 % W}): fused_update_arena, round_tail_mean and "
        f"server_dual against their plain versions over all {W} columns in "
        f"{len(slices)} slices")
    out["wide_arena"] = {"m": m, "width": W, "elements": m * W, "slices": len(slices)}
    del x_ref, lam, xs, lam_is, up, mean, lam_n, colsum
    torch.cuda.empty_cache()


def lam_sum_held(torch, state, met, fcfg, m, what) -> tuple[float, float]:
    """The round's ``lam_sum_norm`` against its rounding scale: the norm of a
    sum that is zero in exact arithmetic, which the bf16 arena holds to eps
    (rho m ||x_s|| + sqrt(m) ||lam||_F), eps = 2^-8 (phase 3's invariants,
    with bf16's rounding)."""
    from repro_torch.core import arena, resolved_rho
    from repro_torch.core import tree_util as T

    if torch.is_tensor(state["lam_s"]):  # the arena's (m, W) buffer
        spec = arena.ArenaSpec.from_tree(state["x_s"])
        xs = float(spec.pack(state["x_s"]).float().norm())
        lam_f = float(state["lam_s"].float().norm())
    else:  # the pytree path's stacked leaves
        xs, lam_f = float(T.tree_norm(state["x_s"])), float(T.tree_norm(state["lam_s"]))
    scale = 2.0 ** -8 * (resolved_rho(fcfg) * m * xs + math.sqrt(m) * lam_f)
    lsn = float(met["lam_sum_norm"])
    log(f"{what} round: lam_sum_norm {lsn:.4e} against its rounding scale {scale:.4e} "
        f"(||x_s|| {xs:.4e}, ||lam||_F {lam_f:.4e})")
    check(math.isfinite(lsn) and lsn <= scale, f"{what}: lam_sum_norm {lsn} > {scale}")
    return lsn, scale


def train_round_profile(torch, m) -> dict:
    """The launcher's round (the same model, optimiser and data calls)
    timed on its own: ms a round with CUDA synchronisation, peak allocation
    and the device's idle share under torch.profiler."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make, prng
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build

    cfg = get_arch(TRAIN["arch"])
    model = build(cfg)
    params = model.init(prng.key(TRAIN["seed"]), device="cuda")
    fcfg = FederatedConfig(algorithm="gpdmm", inner_steps=TRAIN["k"], eta=TRAIN["eta"],
                           num_clients=m)
    fed = make(fcfg)
    rnd = fed.round_ or fed.round
    state = fed.init(params, m)
    del params

    def grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    batches = list(lm_batches(prng.key(TRAIN["seed"] + 1), 5, m, TRAIN["per_client_batch"],
                              TRAIN["seq_len"], cfg.vocab_size, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    state, _ = rnd(state, grad, batches[0])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:3]:
        state, met = rnd(state, grad, b)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / 2
    lsn, scale = lam_sum_held(torch, state, met, fcfg, m, "train")
    holder = {"s": state}
    del state

    def two():
        for b in batches[3:5]:
            holder["s"], _ = rnd(holder["s"], grad, b)

    busy_ms, acts, events = device_profile(torch, two, 2, host_ops=False)
    peak = torch.cuda.max_memory_allocated()
    idle = max(0.0, 1.0 - busy_ms / round_ms)
    log(f"train round {TRAIN['arch']} m={m}: {round_ms:.2f} ms/round, device busy "
        f"{busy_ms:.2f} ms/round ({acts:.0f} device activities), idle share {idle:.3f}, "
        f"peak allocation {peak / 1e9:.2f} GB")
    table = events.table(sort_by="self_device_time_total", row_limit=15)
    log(table)
    width = holder["s"]["lam_s"].shape[1]
    del holder
    torch.cuda.empty_cache()
    return {"arena_width": width, "round_ms": round_ms, "busy_ms_per_round": busy_ms,
            "idle_share": idle,
            "round_peak_allocated_gb": peak / 1e9, "lam_sum_norm": lsn,
            "lam_sum_norm_scale": scale, "profile_table": table}


def train_rwkv_phase(rec, torch, ops, out):
    """rwkv6-1.6b at full width, depth cut to 2 layers: GPDMM rounds on the
    card with kernels 17 and 17b; loss and drift finite."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make, prng
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build

    P_ = TRAIN_RWKV
    cfg = dataclasses.replace(get_arch(P_["arch"]), n_layers=P_["n_layers"])
    model = build(cfg)
    params = model.init(prng.key(0), device="cuda")
    fed = make(FederatedConfig(algorithm="gpdmm", inner_steps=P_["k"], eta=P_["eta"],
                               num_clients=P_["m"]))
    state = fed.init(params, P_["m"])

    def grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    ops.reset_launches()
    rows = []
    for b in lm_batches(prng.key(1), P_["rounds"], P_["m"], P_["per_client_batch"],
                        P_["seq_len"], cfg.vocab_size, device="cuda"):
        state, met = fed.round(state, grad, b)
        with torch.no_grad():
            loss = float(torch.func.vmap(lambda x: model.loss(fed.server_params(state),
                                                              x)[0])(b).mean())
        rows.append({"server_loss": loss, "client_drift": float(met["client_drift"])})
    torch.cuda.synchronize()
    counts = ops.launches()
    rec.add(counts)
    log(f"train {P_['arch']} full width, {P_['n_layers']} layers, m={P_['m']}: rows {rows}; "
        f"launches { {n: c for n, c in counts.items() if c} }")
    n_grad = P_["n_layers"] * P_["k"] * P_["rounds"]
    check(counts["wkv6_bwd"] == n_grad and counts["wkv6"] == n_grad + P_["n_layers"]
          * P_["rounds"], f"train rwkv: launches {counts}")
    check(all(math.isfinite(v) for r in rows for v in r.values()), f"train rwkv: {rows}")
    out["train_rwkv"] = {"rows": rows, "launches": {n: c for n, c in counts.items() if c}}
    del state, params
    torch.cuda.empty_cache()


def _arch_round_setup(torch, cfg, device, m, k, eta, seed=0):
    """The launcher's round for ``cfg``: the keyed init from ``prng.key(seed)``
    on ``device``, the GPDMM state and the client gradient
    ``torch.func.grad`` of the model's loss (the round vmaps it)."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import make, prng
    from repro_torch.models import build

    model = build(cfg)
    params = model.init(prng.key(seed), device=device)
    fcfg = FederatedConfig(algorithm="gpdmm", inner_steps=k, eta=eta, num_clients=m)
    fed = make(fcfg)

    def grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    return model, params, fcfg, fed, grad


def train_arch_rounds(rec, torch, ops, arch, rounds, profile) -> dict:
    """``rounds`` GPDMM rounds of ``arch`` cut by ``TRAIN_ARCHS`` on the card
    (``TRAIN_ARCH_RUN``; the batches ``lm_batches`` from ``prng.key(1)``),
    each with its logged evaluation (a vmapped forward of the server model):
    finite loss and drift, the launches as ``train_launches`` derives them,
    ``lam_sum_norm`` at its rounding scale; with ``profile`` 2 more rounds
    timed (ms a round) and 2 profiled (busy, idle share), and the peak
    allocation of all of them."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core import tree_util as T
    from repro_torch.core.api import use_arena
    from repro_torch.data.synthetic import lm_batches

    R = TRAIN_ARCH_RUN
    m, k = R["m"], R["k"]
    cfg = dataclasses.replace(get_arch(arch), **TRAIN_ARCHS[arch])
    kinds = [cfg.block_pattern[i % cfg.pattern_len] for i in range(cfg.n_layers)]
    n_attn = sum(b != "rec" for b in kinds)
    n_rec = len(kinds) - n_attn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, fcfg, fed, grad = _arch_round_setup(torch, cfg, "cuda", m, k, R["eta"])
    n_params = sum(p.numel() for p in T.leaves(params))
    on_arena = use_arena(fcfg, params)
    step_launches = 0 if on_arena else pytree_step_launches(torch, params)
    state = fed.init(params, m)
    del params
    batches = list(lm_batches(prng.key(1), rounds + (4 if profile else 0), m,
                              R["per_client_batch"], R["seq_len"], cfg.vocab_size,
                              device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    rows = []
    for b in batches[:rounds]:
        state, met = fed.round(state, grad, b)
        with torch.no_grad():
            loss = torch.func.vmap(lambda x: model.loss(fed.server_params(state), x)[0])(b)
        rows.append({"server_loss": float(loss.mean()),
                     "client_drift": float(met["client_drift"]),
                     "lam_sum_norm": float(met["lam_sum_norm"])})
    torch.cuda.synchronize()
    counts = ops.launches()
    rec.add(counts)
    want = {n: 0 for n in counts} | train_launches(n_attn, k, rounds, rounds, n_rec)
    if not on_arena:  # the pytree round: K step launches, the server step plain ops
        for n in ("fused_update_arena", "round_tail_mean", "dual_from_uplink"):
            want[n] = 0
        want["fused_update"] = k * rounds * step_launches
    cuts = dict(TRAIN_ARCHS[arch])
    log(f"train {arch} ({cfg.n_layers} layers {kinds}, {cfg.first_dense_layers} dense first; "
        f"cut {cuts}; full block width, {n_params:.4g} parameters; "
        f"{'arena' if on_arena else 'pytree'} path), m={m}: {rounds} rounds; rows {rows}; "
        f"launches { {n: c for n, c in counts.items() if c} }")
    check(counts == want, f"train {arch}: launches {counts}, expected {want}")
    check(all(math.isfinite(v) for r in rows for v in r.values()), f"train {arch}: {rows}")
    res = {"layers": kinds, "cut": cuts, "parameters": n_params, "init_s": init_s,
           "arena": on_arena, "rows": rows, "launches": {n: c for n, c in counts.items() if c}}
    lsn, scale = lam_sum_held(torch, state, met, fcfg, m, f"train {arch}")
    res |= {"lam_sum_norm": lsn, "lam_sum_norm_scale": scale}
    if profile:
        rnd = fed.round_ or fed.round
        holder = {"s": state}
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[rounds:rounds + 2]:
            holder["s"], _ = rnd(holder["s"], grad, b)
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / 2

        def two():
            for b in batches[rounds + 2:]:
                holder["s"], _ = rnd(holder["s"], grad, b)

        busy_ms, acts, events = device_profile(torch, two, 2, host_ops=False)
        idle = max(0.0, 1.0 - busy_ms / round_ms)
        peak = torch.cuda.max_memory_allocated()
        log(f"train {arch} round: {round_ms:.2f} ms/round, device busy {busy_ms:.2f} ms/round "
            f"({acts:.0f} device activities), idle share {idle:.3f}, peak allocation "
            f"{peak / 1e9:.2f} GB")
        table = events.table(sort_by="self_device_time_total", row_limit=12)
        log(table)
        res |= {"round_ms": round_ms, "busy_ms_per_round": busy_ms, "idle_share": idle,
                "peak_allocated_gb": peak / 1e9, "profile_table": table}
        del holder
    else:
        del state
    torch.cuda.empty_cache()
    return res


def train_archs_phase(rec, torch, ops, out):
    """The archs of ``TRAIN_ARCHS`` trained on the card (``train_arch_rounds``:
    MLA and MoE with kernels 16/16b at hd 192 / vd 128, recurrentgemma's
    RG-LRU with ``lru_scan``/``lru_scan_bwd`` and its local attention at hd 256
    on one kv head, stablelm's hd 160), each timed and profiled; then
    ``TRAIN_REPEAT``'s arch run twice more from the same seed, every logged
    value of the two runs, and of the first run's rounds, bitwise equal."""
    res = out["train_archs"] = {}
    for arch in TRAIN_ARCHS:
        res[arch] = train_arch_rounds(rec, torch, ops, arch, TRAIN_ARCH_RUN["rounds"], True)
    arch, n = TRAIN_REPEAT["arch"], TRAIN_REPEAT["rounds"]
    a = train_arch_rounds(rec, torch, ops, arch, n, False)["rows"]
    b = train_arch_rounds(rec, torch, ops, arch, n, False)["rows"]
    check(all(_rows_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b) == n,
          f"train {arch}: two runs from one seed differ: {a} != {b}")
    check(all(_rows_equal(x, y) for x, y in zip(a, res[arch]["rows"][:n])),
          f"train {arch}: the repeat differs from the first run's rounds")
    log(f"train {arch}: two runs of {n} rounds from one seed, and the first run's first "
        f"{n}, every logged value bitwise equal")
    res["repeat"] = {"arch": arch, "rows": a}


def train_against_cpu(torch, ops, out):
    """``TRAIN_CPU_HEADS``: the reduced configs in f32 at the full archs' head
    dims, the same weights (drawn on the CPU) and batch on both sides, one
    GPDMM round on the card (kernels 16/16b on their f32 routes at those
    dims, ``lru_scan``/``lru_scan_bwd``, the MoE dispatch's backward) against
    the round on the CPU's plain versions: every server parameter within
    ``TRAIN_CPU_REL`` of its leaf's largest magnitude."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core import tree_util as T
    from repro_torch.data.synthetic import lm_batches

    res = out["train_card_vs_cpu"] = {}
    C = TRAIN_CPU
    for arch, heads in TRAIN_CPU_HEADS.items():
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **heads)
        model, params, _, fed, grad = _arch_round_setup(torch, cfg, "cpu", C["m"], C["k"],
                                                        C["eta"])
        batch = next(lm_batches(prng.key(1), 1, C["m"], C["per_client_batch"], C["seq_len"],
                                cfg.vocab_size, device="cpu"))
        want, _ = fed.round(fed.init(params, C["m"]), grad, batch)
        ops.reset_launches()
        got, _ = fed.round(fed.init(T.tmap(lambda x: x.cuda(), params), C["m"]), grad,
                           {n: v.cuda() for n, v in batch.items()})
        torch.cuda.synchronize()
        counts = {n: c for n, c in ops.launches().items() if c}
        errs = [rel_err(torch, a.cpu(), b)
                for a, b in zip(T.leaves(fed.server_params(got)),
                                T.leaves(fed.server_params(want)))]
        grads_k = ("flash_attention_bwd", "lru_scan_bwd") if "recurrent" in arch else (
            "flash_attention_bwd",)
        check(all(counts.get(n, 0) > 0 for n in grads_k),
              f"train card vs cpu {arch}: launches {counts}, none of {grads_k}")
        check(max(errs) <= TRAIN_CPU_REL,
              f"train card vs cpu {arch}: server parameters off by {max(errs)}")
        log(f"train card vs cpu {arch} reduced, f32, heads {heads}: one round's server "
            f"parameters within {max(errs):.3e} of the CPU's (tolerance {TRAIN_CPU_REL}); "
            f"card launches {counts}")
        res[arch] = {"heads": heads, "max_rel_err": max(errs), "launches": counts}
        del got, want, params
    torch.cuda.empty_cache()


# phase "12 eta auto": (a) olmo-1b at full width and depth at phase 12's
# round (m = 2 clients, batch 4, 128 tokens) with 16 power iterations, not
# the launcher's 96 (0.62-0.76 s a product on an H100: 97 do not fit
# the script's time; ``--full-probe`` runs these settings for rwkv6-1.6b's
# 24 layers instead, ``FULL_PROBE``); (b) ``launch.train.run(eta="auto",
# steps=1)`` for ``ETA_AUTO_ARCHS`` at their cuts, its probe at ``ETA_AUTO_RUN["iters"]``
# iterations; (c) the card against the CPU on the reduced configs of "12
# train card vs cpu" in f32, 8 iterations over a probe batch of one 64-token
# row a client (the CPU's probes at that phase's 4 x 128 took 39 s)
ETA_AUTO = dict(arch="olmo-1b", m=2, per_client_batch=4, seq_len=128, iters=16, seed=83)
ETA_AUTO_RUN = dict(m=2, per_client_batch=4, seq_len=128, k=2, steps=1, iters=8)
ETA_AUTO_CPU = dict(m=2, per_client_batch=1, seq_len=64, iters=8)
# (b)'s archs at their cuts: ``TRAIN_ARCHS``' and rwkv6-1.6b at ``TRAIN_RWKV``'s
# 2 layers (kernels 17, 17b, 17j, 17bj); (c)'s: "12 train card vs cpu"'s and
# rwkv6-1.6b's reduced config, whose wkv heads stay 64 wide
ETA_AUTO_ARCHS = {**TRAIN_ARCHS, "rwkv6-1.6b": dict(n_layers=TRAIN_RWKV["n_layers"])}
ETA_AUTO_CPU_HEADS = {**TRAIN_CPU_HEADS, "rwkv6-1.6b": {}}
# L on the card against the CPU's: the probe's start vector (a constant plus
# a ramp) lies almost in the Hessian's null space, so its first product is a
# small difference of large terms (its norm and the two devices' relative
# difference in it are logged, ``first_product``); the power iteration, 8
# steps from converged, carries that difference into the Rayleigh quotient
# (up to 5.2e-3 on an H100, as far with the plain ops on the card as with
# the kernels)
L_CARD_CPU_RTOL = 2e-2
# L through the kernels against L through the plain ops on the same card:
# the same start, products within 1e-6 of each other (measured 3e-5)
L_PLAIN_RTOL = 1e-3
# ``--full-probe``: rwkv6-1.6b's probe at full width and depth with
# ``ETA_AUTO``'s settings (too long for the default call), then witnesses
# of its L (``witness``), one set of weights each through the plain ops on
# the card (the reference), the kernels, and controls that compute the same
# function rounded otherwise: the plain ops with the recurrence summed in
# 32-step chunks, and the CPU.  (a) The reduced config in f32 at all 24 layers
# with ``ETA_AUTO_CPU``'s settings at 128 tokens (two chunks, so that 17j
# and 17bj pass state between them), the CPU among the controls; (b) full
# width in bf16 at ``TRAIN_RWKV``'s 2 layers and (c) at all 24, batch 1 a
# client (the plain recurrence's pairwise decays, saved with their tangents
# in all 24 layers, do not fit beside batch 4's).  Each holds the kernels'
# L, and their Hessian-vector product at one random unit vector a client,
# to the reference's within the larger of ``WITNESS_FLOORS`` (bf16 or f32
# rounding compounded over the layers) and ``SPREAD_FACTOR`` times the
# farthest control's distance from it; all but (c).  At 24 layers a
# reordering of sums moves the product ~1e4 times as far as it moves the
# operands (in (a) on an H100 the CPU's product sat 8.9e-4 from the card's,
# the kernels' 1.1e-3, the 32-step chunks', which reorder few sums, 2e-6),
# so in bf16, whose rounding is 2^-9, a route that reorders the recurrence's
# sums throughout, as the kernels do, can move it O(1) and no control at
# hand does as much: (c) is recorded, its launches and finite values checked.
FULL_PROBE = {**ETA_AUTO, "arch": "rwkv6-1.6b"}
FULL_PROBE_WITNESS = {**FULL_PROBE, "per_client_batch": 1}
WITNESS_FLOORS = {"bfloat16": {"product": 5e-2, "L": 5e-2},
                  "float32": {"product": 1e-4, "L": L_PLAIN_RTOL}}
SPREAD_FACTOR = 2.0


def probe_launches(n_attn: int, n_rec: int, n_wkv: int, iters: int) -> dict:
    """The curvature probe's launches, read off the code: each of its
    iters + 1 Hessian-vector products runs every attention layer's 16, 16b,
    16j and 16bj once for all clients (the vmap rules fold them into the
    batch), every RG-LRU layer's ``lru_scan``, ``lru_scan_bwd`` and their
    tangents likewise, and every RWKV layer's 17, 17b, 17j and 17bj (17bj's
    four launches are one call, counted once)."""
    n = iters + 1
    want = {}
    for layers, names in ((n_attn, ("flash_attention", "flash_attention_bwd",
                                    "flash_attention_jvp", "flash_attention_bwd_jvp")),
                          (n_rec, ("lru_scan", "lru_scan_bwd", "lru_scan_jvp",
                                   "lru_scan_bwd_jvp")),
                          (n_wkv, ("wkv6", "wkv6_bwd", "wkv6_jvp", "wkv6_bwd_jvp"))):
        if layers:
            want |= {name: layers * n for name in names}
    return want


def plain_model_ops(torch, ops, ref, wkv_chunk=64):
    """Route ``ops.flash_attention``, ``ops.lru_scan`` and ``ops.wkv6`` to
    their plain versions for CUDA tensors (the model's calls; a comparison
    only, undone by the returned function); the plain recurrence in chunks
    of ``wkv_chunk`` steps."""
    saved = ops.flash_attention, ops.lru_scan, ops.wkv6

    def flash(q, k, v, q_pos=None, k_pos=None, *, causal=True, window=None, q_offset=None):
        off = q_offset or 0
        return ref.flash_attention_ref(q, k, v, off + torch.arange(q.shape[1], device=q.device),
                                       torch.arange(k.shape[1], device=q.device), causal=causal,
                                       window=window)

    ops.flash_attention, ops.lru_scan = flash, ref.lru_ref
    ops.wkv6 = functools.partial(ref.wkv6_ref, chunk=wkv_chunk)

    def undo():
        ops.flash_attention, ops.lru_scan, ops.wkv6 = saved
    return undo


def hvp_at(torch, arena, T, grad_fn, params, batch, v):
    """Each client's Hessian-vector product at its row of ``v`` (m, width),
    as ``estimate_L`` forms it for a tree gradient."""
    spec = arena.ArenaSpec.from_tree(params)
    primal = T.tmap(lambda x: x, params)

    def one(bi, vi):
        return spec.pack(torch.func.jvp(lambda p: grad_fn(p, bi), (primal,),
                                        (spec.unpack(vi),))[1])
    return torch.func.vmap(one)(batch, v)


def first_product(torch, autotune, arena, T, grad_fn, params, m, batch):
    """The probe's first Hessian-vector product, at its start vector
    (``autotune``'s own)."""
    spec = arena.ArenaSpec.from_tree(params)
    dev = T.leaves(params)[0].device
    v0 = autotune._normalize(autotune._v0(m, spec.width, dev))
    return hvp_at(torch, arena, T, grad_fn, params, batch, v0)


def layer_kinds(cfg) -> tuple[int, int, int]:
    """(attention, RG-LRU, RWKV) layers of an arch config: the kernels its
    layers run (every block that is neither "rec" nor "rwkv" attends)."""
    kinds = [cfg.block_pattern[i % cfg.pattern_len] for i in range(cfg.n_layers)]
    n_rec, n_wkv = kinds.count("rec"), kinds.count("rwkv")
    return len(kinds) - n_rec - n_wkv, n_rec, n_wkv


def full_probe(torch, ops, E) -> tuple[dict, dict]:
    """``autotune.estimate_L`` at full width and depth for the arch and
    settings ``E`` (``ETA_AUTO``'s keys), the weights drawn from its seed:
    its result (L, seconds, seconds a Hessian-vector product, peak
    allocation, launches) and the launch counts, checked against
    ``probe_launches``."""
    from repro_torch.configs import get_arch
    from repro_torch.core import autotune, prng
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build

    cfg = get_arch(E["arch"])
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(seeded(torch, E["seed"]))
    probe = next(lm_batches(prng.key(E["seed"] + 3), 1, E["m"], E["per_client_batch"],
                            E["seq_len"], cfg.vocab_size, device="cuda"))

    def client_grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    L = autotune.estimate_L(client_grad, params, E["m"], probe, iters=E["iters"])
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in counts} | probe_launches(*layer_kinds(cfg), E["iters"])
    nz = {n: c for n, c in counts.items() if c}
    log(f"eta auto {E['arch']} full width and depth ({cfg.n_layers} layers), m={E['m']}, batch "
        f"{E['per_client_batch']}, {E['seq_len']} tokens, {E['iters']} iterations: per-client "
        f"L in [{L.min():.6g}, {L.max():.6g}] in {probe_s:.2f} s "
        f"({probe_s / (E['iters'] + 1):.4f} s a product); peak allocation {peak / 1e9:.2f} GB; "
        f"launches {nz}")
    check(counts == want, f"eta auto {E['arch']}: launches {counts}, expected {want}")
    check(all(math.isfinite(float(x)) for x in L) and float(L.min()) > 0.0,
          f"eta auto {E['arch']}: L {L}")
    del params, probe
    torch.cuda.empty_cache()
    return ({"L": [float(x) for x in L], "seconds": probe_s, "iters": E["iters"],
             "layers": cfg.n_layers, "s_per_product": probe_s / (E["iters"] + 1),
             "peak_allocated_gb": peak / 1e9, "launches": nz}, counts)


def eta_auto_phase(rec, torch, ops, ref, out):
    """``--eta auto`` on the card: its curvature probe ``vmap(jvp(grad(loss)))``
    through the forward-mode rules (kernels 16j, 16bj, 17j, 17bj,
    ``lru_scan_jvp``, ``lru_scan_bwd_jvp``); see ``ETA_AUTO``,
    ``ETA_AUTO_RUN``, ``ETA_AUTO_CPU``, ``L_CARD_CPU_RTOL`` and
    ``L_PLAIN_RTOL``."""
    import dataclasses

    from repro_torch.core import autotune
    from repro_torch.launch import train

    res = out["eta_auto"] = {}
    res[ETA_AUTO["arch"]], counts = full_probe(torch, ops, ETA_AUTO)
    rec.add(counts)

    R = ETA_AUTO_RUN
    get, full = train.get_arch, autotune.estimate_L
    # the launcher's probe (train.run calls autotune.estimate_L) at R's iterations
    autotune.estimate_L = functools.partial(full, iters=R["iters"])
    try:
        for arch, cuts in ETA_AUTO_ARCHS.items():
            train.get_arch = lambda a, _c=cuts: dataclasses.replace(get(a), **_c)
            cut = train.get_arch(arch)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            rows = train.run(arch, reduced=False, eta="auto", steps=R["steps"], m=R["m"],
                             per_client_batch=R["per_client_batch"], seq_len=R["seq_len"],
                             k=R["k"], log_every=1, device="cuda")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = ops.launches()
            rec.add(counts)
            peak = torch.cuda.max_memory_allocated()
            log(f"eta auto train.run {arch} (cut {cuts}, probe {R['iters']} iterations), "
                f"{R['steps']} round: rows {rows} in "
                f"{run_s:.2f} s; peak allocation {peak / 1e9:.2f} GB; launches "
                f"{ {n: c for n, c in counts.items() if c} }")
            check(len(rows) == R["steps"] and all(math.isfinite(r["server_loss"]) for r in rows),
                  f"eta auto train.run {arch}: rows {rows}")
            probe_want = probe_launches(*layer_kinds(cut), R["iters"])
            check(all(counts.get(n, 0) >= c for n, c in probe_want.items()),
                  f"eta auto train.run {arch}: launches {counts}, the probe's {probe_want}")
            res[arch] = {"cut": cuts, "rows": rows, "seconds": run_s,
                         "peak_allocated_gb": peak / 1e9,
                         "launches": {n: c for n, c in counts.items() if c}}
    finally:
        train.get_arch, autotune.estimate_L = get, full

    for arch, cuts in ETA_AUTO_CPU_HEADS.items():
        res[f"{arch} card vs cpu"] = reduced_card_vs_cpu(torch, ops, ref, arch, cuts)


def full_probe_phase(torch, ops, ref, out) -> None:
    """``--full-probe``: rwkv6-1.6b's curvature probe at full width and depth
    (``FULL_PROBE``) and the witnesses of its L that ``FULL_PROBE``'s
    comment names, all run before any is checked."""
    import dataclasses

    from repro_torch.configs import get_arch

    res = out["full_probe"] = {}
    res["probe"], _ = full_probe(torch, ops, FULL_PROBE)
    full = get_arch(FULL_PROBE["arch"])
    cut = dataclasses.replace(full.reduced(), dtype="float32", n_layers=full.n_layers)
    small = {**ETA_AUTO_CPU, "seq_len": 128, "seed": FULL_PROBE["seed"]}
    shallow = dataclasses.replace(full, n_layers=TRAIN_RWKV["n_layers"])
    res["reduced f32, full depth"] = witness(torch, ops, ref, cut, small, cpu=True)
    res["full width bf16, 2 layers"] = witness(torch, ops, ref, shallow, FULL_PROBE_WITNESS)
    res["full size bf16"] = witness(torch, ops, ref, full, FULL_PROBE_WITNESS, held=False)
    failed = [f for w in res.values() for f in w.get("failed", ())]
    check(not failed, f"full probe witnesses: {failed}")


def witness(torch, ops, ref, cfg, E, cpu: bool = False, held: bool = True) -> dict:
    """``cfg`` at ``E``'s settings (m, per_client_batch, seq_len, iters, seed),
    its weights drawn from ``E``'s seed, through the routes that
    ``FULL_PROBE``'s comment names (with ``cpu``, the CPU among them): each
    route's L, seconds, peak allocation, launches and Hessian-vector
    product at one random unit vector a client, logged, and the checks'
    failures (``failed``): the launches as derived (none outside the
    kernels' route), finite values and, with ``held``, the kernels' product
    and L within the larger of ``WITNESS_FLOORS[cfg.dtype]`` and
    ``SPREAD_FACTOR`` times the farthest control's distance from the
    reference's."""
    from repro_torch.core import arena, autotune, prng
    from repro_torch.core import tree_util as T
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build

    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(seeded(torch, E["seed"]))
    batch = next(lm_batches(prng.key(E["seed"] + 3), 1, E["m"], E["per_client_batch"],
                            E["seq_len"], cfg.vocab_size, device="cuda"))
    width = arena.ArenaSpec.from_tree(params).width
    v = autotune._normalize(torch.randn(E["m"], width, generator=seeded(torch, E["seed"] + 5),
                                        device="cuda")).cpu()

    def client_grad(p, b):
        return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

    # (name, chunk of the plain recurrence or None for the kernels, device);
    # the reference first: each other route's product is held to its and
    # dropped, so that the host keeps two (m, width) f32 products at most
    routes = [("plain ops", 64, "cuda"), ("kernels", None, "cuda"),
              ("plain ops, 32-step chunks", 32, "cuda")] + ([("cpu", None, "cpu")] if cpu
                                                            else [])
    res = {"layers": cfg.n_layers, "dtype": cfg.dtype, "settings": E, "product_rel": {},
           "L_rel": {}}
    for name, chunk, dev in routes:
        P = params if dev == "cuda" else T.tmap(lambda x: x.to(dev), params)
        Bt = batch if dev == "cuda" else {n: x.to(dev) for n, x in batch.items()}
        undo = plain_model_ops(torch, ops, ref, chunk) if chunk else None
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            L = autotune.estimate_L(client_grad, P, E["m"], Bt, iters=E["iters"])
            torch.cuda.synchronize()
            probe_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            h = hvp_at(torch, arena, T, client_grad, P, Bt, v.to(dev)).cpu()
            counts = ops.launches()
            peak = torch.cuda.max_memory_allocated()
        finally:
            if undo:
                undo()
        del P, Bt
        torch.cuda.empty_cache()
        # the probe's iters + 1 products and the one at v
        want = {n: 0 for n in counts} | (probe_launches(*layer_kinds(cfg), E["iters"] + 1)
                                         if name == "kernels" else {})
        row = res[name] = {"L": [float(x) for x in L], "seconds": probe_s,
                           "rayleigh": [float(x) for x in torch.einsum("mw,mw->m", v, h)],
                           "peak_allocated_gb": peak / 1e9, "launches_as_derived": counts == want,
                           "launches": {n: c for n, c in counts.items() if c}}
        if name == "plain ops":
            h_ref = h
        else:
            res["product_rel"][name] = [
                float(x) for x in torch.linalg.vector_norm(h - h_ref, dim=-1)
                / torch.linalg.vector_norm(h_ref, dim=-1)]
            res["L_rel"][name] = [abs(x / y - 1.0) for x, y in zip(row["L"],
                                                                    res["plain ops"]["L"])]
        del h
        log(f"full probe witness {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}, "
            f"{E}) through the {name} on {dev}: {row}")
    what_ = f"{cfg.name} {cfg.n_layers} layers {cfg.dtype}"
    floors, failed = WITNESS_FLOORS[cfg.dtype], []
    for what in ("product", "L"):
        rel = res[f"{what}_rel"]
        spread = max(max(r) for n, r in rel.items() if n != "kernels")
        tol = res[f"{what}_tol"] = max(floors[what], SPREAD_FACTOR * spread)
        if held and not max(rel["kernels"]) <= tol:
            failed.append(f"{what_}: the kernels' {what} off the plain ops' by "
                          f"{rel['kernels']}, tol {tol}")
    if not all(res[n]["launches_as_derived"] for n, *_ in routes):
        failed.append(f"{what_}: launches {[res[n]['launches'] for n, *_ in routes]}")
    if not all(math.isfinite(x) for n, *_ in routes for x in res[n]["L"] + res[n]["rayleigh"]):
        failed.append(f"{what_}: not finite")
    res["held"], res["failed"] = held, failed
    log(f"full probe witness {what_}: against the plain ops, products at a random unit vector "
        f"{res['product_rel']} (tol {res['product_tol']:.3e}), L {res['L_rel']} (tol "
        f"{res['L_tol']:.3e}){'' if held else ', recorded, not held'}; failed {failed}")
    del params, batch, v, h_ref
    torch.cuda.empty_cache()
    return res


def reduced_card_vs_cpu(torch, ops, ref, arch, cuts) -> dict:
    """``autotune.estimate_L`` of ``arch``'s reduced config in f32, with
    ``cuts`` applied, at ``ETA_AUTO_CPU``'s settings: the card through the
    kernels against the CPU (``L_CARD_CPU_RTOL``) and against the plain
    ops on the card (``L_PLAIN_RTOL``), the tangent kernels of its layers
    launched, and the first product at the start vector beside it."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import arena, autotune, prng
    from repro_torch.core import tree_util as T
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build

    C = ETA_AUTO_CPU
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **cuts)
    model = build(cfg)
    params = model.init(prng.key(0), device="cpu")
    batch = next(lm_batches(prng.key(3), 1, C["m"], C["per_client_batch"], C["seq_len"],
                            cfg.vocab_size, device="cpu"))

    def grad_of(m_):
        return lambda p, b: torch.func.grad(lambda q: m_.loss(q, b)[0])(p)

    it = C["iters"]
    t0 = time.perf_counter()
    L_cpu = autotune.estimate_L(grad_of(model), params, C["m"], batch, iters=it)
    cpu_s = time.perf_counter() - t0
    gp = T.tmap(lambda x: x.cuda(), params)
    gb = {n: v.cuda() for n, v in batch.items()}
    ops.reset_launches()
    t0 = time.perf_counter()
    L_card = autotune.estimate_L(grad_of(model), gp, C["m"], gb, iters=it)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = {n: c for n, c in ops.launches().items() if c}
    undo = plain_model_ops(torch, ops, ref)
    try:
        L_plain = autotune.estimate_L(grad_of(model), gp, C["m"], gb, iters=it)
    finally:
        undo()
    e_cpu = float(max(abs(L_card / L_cpu - 1.0)))
    e_plain = float(max(abs(L_card / L_plain - 1.0)))
    h_cpu = first_product(torch, autotune, arena, T, grad_of(model), params, C["m"], batch)
    h_card = first_product(torch, autotune, arena, T, grad_of(model), gp, C["m"], gb).cpu()
    first = {"norm_over_L": [float(x) for x in h_cpu.norm(dim=-1) / torch.tensor(L_cpu)],
             "card_vs_cpu": float((h_card - h_cpu).norm() / h_cpu.norm())}
    n_attn, n_rec, n_wkv = layer_kinds(cfg)
    tangents = ((("flash_attention_jvp", "flash_attention_bwd_jvp") if n_attn else ())
                + (("lru_scan_jvp", "lru_scan_bwd_jvp") if n_rec else ())
                + (("wkv6_jvp", "wkv6_bwd_jvp") if n_wkv else ()))
    L_card, L_cpu, L_plain = ([float(x) for x in L_] for L_ in (L_card, L_cpu, L_plain))
    log(f"eta auto card vs cpu {arch} reduced, f32, cuts {cuts}, {it} iterations: L card "
        f"{L_card}, cpu {L_cpu} (rel {e_cpu:.3e}, tol {L_CARD_CPU_RTOL}), plain ops on the "
        f"card {L_plain} (rel {e_plain:.3e}, tol {L_PLAIN_RTOL}); first product at the "
        f"start vector: norm {['%.3e' % x for x in first['norm_over_L']]} of L, card "
        f"against CPU {first['card_vs_cpu']:.3e}; probes {cpu_s:.2f} s on the CPU, "
        f"{card_s:.2f} s on the card; card launches {counts}")
    check(all(counts.get(n, 0) > 0 for n in tangents),
          f"eta auto card vs cpu {arch}: launches {counts}, none of {tangents}")
    check(e_cpu <= L_CARD_CPU_RTOL and e_plain <= L_PLAIN_RTOL,
          f"eta auto card vs cpu {arch}: L off the CPU's by {e_cpu}, the plain ops' by "
          f"{e_plain}")
    result = {"cuts": cuts, "iters": it, "L_card": L_card, "L_cpu": L_cpu,
              "L_plain_card": L_plain, "rel_cpu": e_cpu, "rel_plain": e_plain, "cpu_s": cpu_s,
              "card_s": card_s, "first_product": first}
    del params, gp
    torch.cuda.empty_cache()
    return result


def examples_phase(torch, out):
    """The four library examples and the LM training example on the card,
    each with its own checks (their asserts)."""
    import importlib.util

    res = out["examples"] = {}
    root = Path(__file__).resolve().parent / "examples"
    for name, argv in (("torch_quickstart", []), ("torch_fedsplit_vs_pdmm", []),
                       ("torch_quantized_uplink", []), ("torch_ring_pdmm", []),
                       ("torch_train_federated_lm", ["--steps", str(LM_EXAMPLE_ROUNDS)])):
        spec = importlib.util.spec_from_file_location(name, root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        got = mod.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        res[name] = {"s": time.perf_counter() - t0, "result": got}
        log(f"example {name}: {res[name]['s']:.1f} s, {got}")
    fs = res["torch_fedsplit_vs_pdmm"]["result"]
    check(fs["exact_diff"] < 1e-3, f"fedsplit_vs_pdmm: exact PDMM != FedSplit {fs}")
    lm = res["torch_train_federated_lm"]["result"]
    check(all(math.isfinite(loss) for c in lm.values() for _, loss in c), f"train example {lm}")


def popstore_ckpt_phase(torch, out):
    """The population store at 10^5 x 1,024 saved (its (m, W) buffers
    streamed in chunks) and resumed: the next round equals the
    uninterrupted one bitwise."""
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint import msgpack_ckpt
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import popstore

    P_ = POPSTORE_CKPT
    m, w = P_["m"], P_["width"]
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=P_["K"], eta=P_["eta"], use_arena=True,
                          participation=P_["cohort"] / m, cohort=True, popstore=True,
                          arena_min_width=w)

    def grad(p, b):
        return {k: 0.1 * v for k, v in p.items()}

    batch = {"d": torch.zeros(m, 1, device="cuda")}
    runner = popstore.Runner(cfg, grad, device="cuda")
    s = runner.init({"w": torch.full((w,), 0.5, device="cuda")}, m)
    for _ in range(P_["rounds"]):
        s, _ = runner.round(s, batch)
    d = TRAIN_DIR / "popstore"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    path = ckpt.save(d, P_["rounds"], s)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.load(d, P_["rounds"])
    load_s = time.perf_counter() - t0
    big = s["pop"]["u_hat"].nbytes
    check(big > msgpack_ckpt.CHUNK_BYTES, "popstore ckpt: the store did not stream")
    back["x_s"] = {k: v.to("cuda") for k, v in back["x_s"].items()}
    s, _ = runner.round(s, batch)
    back, _ = popstore.Runner(cfg, grad, device="cuda").round(back, batch)
    for name in popstore.POP_BUFFERS["gpdmm"]:
        check(bool((s["pop"][name] == back["pop"][name]).all()),
              f"popstore ckpt: {name} drifted across the resume")
    check(torch.equal(s["x_s"]["w"], back["x_s"]["w"]), "popstore ckpt: x_s drifted")
    size = Path(path).stat().st_size
    log(f"popstore ckpt ({m}, {w}): saved {size / 1e6:.0f} MB in {save_s:.2f} s, loaded in "
        f"{load_s:.2f} s; the next round bitwise the uninterrupted one")
    out["popstore_ckpt"] = {"bytes": size, "save_s": save_s, "load_s": load_s}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="after each algorithm's rounds, profile 3 more: kernel times "
                         "by name and the device's idle share")
    ap.add_argument("--full-probe", action="store_true",
                    help="run only rwkv6-1.6b's --eta auto curvature probe at full width and "
                         "depth and the witnesses of its L (FULL_PROBE), after the build; "
                         "prints their JSON line and no result line")
    args = ap.parse_args()

    # the serve phase's models of many sizes, then training at 68 GB of the
    # card's 79 GiB: segments that grow in place keep freed blocks usable
    # across phases (with fixed segments training once ran out of memory
    # with 10.8 GiB reserved but unallocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import FaultConfig, FederatedConfig
    from repro_torch.core import make, make_oracle, quadratic
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

    rec = Record(ops, _build.build_logs())
    if args.full_probe:
        full_probe_phase(torch, ops, ref, out)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        log(json.dumps(out["full_probe"]))
        return 0
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
    timed("3 server step", check_server_step, rec, torch, ops, ref, seeded(torch, 61), out)
    timed("3 step kernel", check_step_kernel, rec, torch, ops, ref, seeded(torch, 47), out)
    timed("3 cohort kernels", check_cohort_kernels, rec, torch, ops, ref, seeded(torch, 13), out)
    timed("3 fault kernels", check_fault_kernels, rec, torch, ops, ref, seeded(torch, 17), out)
    timed("3 screen keep", check_screen_keep, rec, torch, ops, ref, seeded(torch, 67), out)
    timed("3 scaffold step", check_scaffold_step, rec, torch, ops, ref, seeded(torch, 71), out)
    timed("3 card vs cpu", check_small_against_cpu, torch, make, FederatedConfig, quadratic)

    dev = torch.device("cuda")
    prof = None
    if args.profile:
        def prof(label, run, round_ms, rounds):
            profile_rounds(torch, label, run, round_ms, rounds, out)
    timed("4 lsq", lsq_phase, rec, prob, torch, ops, make, FederatedConfig, dev, prof)
    timed("5 softmax", softmax_phase, rec, torch, ops, make, FederatedConfig, SoftmaxRegression,
          dev, SOFTMAX_RUNS, prof)

    t0 = time.perf_counter()
    prob25 = quadratic.generate(seeded(torch, 0), m=FIG1["m"], n=FIG1["n"], d=LSQ["d"],
                                device="cuda")
    torch.cuda.synchronize()
    log(f"least squares m={FIG1['m']} n={FIG1['n']} d={LSQ['d']}: set-up "
        f"{time.perf_counter() - t0:.2f} s; L {prob25.L:.4e} mu {prob25.mu:.4e}")
    timed("6 fig2", fig2_phase, rec, {LSQ["m"]: prob, FIG1["m"]: prob25}, torch, ops, make,
          FederatedConfig, dev, prof)
    timed("6 lm_tree", lm_tree_phase, rec, torch, ops, make, FederatedConfig, seeded(torch, 43),
          dev, out, prof)
    timed("7 fig1", fig1_phase, rec, prob25, torch, ops, make, FederatedConfig, dev)
    timed("7 theory", theory_phase, rec, prob, torch, ops, make, FederatedConfig, quadratic,
          dev, out)
    timed("8 participation", participation_phase, rec, prob, torch, ops, make, FederatedConfig,
          dev, out, prof)
    timed("8 softmax", softmax_phase, rec, torch, ops, make, FederatedConfig, SoftmaxRegression,
          dev, SOFTMAX_PARTIAL, prof)
    timed("8 population", population_phase, rec, torch, ops, make, make_oracle,
          FederatedConfig, dev, out)
    timed("8 popstore", popstore_phase, rec, prob, torch, ops, ref, make, make_oracle,
          FederatedConfig, FaultConfig, dev, out)
    timed("9 faults", faults_phase, rec, prob, torch, ops, make, FederatedConfig, FaultConfig,
          quadratic, seeded(torch, 21), dev, out, prof)
    timed("10 residual kernel", check_residual_kernel, rec, torch, ops, ref, seeded(torch, 23),
          out)
    timed("10 graph kernels", check_graph_kernels, rec, torch, ops, ref, seeded(torch, 29), out)
    timed("10 graph rounds", graph_phase, rec, prob, torch, ops, make, FederatedConfig,
          quadratic, seeded(torch, 31), dev, out, prof)
    timed("10 autotune", autotune_phase, rec, prob, torch, ops, make, FederatedConfig,
          quadratic, seeded(torch, 37), dev, out)
    timed("11 model kernels", check_model_kernels, rec, torch, ops, ref, seeded(torch, 41), out)
    timed("11 serve", serve_phase, rec, torch, ops, dev, out)
    timed("11 card vs cpu", serve_against_cpu, torch, out)
    timed("12 backward kernels", check_backward_kernels, rec, torch, ops, ref, seeded(torch, 73),
          out)
    timed("12 train", train_phase, rec, torch, ops, out)
    timed("12 wide arena", check_wide_arena, torch, ops, ref, seeded(torch, 79), out)
    timed("12 train rwkv", train_rwkv_phase, rec, torch, ops, out)
    timed("12 train archs", train_archs_phase, rec, torch, ops, out)
    timed("12 train card vs cpu", train_against_cpu, torch, ops, out)
    timed("12 jvp kernels", check_jvp_kernels, rec, torch, ops, ref, seeded(torch, 89), out)
    timed("12 eta auto", eta_auto_phase, rec, torch, ops, ref, out)
    timed("12 examples", examples_phase, torch, out)
    timed("12 popstore ckpt", popstore_ckpt_phase, torch, out)

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
