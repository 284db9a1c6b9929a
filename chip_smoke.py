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
     per round are as derived from the code (a cohort round launches one
     gather and one scatter); then softmax at the Table I size with
     participation 0.5 and 8-bit EF21 (GPDMM, FedAvg), whose loss must
     fall; then the GPDMM cohort round at the reference's population sweep
     (``POPULATION``: m = 10^5 and 10^6 clients, W = 1,024, a cohort of
     64, K = 4, the 0.3 x arena gradient), functional (``fed.round``) and
     donated (``fed.round_``), each alone on the card: ms a round, host
     ops, launches, device-busy ms and the peak allocation; three donated
     rounds bitwise three functional ones, whose input stays as it was;
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
     the route its dtype and head dim select, timed beside
     ``scaled_dot_product_attention``; ``wkv6`` at rwkv6-1.6b's
     (4, 1024, 32, 64) bf16 with a nonzero initial state, at a ragged
     length with near-zero decay, and at lengths 1, 63, 65 and 100 with a
     zero and a nonzero initial state; (b) ``repro_torch.launch.serve.run`` at
     full width for olmo-1b and rwkv6-1.6b, batch 4, prompt 1024, 32 new
     tokens: prefill and decode times, 16 ``flash_attention`` launches per
     olmo prefill and 24 ``wkv6`` per rwkv prefill, none per decode token,
     finite logits, the last decode step's logits against a prefill of the
     extended prompt (and the same in f32 at full width with 4 layers), and
     a profile of one prefill and 8 decode steps (busy time, idle share,
     kernel time by name), and olmo-1b's flash on the tensor-core route;
     (c) each model at full width
     with 2 layers on the card against the CPU (prefill of a 256-token
     prompt and one decode step);
 12. print one JSON line of per-kernel numbers (with each source's
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
import json
import math
import re
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
               flop_per_s=F32_FLOP_PER_S, plain_iters=None, plain_spin=400_000):
        """Time ``fn`` (the kernel), ``plain_fn`` and, where one PyTorch call
        computes the same function, ``library_fn`` on the device, and the
        kernel once more as the host enqueues it (``enqueue_ms``).  The bound
        takes ``flops`` at ``flop_per_s`` (f32 outside the tensor cores by
        default).  A plain version of many ops takes ``plain_iters`` calls
        behind a spin of ``plain_spin`` cycles a call, so that the host has
        enqueued them all before the device reaches them."""
        ms = cuda_time_ms(fn, iters)
        plain_ms = cuda_time_ms(plain_fn, plain_iters or iters, spin_cycles=plain_spin)
        library_ms = None if library_fn is None else cuda_time_ms(library_fn, iters)
        enqueue_ms = cuda_time_ms(fn, iters, prefill=False)
        b, by = bound_ms(nbytes, flops, flop_per_s)
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
SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
SERVE_ARCHS = ("olmo-1b", "rwkv6-1.6b")
# per prefill, one kernel per block of the model (16 dense, 24 rwkv), none per
# decode token
SERVE_LAUNCHES = {"olmo-1b": {"flash_attention": 16}, "rwkv6-1.6b": {"wkv6": 24}}
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
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores


def rel_err(torch, got, want) -> float:
    want = want.float()
    return max_err(got, want) / max(float(want.abs().max()), 1e-30)


def flash_flops(B, H, Sq, Sk, hd, window=None) -> float:
    """Multiply-adds of q k^T and p v over the valid (query, key) pairs."""
    pairs = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)
        pairs += i + 1 - lo
    return 4.0 * B * H * hd * pairs


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
    torch.cuda.synchronize()


def serve_phase(rec, torch, ops, dev, out):
    """``serve.run`` at full width, each model twice (the first run warms
    the card's libraries and its allocator), the launches of the second
    read; then the last decode step's logits against a prefill of the
    extended prompt, in bf16 and, at 4 layers, in f32."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.launch import serve

    res = out["serve"] = {}
    for arch in SERVE_ARCHS:
        serve.run(arch, reduced=False, device="cuda", quiet=True, **SERVE)
        torch.cuda.synchronize()
        ops.reset_launches()
        _fa.last_route = None
        got = serve.run(arch, reduced=False, device="cuda", **SERVE)
        torch.cuda.synchronize()
        counts = ops.launches()
        rec.add(counts)
        want = {n: 0 for n in counts} | SERVE_LAUNCHES[arch]
        check(counts == want, f"serve {arch}: launches {counts}, expected {want}")
        if counts["flash_attention"]:  # olmo-1b's bf16 prefill: the tensor-core route
            check(_fa.last_route == "wgmma",
                  f"serve {arch}: flash_attention took the {_fa.last_route} route, not wgmma")
        check(bool(torch.isfinite(got.logits).all()), f"serve {arch}: logits not finite")
        check(tuple(got.tokens.shape) == (SERVE["batch"], SERVE["new_tokens"]),
              f"serve {arch}: tokens {tuple(got.tokens.shape)}")
        with torch.no_grad():
            ext = torch.cat([got.prompts, got.tokens], dim=1)
            full, _ = got.model.prefill(got.params, {"tokens": ext}, ext.shape[1])
        e = rel_err(torch, got.logits, full)
        log(f"serve {arch}: prefill {got.prefill_ms:.2f} ms, decode {got.decode_ms_per_token:.3f} "
            f"ms/token; launches {dict((n, c) for n, c in counts.items() if c)}; last decode "
            f"logits vs prefill of the {ext.shape[1]}-token prompt: rel error {e:.3e}")
        check(e <= LOGITS_REL, f"serve {arch}: decode vs prefill rel error {e} > {LOGITS_REL}")
        res[arch] = {"prefill_ms": got.prefill_ms, "decode_ms_per_token": got.decode_ms_per_token,
                     "launches": {n: c for n, c in counts.items() if c},
                     "decode_vs_prefill_rel": e}
        res[arch] |= profile_serve(torch, got, arch)
        del got, full
        torch.cuda.empty_cache()
        res[arch]["decode_vs_prefill_f32_rel"] = decode_against_prefill_f32(torch, arch)


def decode_against_prefill_f32(torch, arch) -> float:
    """Full width, 4 layers, f32: 4 greedy decode steps after a 256-token
    prompt against a prefill of the extended prompt."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import build

    model = build(dataclasses.replace(get_arch(arch), n_layers=4, dtype="float32"))
    with torch.no_grad():
        params = model.init(seeded(torch, 53))
        prompts = torch.randint(0, model.cfg.vocab_size, (2, 256), generator=seeded(torch, 59),
                                device="cuda")
        tokens, logits, _, _ = serve.generate(model, params, prompts, 4, 260)
        ext = torch.cat([prompts, tokens], dim=1)
        full, _ = model.prefill(params, {"tokens": ext}, ext.shape[1])
    e = rel_err(torch, logits, full)
    log(f"serve {arch} f32, full width, 4 layers: last decode logits vs prefill of the "
        f"260-token prompt: rel error {e:.3e}")
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

    model, params, prompts = got.model, got.params, got.prompts
    cap = prompts.shape[1] + 8
    result = {}

    def prefill():
        return model.prefill(params, {"tokens": prompts}, cap)

    with torch.no_grad():
        _, cache = prefill()
        nxt = got.tokens[:, :1]

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
    for arch in SERVE_ARCHS:
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


def device_profile(torch, run, rounds):
    """torch.profiler over ``run`` (``rounds`` rounds): device-busy ms and
    device activities (kernels, copies, fills) per round, and the profile's
    key averages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
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
          seeded(torch, 0), dev, SOFTMAX_RUNS, prof)

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
    timed("8 participation", participation_phase, rec, prob, torch, ops, make, FederatedConfig,
          dev, out, prof)
    timed("8 softmax", softmax_phase, rec, torch, ops, make, FederatedConfig, SoftmaxRegression,
          seeded(torch, 0), dev, SOFTMAX_PARTIAL, prof)
    timed("8 population", population_phase, rec, torch, ops, make, make_oracle,
          FederatedConfig, dev, out)
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
