#!/usr/bin/env python3
"""Times the port against another tree of it (e.g. its parent commit) on one
NVIDIA card, both in one process.

    git archive <sha> | tar -x -C chip_archive/parent   # chip_archive/ is gitignored
    python3 chip_ab.py chip_archive/parent [--pairs 10] [--out results.json]

The host's clock level differs up to 2x from one process to the next, so
round times of two trees taken in two processes cannot be compared.  Here
both trees' ``src/repro_torch`` are imported into one process (each keeps
its own modules and its own kernel libraries, built from its own sources)
and timed alternately, other then this, this then other, ``--pairs``
times; every number is a median over the pairs.  Measured, for each tree:

  * the step kernel as the host enqueues it (the stream not pre-filled):
    one ``fused_update`` on Fig. 2's leaf (500 x 500, the server leaf
    broadcast, lam) and one ``fused_update_arena`` on the softmax arena
    (10 x 7,936), the calls the one-leaf and arena rounds make;
  * the step at lm_flat and lm_tree on the device (the stream pre-filled):
    the step kernel then the plain add per leaf (``chip_smoke.step_pair``),
    and, where the tree has it, one launch with the sum in its pass;
  * ms per round, launches per round, the tensor ops the host dispatches a
    round (allocations aside) and the device-busy ms a round
    (``torch.profiler``) for the softmax arena (Table I), Fig. 2's pytree
    round (m = 500, K = 5), Fig. 2's full arena round (``use_arena=True``,
    the affine kernel), Fig. 2's GPDMM cohort round at participation 0.1
    (the arena, 50 of 500 clients), the EF21 rounds (8 bits) of Fig. 2's
    full arena round and cohort round and of softmax at p = 0.5, the
    screened rounds of chip_smoke phase 9 (Fig. 2's full arena and cohort
    at p = 0.1), SCAFFOLD's Fig. 2 and softmax arena rounds (full, p = 0.5
    masked, and Fig. 2's cohort at p = 0.5),
    lm_tree's four algorithms, GPDMM's full arena round at lm_flat and the
    ring(8) graph there; for GPDMM, whether a plain op wrote x_bar
    (``--cells`` picks cells by label);
  * ``ops.ef21_update`` at ``chip_smoke.EF21_TIMED`` on the device and as
    the host enqueues it (``ef21``);
  * the screen from the uplink to the keep mask (``faults.screen_keep``) at
    ``chip_smoke.KEEP_SHAPES`` (``screen``) and SCAFFOLD's full-arena tail
    (``ops.scaffold_step``, or the parent's ``scaffold_cv`` and plain ops)
    at the Fig. 2 arena, the softmax arena and lm_flat (``scaffold``), on
    the device and as the host enqueues them, with host ops a call;
  * the server step's column walks (``round_tail_mean``, ``round_tail``,
    ``client_mean``, ``server_dual``), f32 and bf16, at ``WALK_SHAPES`` on
    the device (``server_walks``).

And for this tree alone, the step kernel's two parameter tables (8
segments, and the most the parameter limit holds): the launch with the
large table is built from a copy of ``csrc/fused_update.cu`` that always
takes it, and both are timed on the device and as the host enqueues them
at Fig. 2's leaf, the softmax arena and lm_tree.

Then a GPDMM cohort round's row movement at Fig. 2's p = 0.1 as the host
enqueues it (``cohort_rows``); last, the GPDMM cohort round at the
reference's population sweep (m = 10^5 and 10^6 clients, W = 1,024, a
cohort of 64; ``population``): functional and donated (``fed.round_``)
in both trees, each alone on the card (round ms, host ops, launches,
device-busy ms and the peak allocation), then the four alternated.  ``--only`` picks sections.

Imports no JAX and nothing of the JAX package; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pkgutil
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import chip_smoke as S

HERE = Path(__file__).resolve().parent


def load_tree(root: Path) -> dict:
    """Every module of ``root/src/repro_torch``, imported and then taken out
    of ``sys.modules`` (``use`` puts them back)."""
    src = str((root / "src").resolve())
    sys.path.insert(0, src)
    try:
        pkg = importlib.import_module("repro_torch")
        for info in pkgutil.walk_packages(pkg.__path__, "repro_torch."):
            importlib.import_module(info.name)
    finally:
        sys.path.remove(src)
    return {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == "repro_torch" or k.startswith("repro_torch.")}


def use(tree: dict) -> SimpleNamespace:
    """Make ``tree``'s modules the ones imports resolve to (the port imports
    some lazily) and return its entry points."""
    for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[k]
    sys.modules.update(tree)
    core = tree["repro_torch.core"]
    return SimpleNamespace(
        ops=tree["repro_torch.kernels.ops"], make=core.make, make_oracle=core.make_oracle,
        quadratic=core.quadratic, FederatedConfig=tree["repro_torch.configs.base"].FederatedConfig,
        FaultConfig=tree["repro_torch.configs.base"].FaultConfig,
        faults=tree["repro_torch.core.faults"], ref=tree["repro_torch.kernels.ref"],
        SoftmaxRegression=tree["repro_torch.core.softmax"].SoftmaxRegression,
        gpdmm=tree["repro_torch.core.gpdmm"], pdmm_graph=tree["repro_torch.core.pdmm_graph"],
        build=tree["repro_torch.kernels._build"], fu=tree["repro_torch.kernels.fused_update"])


def alternate(trees, pairs: int, measure) -> dict:
    """``measure(label, tree)`` for each tree in the order other, this, this,
    other, ... (``pairs`` times each); the median of each tree's values."""
    got = {label: [] for label in trees}
    labels = list(trees)
    for p in range(pairs):
        for label in (labels if p % 2 == 0 else labels[::-1]):
            got[label].append(measure(label, use(trees[label])))
    return {label: {"median": statistics.median(v), "all": v} for label, v in got.items()}


def host_step(torch, trees, pairs, out):
    """One step call as the host enqueues it, ms a call over 200 calls."""
    gen = S.seeded(torch, 53)
    dev = gen.device
    x, g, lam = (torch.randn(500, 500, generator=gen, device=dev) for _ in range(3))
    xa, ga, la = (torch.randn(10, 7936, generator=gen, device=dev) for _ in range(3))
    calls = {"fig2_leaf": lambda t: t.ops.fused_update(x, g, x[0], lam, 0.05, 2.5),
             "softmax_arena": lambda t: t.ops.fused_update_arena(xa, ga, xa[0], la, 0.05, 4.0)}
    for name, call in calls.items():
        res = alternate(trees, pairs, lambda label, t: S.cuda_time_ms(
            lambda: call(t), 200, prefill=False))
        out[f"host_{name}_ms"] = res
        S.log(f"host-paced step, {name}: " + ", ".join(
            f"{k} {v['median']:.5f} ms" for k, v in res.items()))


def device_step(torch, trees, pairs, out):
    """The step at lm_flat and lm_tree on the device: the pair (step kernel,
    then the plain add per leaf) in each tree, one launch with the sum in
    this tree."""
    case = S.step_cases(torch, S.seeded(torch, 53))
    for name, c in case.items():
        arena = name == "lm_flat"
        res = alternate(trees, pairs, lambda label, t: S.cuda_time_ms(
            lambda: S.step_pair(t.ops, c, 0.05, 2.5, arena), 20))
        fused = alternate({"this": trees["this"]}, pairs, lambda label, t: S.cuda_time_ms(
            lambda: S.step_fused(t.ops, c, 0.05, 2.5, arena), 20))["this"]
        out[f"step_{name}"] = {"pair_ms": res, "fused_ms": fused,
                               "bound_ms": S.bound_ms(S.step_bytes(c), 0)[0]}
        S.log(f"step at {name}: pair " + ", ".join(
            f"{k} {v['median']:.5f} ms" for k, v in res.items())
            + f"; fused (this) {fused['median']:.5f} ms")


def large_table_fn(t):
    """The step launcher of a copy of ``csrc/fused_update.cu`` that takes
    the large table for every launch, built beside the tree's libraries."""
    b = t.build
    text = (b.CSRC / t.fu.SOURCE).read_text()
    assert text.count("if (nseg <= kSmallSegs)") == 1
    var = b.BUILD_DIR / "eq20_large_table"
    var.mkdir(parents=True, exist_ok=True)
    (var / "fused_update.cu").write_text(text.replace("if (nseg <= kSmallSegs)", "if (false)"))
    so = var / "fused_update.so"
    subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o", str(so),
                    str(var / "fused_update.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).launch_eq20_segments
    fn.argtypes = t.fu.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def tables(torch, trees, pairs, out):
    """The step kernel with the 8-segment table against the large one."""
    t = use(trees["this"])
    gen = S.seeded(torch, 54)
    dev = gen.device
    x, g, lam, acc = (torch.randn(500, 500, generator=gen, device=dev) for _ in range(4))
    xa, ga, la, aa = (torch.randn(10, 7936, generator=gen, device=dev) for _ in range(4))
    tree = S.step_cases(torch, gen)["lm_tree"]
    calls = {"fig2_leaf": lambda: t.ops.fused_update_leaves([x], [g], [x[0]], [lam], 0.05, 2.5,
                                                            accs=[acc]),
             "softmax_arena": lambda: t.ops.fused_update_arena(xa, ga, xa[0], la, 0.05, 4.0,
                                                               acc=aa),
             "lm_tree": lambda: S.step_fused(t.ops, tree, 0.05, 2.5, False)}
    for call in calls.values():
        call()  # binds the kernels' launchers
    kerns = (t.fu.KERNEL, t.fu.ARENA_KERNEL)
    small, large = kerns[0]._fn, large_table_fn(t)

    def pick(fn):
        for k in kerns:
            k._fn = fn

    try:
        for name, call in calls.items():
            for prefill in (True, False):
                got = {"small": [], "large": []}
                for p in range(pairs):
                    for label in (("small", "large") if p % 2 == 0 else ("large", "small")):
                        pick(small if label == "small" else large)
                        got[label].append(S.cuda_time_ms(call, 20 if prefill else 200,
                                                         prefill=prefill))
                key = f"table_{name}_{'device' if prefill else 'host_paced'}_ms"
                out[key] = {k: statistics.median(v) for k, v in got.items()}
                S.log(f"tables, {key}: {out[key]}")
    finally:
        pick(small)


def rounds(torch, trees, pairs, out, cell_filter=None):
    """Round times, launches, host ops and device-busy time a round, for
    the cells whose label ``cell_filter`` (a regex) finds, or all."""
    sm_cfg, lsq, lt, lf = S.SOFTMAX, S.LSQ, S.LM_TREE, S.LM_FLAT
    cells = []  # (label, algorithm config, set-up per tree, rounds a chunk, per_step, inner)

    def softmax(t):
        F, C, n, B, K = (sm_cfg[k] for k in ("F", "C", "n", "B", "K"))
        sm = t.SoftmaxRegression(F, C)
        xs, ys = S.mixture_data(torch, S.seeded(torch, 0), F, C, n, "cuda")

        def batch(r):
            starts = [((r * K + k) * B) % (n - B + 1) for k in range(K)]
            return {"x": torch.stack([xs[:, s:s + B] for s in starts]),
                    "y": torch.stack([ys[:, s:s + B] for s in starts])}
        return sm.init_params("cuda"), sm_cfg["m"], sm.oracle(), batch, {}

    def fig2(t, arena=False):
        prob = t.quadratic.generate(S.seeded(torch, 0), m=lsq["m"], n=lsq["n"], d=lsq["d"],
                                    device="cuda")
        return (torch.zeros(prob.d, device="cuda"), lsq["m"],
                prob.oracle() if arena else prob.grad, lambda r: prob.batch(),
                {"eta": 0.5 / prob.L})

    def lm_tree(t):
        gen = S.seeded(torch, 55)
        params = {k: torch.randn(s, generator=gen, device="cuda")
                  for k, s in lt["shapes"].items()}
        tb = {"d": torch.zeros(lt["m"], 1, device="cuda")}
        return (params, lt["m"], lambda p, b: {k: 0.3 * v for k, v in p.items()}, lambda r: tb,
                {})

    def ring(t):
        gen = S.seeded(torch, 56)
        grad = t.make_oracle(lambda p, b: {k: 0.3 * v for k, v in p.items()},
                             grad_arena=lambda spec: (lambda xa, b: 0.3 * xa))
        fb = {"dummy": torch.zeros(lf["m"], 1, device="cuda")}
        return ({"w": torch.randn(lf["width"], generator=gen, device="cuda")}, lf["m"], grad,
                lambda r: fb, {})

    for algo in ("gpdmm", "agpdmm"):
        cells.append((f"softmax_{algo}", dict(algorithm=algo, inner_steps=sm_cfg["K"], eta=0.05),
                      softmax, sm_cfg["rounds"], True, "arena"))
    for algo in ("gpdmm", "agpdmm"):
        cells.append((f"fig2_m500_K5_{algo}", dict(algorithm=algo, inner_steps=lsq["K"]),
                      fig2, 20, False, "tree"))
    for algo in ("gpdmm", "agpdmm"):  # the full arena round: its tail's two passes
        cells.append((f"fig2_arena_{algo}", dict(algorithm=algo, inner_steps=lsq["K"],
                                                 use_arena=True),
                      lambda t: fig2(t, arena=True), 20, False, "arena"))
    cells.append(("fig2_p10_cohort_gpdmm", dict(algorithm="gpdmm", inner_steps=lsq["K"],
                                                use_arena=True, participation=0.1),
                  lambda t: fig2(t, arena=True), 20, False, "arena"))
    # the EF21 rounds of chip_smoke phase 8: (c) full participation and (b)
    # the cohort at p = 0.1 on Fig. 2's arena, softmax at p = 0.5
    cells.append(("c_gpdmm", dict(algorithm="gpdmm", inner_steps=lsq["K"], use_arena=True,
                                  uplink_bits=8), lambda t: fig2(t, arena=True), 20, False,
                  "arena"))
    cells.append(("b_gpdmm", dict(algorithm="gpdmm", inner_steps=lsq["K"], use_arena=True,
                                  participation=0.1, uplink_bits=8),
                  lambda t: fig2(t, arena=True), 20, False, "arena"))
    cells.append(("softmax_gpdmm_p50_ef21", dict(algorithm="gpdmm", inner_steps=sm_cfg["K"],
                                                 eta=0.05, participation=0.5, uplink_bits=8),
                  softmax, sm_cfg["rounds"], True, "arena"))
    # the screened rounds of chip_smoke phase 9 (the screen with its keep
    # rule in one launch): Fig. 2's faulted full arena round and its cohort
    # round at p = 0.1
    cells.append(("fig2_arena_gpdmm_screened", dict(algorithm="gpdmm", inner_steps=lsq["K"],
                                                    use_arena=True, **S.SCREENED),
                  lambda t: fig2(t, arena=True), 20, False, "arena"))
    cells.append(("fig2_p10_cohort_gpdmm_screened",
                  dict(algorithm="gpdmm", inner_steps=lsq["K"], use_arena=True,
                       participation=0.1, **S.SCREENED),
                  lambda t: fig2(t, arena=True), 20, False, "arena"))
    # SCAFFOLD's full-arena rounds (its server step): Fig. 2's arena and the
    # softmax arena, full and at p = 0.5 on the masked round; the cohort
    # round at p = 0.5 keeps scaffold_cv (out of the step's scope)
    for label, extra_kw in (("", {}), ("_p50_masked", dict(participation=0.5, cohort=False)),
                            ("_p50_cohort", dict(participation=0.5))):
        cells.append((f"fig2_arena_scaffold{label}",
                      dict(algorithm="scaffold", inner_steps=lsq["K"], use_arena=True,
                           **extra_kw), lambda t: fig2(t, arena=True), 20, False, "arena"))
    for label, extra_kw in (("", {}), ("_p50_masked", dict(participation=0.5, cohort=False))):
        cells.append((f"softmax_scaffold{label}", dict(algorithm="scaffold",
                                                       inner_steps=sm_cfg["K"], eta=0.05,
                                                       **extra_kw),
                      softmax, sm_cfg["rounds"], True, "arena"))
    for algo in ("gpdmm", "agpdmm", "scaffold", "fedavg"):
        cells.append((f"lm_tree_{algo}", dict(algorithm=algo, inner_steps=lt["K"], eta=lt["eta"],
                                              use_arena=False), lm_tree, lt["rounds"], False,
                      "tree"))
    cells.append(("lm_flat_gpdmm", dict(algorithm="gpdmm", inner_steps=lf["K"], eta=lf["eta"],
                                        use_arena=True), ring, lf["rounds"], False, "arena"))
    cells.append(("graph_lm_flat_ring", dict(algorithm="gpdmm_graph", topology="ring",
                                             inner_steps=lf["K"], eta=lf["eta"]), ring,
                  lf["rounds"], False, "graph"))

    for label, kw, setup, R, per_step, inner in cells:
        if cell_filter and not re.search(cell_filter, label):
            continue
        runs = {}
        for tl, tree in trees.items():
            t = use(tree)
            params, m, grad, batch_of, extra = setup(t)
            fk = kw.get("faults")
            opt = t.make(t.FederatedConfig(**(kw | ({} if fk is None else
                                                    {"faults": t.FaultConfig(**fk)})), **extra))
            state = opt.init(params, m)
            state, _, _, _ = S.run_rounds(torch, t.ops, opt, state, grad, batch_of, 2, per_step)
            runs[tl] = dict(opt=opt, state=state, grad=grad, batch_of=batch_of)

        def chunk(tl, t):
            r = runs[tl]
            r["state"], _, counts, secs = S.run_rounds(torch, t.ops, r["opt"], r["state"],
                                                       r["grad"], r["batch_of"], R, per_step)
            r["launches"] = {k: v / R for k, v in counts.items() if v}
            return 1e3 * secs / R

        res = alternate(trees, pairs, chunk)
        for tl in trees:
            t = use(trees[tl])
            opt, state, grad, batch_of = (runs[tl][k] for k in ("opt", "state", "grad",
                                                                "batch_of"))
            one = lambda: opt.round(state, grad, batch_of(0), per_step)  # noqa: E731
            busy, activities, _ = S.device_profile(
                torch, lambda: S.run_rounds(torch, t.ops, opt, state, grad, batch_of, 3,
                                            per_step), 3)
            row = res[tl]
            row.update(launches_per_round=runs[tl]["launches"],
                       host_ops_per_round=S.round_ops(torch, one),
                       device_busy_ms_per_round=busy, device_activities_per_round=activities)
            if kw["algorithm"] in ("gpdmm", "gpdmm_graph"):
                module, name = ((t.pdmm_graph, "inner_steps_graph") if inner == "graph" else
                                (t.gpdmm, "inner_steps" if inner == "tree" else
                                 "inner_steps_arena"))
                row["x_bar_plain"] = S.x_bar_plain(torch, module, name, one)
        out[label] = res
        S.log(f"rounds {label}: " + "; ".join(
            f"{tl} {r['median']:.4f} ms/round, host ops {r['host_ops_per_round']}, busy "
            f"{r['device_busy_ms_per_round']:.4f} ms, x_bar_plain {r.get('x_bar_plain')}"
            for tl, r in res.items()))


def ef21(torch, trees, pairs, out):
    """``ops.ef21_update`` in each tree at ``chip_smoke.EF21_TIMED`` (the
    least-squares arena, the softmax arena, ``lm_flat``; f32, 8 bits), on
    the device (the stream pre-filled) and as the host enqueues it."""
    gen = S.seeded(torch, 58)
    for label, (m, w, leaf_rows) in S.EF21_TIMED.items():
        uh = torch.randn(m, w, generator=gen, device="cuda")
        u = uh + 0.1 * torch.randn(m, w, generator=gen, device="cuda")
        for prefill in (True, False):
            # on the device 50 calls: the parent's ~9 launches a call stay
            # within the stream's queue of pending launches
            iters = (50 if prefill else 200) if m * w < 1 << 22 else 40
            res = alternate(trees, pairs, lambda tl, t: S.cuda_time_ms(
                lambda: t.ops.ef21_update(u, uh, 8, leaf_rows), iters, prefill=prefill))
            key = f"ef21_{label}_{'device' if prefill else 'host_paced'}_ms"
            out[key] = res
            S.log(f"ef21_update {label} ({m}, {w}) {leaf_rows}, "
                  f"{'device' if prefill else 'host-paced'}: " + ", ".join(
                      f"{k} {v['median']:.5f} ms" for k, v in res.items()))
        del u, uh


def cohort_rows(torch, trees, pairs, out):
    """A GPDMM cohort round's row movement at Fig. 2's p = 0.1 (50 of 500
    rows of W = 512, f32, int64 ids) as the host enqueues it, ms a round
    over 200: lam and x_c gathered, u_hat and x_c scattered back -- two
    gathers and two scatters (a new buffer each) where the tree has only
    the one-buffer calls, else one gather and one scatter, functional
    (copies) and in place."""
    gen = S.seeded(torch, 57)
    m, w, mc = 500, 512, 50
    lam, x_c, u_hat = (torch.randn(m, w, generator=gen, device="cuda") for _ in range(3))
    up, xk = (torch.randn(mc, w, generator=gen, device="cuda") for _ in range(2))
    idx = torch.sort(torch.randperm(m, generator=gen, device="cuda")[:mc]).values

    def calls(t):
        o = t.ops
        if not hasattr(o, "row_gather_buffers"):
            return {"functional": lambda: (o.row_gather(lam, idx), o.row_gather(x_c, idx),
                                           o.row_scatter(u_hat, idx, up),
                                           o.row_scatter(x_c, idx, xk))}
        return {"functional": lambda: (o.row_gather_buffers((lam, x_c), idx),
                                       o.row_scatter_buffers((u_hat, x_c), idx, (up, xk))),
                "donated": lambda: (o.row_gather_buffers((lam, x_c), idx),
                                    o.row_scatter_buffers_((u_hat, x_c), idx, (up, xk)))}

    for mode in ("functional", "donated"):
        have = {k: v for k, v in trees.items() if mode in calls(use(v))}
        res = alternate(have, pairs, lambda label, t: S.cuda_time_ms(calls(t)[mode], 200,
                                                                     prefill=False))
        out[f"cohort_rows_{mode}_host_paced_ms"] = res
        S.log(f"cohort rows {mode}, host-paced: " + ", ".join(
            f"{k} {v['median']:.5f} ms" for k, v in res.items()))


def population(torch, trees, pairs, out):
    """The GPDMM cohort round at the reference's population sweep
    (``chip_smoke.POPULATION``: m = 10^5 and 10^6, W = 1,024, cohort 64),
    functional and donated (``fed.round_``) in each tree.
    First each cell alone on the card (``chip_smoke.population_run``: round
    ms, host ops, launches, device busy, peak allocation); then the round
    times of the three cells alternated, ``pairs`` times, every state held
    at once (a chunk of ``POPULATION["rounds"]`` rounds each turn)."""
    R = S.POPULATION["rounds"]
    for m in S.POPULATION["ms"]:
        cells = [("other", "functional"), ("this", "functional"), ("other", "donated"),
                 ("this", "donated")]
        alone = {}
        for tl, mode in cells:
            t = use(trees[tl])
            opt, params, grad, batch = S.population_setup(torch, t.make, t.make_oracle,
                                                          t.FederatedConfig, m, "cuda")
            alone[f"{tl}_{mode}"], _ = S.population_run(torch, t.ops, opt, params, grad, batch,
                                                        m, mode == "donated", R)
            S.log(f"population m={m} {tl} {mode} alone: "
                  f"{ {k: v for k, v in alone[f'{tl}_{mode}'].items() if k != 'profile'} }")
            S.log(alone[f"{tl}_{mode}"]["profile"])
        runs = {}
        for tl, mode in cells:
            t = use(trees[tl])
            opt, params, grad, batch = S.population_setup(torch, t.make, t.make_oracle,
                                                          t.FederatedConfig, m, "cuda")
            step = opt.round_ if mode == "donated" else opt.round
            runs[(tl, mode)] = dict(step=step, state=step(opt.init(params, m), grad, batch)[0],
                                    grad=grad, batch=batch, ms=[])
        for p in range(pairs):
            for key in (cells if p % 2 == 0 else cells[::-1]):
                use(trees[key[0]])
                r = runs[key]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(R):
                    r["state"], _ = r["step"](r["state"], r["grad"], r["batch"])
                torch.cuda.synchronize()
                r["ms"].append(1e3 * (time.perf_counter() - t0) / R)
        res = {}
        for (tl, mode), r in runs.items():
            res[f"{tl}_{mode}"] = alone[f"{tl}_{mode}"] | {
                "alternated_round_ms": {"median": statistics.median(r["ms"]), "all": r["ms"]}}
        del runs
        torch.cuda.empty_cache()
        out[f"population_m{m}"] = res
        S.log(f"population m={m}: " + "; ".join(
            f"{k} {v['alternated_round_ms']['median']:.4f} ms/round (alone {v['round_ms']:.4f}), "
            f"busy {v['device_busy_ms']:.4f} ms, host ops {v['host_ops']}, peak "
            f"{v['peak_gb']:.3f} GB ({v['round_peak_gb']:.3f} the round's)"
            for k, v in res.items()))


def screen(torch, trees, pairs, out):
    """The screen from the uplink to the keep mask, ``faults.screen_keep``
    with the default screen_mult (100) against the server row, in each tree
    (here one ``screen_keep`` launch; the parent's ``screen_uplink`` kernel
    and the plain rule) at ``chip_smoke.KEEP_SHAPES`` (f32), on the device
    (the stream pre-filled) and as the host enqueues it; with each tree's
    launches and tensor ops a call."""
    gen = S.seeded(torch, 60)
    for m, w in S.KEEP_SHAPES:
        u = torch.randn(m, w, generator=gen, device="cuda")
        r = torch.randn(w, generator=gen, device="cuda")
        cfgs = {tl: use(tree).FederatedConfig(screen=True) for tl, tree in trees.items()}
        for tl, tree in trees.items():
            t = use(tree)
            t.faults.screen_keep(cfgs[tl], u, r)
            t.ops.reset_launches()
            n_ops = S.round_ops(torch, lambda: t.faults.screen_keep(cfgs[tl], u, r))
            out[f"screen_{m}x{w}_{tl}_per_call"] = {
                "host_ops": n_ops, "launches": {k: v for k, v in t.ops.launches().items() if v}}
        for prefill in (True, False):
            res = alternate(trees, pairs, lambda tl, t: S.cuda_time_ms(
                lambda: t.faults.screen_keep(cfgs[tl], u, r), S.CHAIN_ITERS, prefill=prefill,
                spin_cycles=S.CHAIN_SPIN))
            key = f"screen_{m}x{w}_{'device' if prefill else 'host_paced'}_ms"
            out[key] = res
            S.log(f"screen ({m}, {w}), {'device' if prefill else 'host-paced'}: " + ", ".join(
                f"{k} {v['median']:.5f} ms ({out[f'screen_{m}x{w}_{k}_per_call']})"
                for k, v in res.items()))
        del u, r


def scaffold(torch, trees, pairs, out):
    """SCAFFOLD's full-arena tail in each tree (here ``ops.scaffold_step``,
    two passes; the parent's ``scaffold_cv`` kernel and the plain selects,
    means and column sum, ``chip_smoke.old_scaffold_tail``) at the Fig. 2
    arena, the softmax arena and lm_flat (f32, alpha 2.5, eta_g 1), without
    and with a mask, on the device and as the host enqueues it."""
    gen = S.seeded(torch, 61)
    for m, w in S.SCAFFOLD_SHAPES[:3]:
        ci, xt = (torch.randn(m, w, generator=gen, device="cuda") for _ in range(2))
        c, xs = (torch.randn(w, generator=gen, device="cuda") for _ in range(2))
        for mask in (None, torch.rand(m, generator=gen, device="cuda") < 0.5):

            def call(t):
                if hasattr(t.ops, "scaffold_step"):
                    return t.ops.scaffold_step(ci, xt, c, xs, 2.5, 1.0, mask)
                return S.old_scaffold_tail(torch, t.ops, t.ref, ci, xt, c, xs, 2.5, 1.0, mask)

            label = f"scaffold_{m}x{w}{'_masked' if mask is not None else ''}"
            for tl, tree in trees.items():
                t = use(tree)
                call(t)
                out[f"{label}_{tl}_host_ops"] = S.round_ops(torch, lambda: call(t))
            for prefill in (True, False):
                res = alternate(trees, pairs, lambda tl, t: S.cuda_time_ms(
                    lambda: call(t), S.CHAIN_ITERS, prefill=prefill, spin_cycles=S.CHAIN_SPIN))
                key = f"{label}_{'device' if prefill else 'host_paced'}_ms"
                out[key] = res
                S.log(f"{label}, {'device' if prefill else 'host-paced'}: " + ", ".join(
                    f"{k} {v['median']:.5f} ms ({out[f'{label}_{k}_host_ops']} host ops)"
                    for k, v in res.items()))
        del ci, xt, c, xs


# the server step's column walks (kernels 2-3), whose template SCAFFOLD's
# passes share: the Fig. 2 arena, the softmax arena, lm_flat and a
# population of 10^5 clients (S > 1 slices, the last block's sum)
WALK_SHAPES = ((500, 512), (10, 7936), (8, 1 << 20), (10 ** 5, 1024))


def server_walks(torch, trees, pairs, out):
    """The GPDMM/AGPDMM server step's column walks in each tree on the
    device (the stream pre-filled), f32 and bf16, at ``WALK_SHAPES``: the
    round tail with lam_is and the client mean in its pass
    (``round_tail_mean``, a full round's), without the mean
    (``round_tail``, a round with a cache), ``client_mean`` and
    ``server_dual``."""
    gen = S.seeded(torch, 62)
    for m, w in WALK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, lam, u = (torch.randn(m, w, generator=gen, device="cuda").to(dt)
                         for _ in range(3))
            xs = torch.randn(w, generator=gen, device="cuda").to(dt)
            calls = {"round_tail_mean": lambda t: t.ops.round_tail_mean(x, lam, xs, 2.5),
                     "round_tail": lambda t: t.ops.round_tail(x, lam, xs, 2.5),
                     "client_mean": lambda t: t.ops.client_mean(u),
                     "server_dual": lambda t: t.ops.server_dual(u, xs, 2.5)}
            iters = 200 if m * w < 1 << 22 else 40
            for name, call in calls.items():
                res = alternate(trees, pairs, lambda tl, t: S.cuda_time_ms(
                    lambda: call(t), iters))
                key = f"walk_{name}_{m}x{w}_{str(dt).split('.')[-1]}_device_ms"
                out[key] = res
                S.log(f"{name} ({m}, {w}) {dt}, device: " + ", ".join(
                    f"{k} {v['median'] * 1e3:.3f} us" for k, v in res.items()))
            del x, lam, u, xs
        torch.cuda.empty_cache()


SECTIONS = {"host_step": host_step, "device_step": device_step, "tables": tables,
            "rounds": rounds, "ef21": ef21, "cohort_rows": cohort_rows,
            "population": population, "screen": screen, "scaffold": scaffold,
            "server_walks": server_walks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the root of another checkout of the repo (its src/ is used)")
    ap.add_argument("--pairs", type=int, default=10, help="alternations of the two trees")
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--only", nargs="+", choices=sorted(SECTIONS),
                    help="run these measurements only (default: all, in the order listed "
                         "in the module docstring)")
    ap.add_argument("--cells", help="a regex: run only the round cells whose label it finds")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    S.log(card)
    trees = {"other": load_tree(Path(args.other)), "this": load_tree(HERE)}
    for label, tree in trees.items():
        t0 = time.perf_counter()
        use(tree).build.build_all()
        S.log(f"{label}: {tree['repro_torch'].__file__}, built in "
              f"{time.perf_counter() - t0:.1f} s")
    out = {"card": card, "pairs": args.pairs}
    for name, section in SECTIONS.items():
        if args.only is None or name in args.only:
            if name == "rounds":
                section(torch, trees, args.pairs, out, args.cells)
            else:
                section(torch, trees, args.pairs, out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    S.log(json.dumps({"ab": {k: v for k, v in out.items() if k not in ("card",)}})[:2000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
