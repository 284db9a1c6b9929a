"""Batched serving launcher, the port of ``src/repro/launch/serve.py``:
prefill a batch of prompts, then greedily decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 4 --prompt-len 64 --new-tokens 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full \\
        --batch 4 --prompt-len 1024 --new-tokens 32

Every arch of ``repro_torch.configs`` serves: dense and local GQA, MLA, MoE,
RWKV-6, RG-LRU, llava's vision prefix (random patches, the stub frontend)
and musicgen's codebooks (a token a codebook a step).  The weights, the
prompts and the patches are the reference's for the same ``--seed``:
``model.init(prng.key(seed))``, prompts from ``prng.randint`` of that key and
patches from ``prng.normal`` of ``fold_in(key, 1)`` (``core.prng`` is jax's
threefry draw).  On the card, prefill runs kernel 16 (``flash_attention``)
in every attention block, kernel 17 (``wkv6``) in every RWKV block and
``lru_scan`` in every RG-LRU block; decode runs plain tensor code.  Times
are host clocks around work that ends in a device synchronise; on the card
one untimed prefill runs before the timed one.
``--device`` defaults to ``cuda`` and raises without a card
(``repro_torch.device.resolve``).

Train-while-serve: ``--ckpt-dir <dir> --watch`` polls the trainer's
checkpoints (``launch/train.py``'s anchors) between query batches
(``HotSwapWatcher``): a new step is loaded with retries and backoff
(``load_with_retry``), a truncated or corrupt file is rejected loudly and
remembered, and the last good parameters keep serving.  A swap only
repoints the parameter tree.

Telemetry: ``--trace-out`` records poll, swap, prefill and decode spans
(Chrome trace-event JSON), ``--metrics-out`` streams per-query rows and the
summary as JSONL, ``--prom-out`` writes the final counters as a Prometheus
textfile (``repro_torch.telemetry``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import telemetry as tel
from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.core import tree_util as T
from repro_torch.device import resolve
from repro_torch.models import Model, build as build_model


@dataclasses.dataclass
class Served:
    """What ``run`` served: the generated tokens (B, new_tokens), or (B, K,
    new_tokens) for K codebooks, the logits of the last decode step (B, V)
    or (B, K, V) f32, the times, the model, parameters and prompt batch
    (``{"tokens", "patches"?}``) it served them from, the seconds the
    weights took to draw and, on a card, the peak device allocation (bytes)
    of the draw and of the serving after it."""

    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_ms: float
    decode_ms_per_token: float
    model: Model
    params: dict
    batch: dict
    init_s: float = 0.0
    init_peak_bytes: int | None = None
    serve_peak_bytes: int | None = None

    @property
    def prompts(self) -> torch.Tensor:
        return self.batch["tokens"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pick(logits):
    """The greedy next token: (B, 1), or (B, K, 1) for K codebooks."""
    return torch.argmax(logits, dim=-1)[..., None]


def prompt_batch(cfg, key, batch: int, prompt_len: int, device) -> dict:
    """The reference's prompts (and patches) from ``key``: ``randint`` over
    (batch, [K,] prompt_len) and, for a vision frontend, ``normal`` of
    ``fold_in(key, 1)`` over (batch, n_prefix_tokens, frontend_dim)."""
    shape = ((batch, cfg.n_codebooks, prompt_len) if cfg.n_codebooks > 1
             else (batch, prompt_len))
    n = int(np.prod(shape))
    b = {"tokens": prng.randint(key, n, 0, cfg.vocab_size, device).long().reshape(shape)}
    if cfg.frontend == "vision":
        shape = (batch, cfg.n_prefix_tokens, cfg.frontend_dim)
        b["patches"] = prng.normal(prng.fold_in(key, 1), int(np.prod(shape)),
                                   device).reshape(shape)
    return b


def generate(model: Model, params, batch, new_tokens: int, cache_cap: int, *,
             exact_moe: bool = False, tracer=None):
    """Prefill ``batch`` (a dict with "tokens" (B, [K,] S) and any
    "patches") and greedily decode ``new_tokens`` tokens.  Returns (tokens
    (B, [K,] new_tokens), last logits, prefill s, decode s).
    ``exact_moe``: the prefill's MoE blocks at full capacity."""
    tracer = tracer or tel.get_tracer()
    dev = batch["tokens"].device
    _sync(dev)
    t0 = time.perf_counter()
    with tracer.span("serve/prefill", {"batch": int(batch["tokens"].shape[0])}):
        logits, cache = model.prefill(params, batch, cache_cap, exact_moe=exact_moe)
        _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    with tracer.span("serve/decode", {"new_tokens": new_tokens}):
        for _ in range(new_tokens):
            nxt = pick(logits)
            logits, cache = model.decode(params, cache, nxt)
            out.append(nxt)
        _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=-1) if out else batch["tokens"][..., :0]
    return gen, logits, t_prefill, t_decode


def _tel_setup(telemetry: bool, trace_out, metrics_out):
    """(tel_on, tracer, registry, sink, was_tracing): the process-global
    tracer, so that library code emits into the same trace."""
    tel_on = telemetry or bool(trace_out) or bool(metrics_out)
    tracer = tel.get_tracer()
    was_tracing = tracer.enabled
    if trace_out:
        tracer.configure(enabled=True, trace_out=trace_out)
    registry = tel.Registry() if tel_on else None
    sink = tel.JsonlSink(metrics_out) if metrics_out else None
    return tel_on, tracer, registry, sink, was_tracing


def _tel_teardown(tracer, sink, trace_out, was_tracing):
    if sink is not None:
        sink.close()
    if trace_out:
        path = tracer.close()
        if path:
            print(f"[telemetry] trace written to {path} (load in https://ui.perfetto.dev)",
                  flush=True)
        tracer.configure(enabled=was_tracing)


def _config(arch: str, reduced: bool, layers: int | None = None):
    cfg = get_arch(arch)
    cfg = cfg.reduced() if reduced else cfg
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _peak(dev, reset: bool = False):
    """The peak device allocation since the last reset (None off a card)."""
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def run(arch: str, *, reduced: bool = True, batch: int = 4, prompt_len: int = 64,
        new_tokens: int = 16, seed: int = 0, device="cuda", quiet: bool = False,
        layers: int | None = None, telemetry: bool = False,
        trace_out: str | None = None, metrics_out: str | None = None,
        prom_out: str | None = None) -> Served:
    """Serve one batch (see the module doc).  ``layers`` cuts the depth at
    full width.  On the card one untimed prefill runs first: the first call
    loads the kernels and warms the allocator."""
    dev = resolve(device)
    cfg = _config(arch, reduced, layers)
    model = build_model(cfg)
    key = prng.key(seed)
    tel_on, tracer, registry, sink, was_tracing = _tel_setup(telemetry, trace_out, metrics_out)
    with torch.no_grad():
        _sync(dev)
        _peak(dev, reset=True)
        t0 = time.perf_counter()
        params = model.init(key, dev)
        _sync(dev)
        init_s = time.perf_counter() - t0
        init_peak = _peak(dev, reset=True)
        b = prompt_batch(cfg, key, batch, prompt_len, dev)
        cap = prompt_len + new_tokens + cfg.n_prefix_tokens
        if dev.type == "cuda":
            model.prefill(params, b, cap)
        tokens, logits, t_prefill, t_decode = generate(model, params, b, new_tokens, cap,
                                                       tracer=tracer)
    per_token = t_decode / new_tokens if new_tokens else 0.0
    if not quiet:
        print(f"[serve] arch={arch} batch={batch} prompt={prompt_len} new={new_tokens} "
              f"device={dev}")
        print(f"[serve] prefill {t_prefill * 1e3:.1f} ms; decode {per_token * 1e3:.2f} ms/token")
        print(f"[serve] sample generated ids: {tokens[0, ..., :8].tolist()}")
    if tel_on:
        n_tok = tokens.numel()
        registry.counter("serve/tokens").inc(n_tok)
        registry.histogram("serve/prefill_s").observe(t_prefill)
        registry.histogram("serve/decode_s").observe(t_decode)
        registry.gauge("serve/tokens_per_s").set(n_tok / t_decode if t_decode > 0 else 0.0)
        if sink is not None:
            sink.write({"kind": "summary", **registry.summary_row()})
        if prom_out:
            print(f"[telemetry] prometheus textfile -> "
                  f"{tel.write_prometheus(registry, prom_out)}", flush=True)
    _tel_teardown(tracer, sink, trace_out, was_tracing)
    return Served(tokens, logits, t_prefill * 1e3, per_token * 1e3, model, params, b, init_s,
                  init_peak, _peak(dev))


# ---------------------------------------------------------------------------
# train-while-serve
# ---------------------------------------------------------------------------

def load_with_retry(ckpt_dir: str, step: int, *, retries: int = 3, backoff: float = 0.05,
                    factor: float = 2.0):
    """``checkpoint.load`` with exponential backoff.  Saves are atomic, so a
    transient failure is a filesystem race (the trainer's keep-N pruning
    unlinking the step between listing and reading); a failure that
    persists through ``retries`` attempts is a truncated or corrupt file and
    propagates."""
    delay = backoff
    for attempt in range(retries):
        try:
            return ckpt.load(ckpt_dir, step)
        except (FileNotFoundError, ValueError, OSError):
            if attempt == retries - 1:
                raise
            time.sleep(delay)
            delay *= factor
    raise AssertionError("unreachable")


class HotSwapWatcher:
    """The newest loadable checkpoint under ``ckpt_dir``.

    ``poll()`` walks the steps on disk newest first, skips steps already
    rejected, and returns the payload of the first new step that loads, or
    ``None`` when nothing is newer than the step served.  A step whose load
    still fails after the retries is rejected loudly and remembered in
    ``bad``; the caller keeps serving the last good parameters."""

    def __init__(self, ckpt_dir: str, *, retries: int = 3, backoff: float = 0.05,
                 factor: float = 2.0):
        self.ckpt_dir = ckpt_dir
        self.retries, self.backoff, self.factor = retries, backoff, factor
        self.step: int | None = None
        self.payload = None
        self.bad: set[int] = set()
        self.swaps = 0
        self.failures = 0

    def poll(self):
        cur = -1 if self.step is None else self.step
        for step in sorted(ckpt.steps(self.ckpt_dir), reverse=True):
            if step <= cur:
                break
            if step in self.bad:
                continue
            try:
                payload = load_with_retry(self.ckpt_dir, step, retries=self.retries,
                                          backoff=self.backoff, factor=self.factor)
            except (FileNotFoundError, ValueError, OSError) as e:
                self.bad.add(step)
                self.failures += 1
                print(f"[serve] REJECTED checkpoint step {step}: {e}", flush=True)
                continue
            self.step = step
            self.payload = payload
            self.swaps += 1
            return payload
        return None


def _on_device(tree, dev):
    """A loaded checkpoint tree (CPU tensors, numpy) as tensors on ``dev``."""
    return T.tmap(lambda a: a.to(dev) if torch.is_tensor(a)
                  else torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def run_watch(arch: str, *, ckpt_dir: str, reduced: bool = True, batch: int = 2,
              prompt_len: int = 16, new_tokens: int = 4, seed: int = 0,
              poll_interval: float = 0.25, duration: float = 30.0, wait_first: float = 60.0,
              stop_when=None, retries: int = 3, backoff: float = 0.05,
              history: list | None = None, device="cuda", telemetry: bool = False,
              trace_out: str | None = None, metrics_out: str | None = None,
              prom_out: str | None = None):
    """Serve queries while a trainer writes checkpoints.

    Waits up to ``wait_first`` seconds for the first loadable checkpoint
    (then ``TimeoutError``), then alternates poll, swap if newer, and one
    greedy query batch until ``duration`` elapses or ``stop_when()`` is
    true.  Returns the per-query rows ``{"t", "step", "round", "tokens"}``
    and the watcher; ``history``, a caller's list, is appended in place."""
    dev = resolve(device)
    cfg = _config(arch, reduced)
    model = build_model(cfg)
    key = prng.key(seed)

    tel_on, tracer, registry, sink, was_tracing = _tel_setup(telemetry, trace_out, metrics_out)
    # swap and rejection counters are kept with telemetry off too: the
    # end-of-run summary prints them
    registry = registry or tel.Registry()

    watcher = HotSwapWatcher(ckpt_dir, retries=retries, backoff=backoff)
    t_first = time.perf_counter()
    payload = watcher.poll()
    while payload is None:
        if time.perf_counter() - t_first > wait_first:
            raise TimeoutError(f"no loadable checkpoint appeared under {ckpt_dir} within "
                               f"{wait_first:.0f}s")
        time.sleep(poll_interval)
        payload = watcher.poll()
    params = _on_device(payload["server"], dev)
    print(f"[serve] serving step {watcher.step} (round {int(payload['round'])}) from "
          f"{ckpt_dir}", flush=True)
    b = prompt_batch(cfg, key, batch, prompt_len, dev)
    cap = prompt_len + new_tokens + cfg.n_prefix_tokens

    def query(p):
        with torch.no_grad():
            gen, _, _, _ = generate(model, p, b, new_tokens, cap, tracer=tracer)
        return int(gen.numel())

    history = [] if history is None else history
    t_end = time.perf_counter() + duration
    while True:
        t_poll = time.perf_counter()
        with tracer.span("serve/poll"):
            fresh = watcher.poll()
        if fresh is not None:
            payload, params = fresh, _on_device(fresh["server"], dev)
            swap_s = time.perf_counter() - t_poll
            registry.histogram("serve/swap_latency_s").observe(swap_s)
            tracer.instant("serve/swap", {"step": watcher.step, "round": int(payload["round"]),
                                          "latency_s": swap_s})
            print(f"[serve] hot-swapped to step {watcher.step} (round {int(payload['round'])})",
                  flush=True)
        t_q = time.perf_counter()
        n_tok = query(params)
        q_s = time.perf_counter() - t_q
        registry.counter("serve/tokens").inc(n_tok)
        registry.histogram("serve/query_s").observe(q_s)
        row = {"t": time.time(), "step": watcher.step, "round": int(payload["round"]),
               "tokens": n_tok}
        history.append(row)
        if sink is not None:
            sink.write({"kind": "query", "query_s": q_s, **row})
        tracer.flush()
        if stop_when is not None and stop_when():
            break
        if time.perf_counter() >= t_end:
            break
        time.sleep(poll_interval)
    served = sorted({row["step"] for row in history})
    registry.counter("serve/swaps").inc(watcher.swaps)
    registry.counter("serve/rejections").inc(watcher.failures)
    q_hist = registry.histogram("serve/query_s")
    swap_hist = registry.histogram("serve/swap_latency_s")
    tok_total = registry.counter("serve/tokens").value
    tokens_per_s = tok_total / q_hist.total if q_hist.total > 0 else 0.0
    registry.gauge("serve/tokens_per_s").set(tokens_per_s)
    print(f"[serve] {len(history)} query batches; served steps {served}; "
          f"swaps={watcher.swaps} rejected={watcher.failures}", flush=True)
    mean_swap = "n/a" if swap_hist.count == 0 else f"{swap_hist.mean * 1e3:.1f} ms"
    print(f"[serve] summary: tokens={int(tok_total)} tokens_per_s={tokens_per_s:.1f} "
          f"mean_query={q_hist.mean * 1e3:.1f} ms mean_swap_latency={mean_swap}", flush=True)
    if sink is not None:
        sink.write({"kind": "summary", **registry.summary_row()})
    if prom_out:
        print(f"[telemetry] prometheus textfile -> {tel.write_prometheus(registry, prom_out)}",
              flush=True)
    _tel_teardown(tracer, sink, trace_out, was_tracing)
    return history, watcher


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    # --reduced defaults on; --full is the only way to full-size serving
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, at the arch's width")
    ap.add_argument("--ckpt-dir", default=None,
                    help="with --watch: hot-swap serve the trainer's anchors")
    ap.add_argument("--watch", action="store_true",
                    help="train-while-serve: poll --ckpt-dir for new checkpoints between "
                         "query batches")
    ap.add_argument("--poll-interval", type=float, default=0.25)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="watch mode: serve for this many seconds")
    ap.add_argument("--wait-first", type=float, default=60.0,
                    help="watch mode: seconds to wait for the first anchor")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the metrics registry even without sinks")
    ap.add_argument("--trace-out", default=None,
                    help="write poll/swap/prefill/decode spans as Chrome trace-event JSON")
    ap.add_argument("--metrics-out", default=None,
                    help="stream per-query rows + summary as JSONL")
    ap.add_argument("--prom-out", default=None,
                    help="write final counters as a Prometheus textfile")
    args = ap.parse_args()
    tel_kw = dict(telemetry=args.telemetry, trace_out=args.trace_out,
                  metrics_out=args.metrics_out, prom_out=args.prom_out)
    if args.watch:
        if not args.ckpt_dir:
            raise SystemExit("--watch needs --ckpt-dir")
        run_watch(args.arch, ckpt_dir=args.ckpt_dir, reduced=args.reduced, batch=args.batch,
                  prompt_len=args.prompt_len, new_tokens=args.new_tokens, seed=args.seed,
                  poll_interval=args.poll_interval, duration=args.duration,
                  wait_first=args.wait_first, device=args.device, **tel_kw)
    else:
        run(args.arch, reduced=args.reduced, batch=args.batch, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, seed=args.seed, device=args.device, layers=args.layers,
            **tel_kw)


if __name__ == "__main__":
    main()
