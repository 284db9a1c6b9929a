"""Batched serving launcher, the port of ``src/repro/launch/serve.py``:
prefill a batch of prompts, then greedily decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 4 --prompt-len 64 --new-tokens 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --full \\
        --batch 4 --prompt-len 1024 --new-tokens 32

The model is built once and its parameters drawn at random from a
``torch.Generator`` on the device (seed ``--seed``); the prompts come from a
generator of their own (seed + 1).  On the card, prefill runs kernel 16
(``flash_attention``) in every dense or local block and kernel 17 (``wkv6``)
in every RWKV block; decode runs plain tensor code.  Times are host clocks
around work that ends in a device synchronise.  ``--device`` defaults to
``cuda`` and raises without a card (``repro_torch.device.resolve``).  The
reference's hot-swap (``--watch``, ``--ckpt-dir``) and telemetry flags need
``checkpoint/`` and ``telemetry/``, which the port has not yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve
from repro_torch.models import Model, build as build_model


@dataclasses.dataclass
class Served:
    """What ``run`` served: the generated tokens (B, new_tokens), the
    logits of the last decode step (B, V) f32, the times, and the model,
    parameters and prompts it served them from."""

    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_ms: float
    decode_ms_per_token: float
    model: Model
    params: dict
    prompts: torch.Tensor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, prompts, new_tokens: int, cache_cap: int):
    """Prefill ``prompts`` (B, S) and greedily decode ``new_tokens`` tokens.
    Returns (tokens (B, new_tokens), last logits, prefill s, decode s)."""
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_cap)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        nxt = torch.argmax(logits, dim=-1)[:, None]
        logits, cache = model.decode(params, cache, nxt)
        out.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=-1) if out else prompts[:, :0]
    return gen, logits, t_prefill, t_decode


def run(arch: str, *, reduced: bool = True, batch: int = 4, prompt_len: int = 64,
        new_tokens: int = 16, seed: int = 0, device="cuda", quiet: bool = False) -> Served:
    dev = resolve(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        gen_p = torch.Generator(device=dev).manual_seed(seed + 1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen_p,
                                device=dev)
        tokens, logits, t_prefill, t_decode = generate(model, params, prompts, new_tokens,
                                                       prompt_len + new_tokens)
    per_token = t_decode / new_tokens if new_tokens else 0.0
    if not quiet:
        print(f"[serve] arch={arch} batch={batch} prompt={prompt_len} new={new_tokens} "
              f"device={dev}")
        print(f"[serve] prefill {t_prefill * 1e3:.1f} ms; decode {per_token * 1e3:.2f} ms/token")
        print(f"[serve] sample generated ids: {tokens[0, :8].tolist()}")
    return Served(tokens, logits, t_prefill * 1e3, per_token * 1e3, model, params, prompts)


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
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, batch=args.batch, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
