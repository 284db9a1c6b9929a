"""Top-level language model, the port of ``src/repro/models/model.py``:
embedding, decoder stack, head, the causal LM loss and the serving paths
(prefill and decode).

Batch dict: ``tokens`` (B, S) int, ``targets`` the same shape (training),
``loss_mask`` optional (B, S) f32.  ``build(cfg)`` returns a ``Model`` of
plain functions over nested parameter dicts.  ``init`` takes a
``core.prng`` key (the reference's weights: its split tree, drawn on
``device``, the card unless the caller asks for the CPU) or a
``torch.Generator`` (the serving path's draw on the generator's device).
The vision frontend and multi-codebook heads are ``ROADMAP.md`` item 8 and
raise here.  The reference's sharding constraints are no-ops without a mesh
and have no counterpart; its one-hot contraction for the target logit is a
gather here (the one-hot sum adds zeros to the target logit, exactly).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree_util as T
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import stack as S


def check_ported(cfg: ArchConfig) -> None:
    """Raise for what this slice has not ported (see the module doc)."""
    if cfg.frontend is not None or cfg.n_codebooks > 1:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend or 'multi-codebook'} frontend is not ported yet "
            f"(ROADMAP.md item 8)")
    S.check_ported(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def model_init(src, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters in the reference's layout and distributions, from
    ``src``: a ``core.prng`` key (the reference's weights, on ``device``)
    or a ``torch.Generator`` (on its own device)."""
    check_ported(cfg)
    dtype = L.DTYPES[cfg.dtype]
    keys = L.as_keys(src, None if isinstance(src, torch.Generator) else resolve(device))
    ks = keys.split(5)
    p: dict[str, Any] = {"embed": L.embed_init(ks[0], cfg.vocab_size, cfg.d_model, dtype)}
    w = p["embed"]["w"]
    p["embed"]["w"] = w * T.weak(0.02, w)
    if not cfg.tie_embeddings:
        p["head"] = {"w": L.dense_init(ks[1], (cfg.d_model, cfg.vocab_size), dtype)}
    p["stack"] = S.stack_init(ks[4], cfg, dtype)
    p["final_norm"] = L.norm_init(cfg.norm_kind, cfg.d_model, keys.device)
    return p


# ---------------------------------------------------------------------------
# embed / head
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens):
    return L.embed_apply(params["embed"], tokens)


def _head(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return L.head_apply(params["embed"]["w"], x)
    return (x @ params["head"]["w"]).to(torch.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params, batch, *, mode="train", cache=None, pos=None,
            cache_cap: int = 0, window_override: Optional[int] = None):
    check_ported(cfg)
    x = _embed(cfg, params, batch["tokens"])
    x, new_cache, aux = S.stack_apply(cfg, params["stack"], x, mode=mode, cache=cache, pos=pos,
                                      cache_cap=cache_cap, window_override=window_override)
    x = L.norm_apply(cfg.norm_kind, params["final_norm"], x)
    return _head(cfg, params, x), new_cache, aux


def _xent(logits, targets, mask=None):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg: ArchConfig, params, batch):
    """Causal LM loss; returns (loss, aux dict) as the reference's
    ``loss_fn``: the mean token cross entropy of the f32 logits, plus 0.01
    times the stack's auxiliary loss (0 without MoE)."""
    logits, _, aux = forward(cfg, params, batch, mode="train")
    loss = _xent(logits, batch["targets"], batch.get("loss_mask"))
    total = loss + 0.01 * aux
    return total, {"xent": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params, batch, *, cache_cap: int,
            window_override: Optional[int] = None):
    """(last-token logits (B, V) f32, cache); the cache carries the int32
    write position "pos"."""
    logits, new_cache, _ = forward(cfg, params, batch, mode="prefill", cache_cap=cache_cap,
                                   window_override=window_override)
    seq = batch["tokens"].shape[-1]
    pos = torch.full((), seq, dtype=torch.int32, device=logits.device)
    return logits[:, -1], {"layers": new_cache, "pos": pos}


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                window_override: Optional[int] = None):
    """tokens (B, 1) int.  Returns (logits (B, V) f32, cache).  The layer
    caches are updated in place and returned (``models.attention``); only
    "pos" is a new tensor."""
    pos = cache["pos"]
    logits, new_layers, _ = forward(cfg, params, {"tokens": tokens}, mode="decode",
                                    cache=cache["layers"], pos=pos,
                                    window_override=window_override)
    return logits[:, -1], {"layers": new_layers, "pos": pos + 1}


def cache_shapes(cfg: ArchConfig, batch: int, cap: int, *,
                 window_override: Optional[int] = None):
    """The serving cache as tensors on the meta device."""
    dtype = L.DTYPES[cfg.dtype]
    return {"layers": S.stack_cache_shapes(cfg, batch, cap, dtype, window_override),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (prng key[, device] | torch.Generator) -> params
    apply: Callable  # (params, batch) -> logits
    loss: Callable  # (params, batch) -> (loss, aux)
    prefill: Callable  # (params, batch, cache_cap) -> (logits, cache)
    decode: Callable  # (params, cache, tokens) -> (logits, cache)
    cache_shapes: Callable  # (batch, cap) -> meta tensors in the cache's layout


def build(cfg: ArchConfig, *, window_override: Optional[int] = None) -> Model:
    check_ported(cfg)
    return Model(
        cfg=cfg,
        init=lambda src, device="cuda": model_init(src, cfg, device),
        apply=lambda p, b: forward(cfg, p, b, mode="train", window_override=window_override)[0],
        loss=lambda p, b: loss_fn(cfg, p, b),
        prefill=lambda p, b, cap: prefill(cfg, p, b, cache_cap=cap,
                                          window_override=window_override),
        decode=lambda p, c, t: decode_step(cfg, p, c, t, window_override=window_override),
        cache_shapes=lambda b, cap: cache_shapes(cfg, b, cap, window_override=window_override),
    )
