"""Top-level language model, the port of ``src/repro/models/model.py``:
embeddings (with the multimodal stub frontends), decoder stack, head(s),
the causal LM loss and the serving paths (prefill and decode).

Batch dict: ``tokens`` (B, S) int, or (B, K, S) for musicgen's K codebooks;
``targets`` the same shape (training); ``patches`` (B, P, frontend_dim),
the vision prefix (llava); ``loss_mask`` optional (B, S_pred) f32.
``build(cfg)`` returns a ``Model`` of plain functions over nested parameter
dicts.  ``init`` takes a ``core.prng`` key (the reference's weights: its
split tree, drawn on ``device``, the card unless the caller asks for the
CPU) or a ``torch.Generator`` (the same distributions on the generator's
device).  The reference's sharding constraints are no-ops without a mesh
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def model_init(src, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters in the reference's layout and distributions, from
    ``src``: a ``core.prng`` key (the reference's weights, on ``device``)
    or a ``torch.Generator`` (on its own device)."""
    dtype = L.DTYPES[cfg.dtype]
    keys = L.as_keys(src, None if isinstance(src, torch.Generator) else resolve(device))
    ks = keys.split(5)
    p: dict[str, Any] = {}
    if cfg.n_codebooks > 1:
        shape = (cfg.n_codebooks, cfg.vocab_size, cfg.d_model)
        p["embed"] = {"w": L.normal(ks[0], shape, 0.02, dtype)}
        shape = (cfg.n_codebooks, cfg.d_model, cfg.vocab_size)
        p["head"] = {"w": L.normal(ks[1], shape, 0.02, dtype)}
    else:
        p["embed"] = L.embed_init(ks[0], cfg.vocab_size, cfg.d_model, dtype)
        w = p["embed"]["w"]
        p["embed"]["w"] = w * T.weak(0.02, w)
        if not cfg.tie_embeddings:
            p["head"] = {"w": L.dense_init(ks[1], (cfg.d_model, cfg.vocab_size), dtype)}
    if cfg.frontend == "vision":
        p["projector"] = {"w1": L.dense_init(ks[2], (cfg.frontend_dim, cfg.d_model), dtype),
                          "w2": L.dense_init(ks[3], (cfg.d_model, cfg.d_model), dtype)}
    p["stack"] = S.stack_init(ks[4], cfg, dtype)
    p["final_norm"] = L.norm_init(cfg.norm_kind, cfg.d_model, keys.device)
    return p


# ---------------------------------------------------------------------------
# embed / head
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens, patches=None):
    if cfg.n_codebooks > 1:
        # tokens (B, K, S): the codebooks' embeddings summed, from 0
        x = 0.0
        for kb in range(cfg.n_codebooks):
            x = x + params["embed"]["w"][kb][tokens[:, kb]]
        return x
    x = L.embed_apply(params["embed"], tokens)
    if cfg.frontend == "vision" and patches is not None:
        pj = params["projector"]
        pre = L.activation(patches.to(x.dtype) @ pj["w1"], "gelu") @ pj["w2"]
        x = torch.cat([pre, x], dim=1)
    return x


def _head(cfg: ArchConfig, params, x):
    if cfg.n_codebooks > 1:
        return torch.einsum("bsd,kdv->bskv", x, params["head"]["w"]).to(torch.float32)
    if cfg.tie_embeddings:
        return L.head_apply(params["embed"]["w"], x)
    return (x @ params["head"]["w"]).to(torch.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params, batch, *, mode="train", cache=None, pos=None,
            cache_cap: int = 0, window_override: Optional[int] = None,
            exact_moe: bool = False):
    x = _embed(cfg, params, batch["tokens"], batch.get("patches"))
    x, new_cache, aux = S.stack_apply(cfg, params["stack"], x, mode=mode, cache=cache, pos=pos,
                                      cache_cap=cache_cap, window_override=window_override,
                                      exact_moe=exact_moe)
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
    ``loss_fn``: the mean token cross entropy of the f32 logits (of the K
    codebooks' heads; of the text positions after a vision prefix), plus
    0.01 times the stack's auxiliary loss (0 without MoE)."""
    logits, _, aux = forward(cfg, params, batch, mode="train")
    if cfg.n_codebooks > 1:
        # logits (B, S, K, V) against targets (B, K, S)
        loss = _xent(logits, torch.movedim(batch["targets"], 1, 2), batch.get("loss_mask"))
    elif cfg.frontend == "vision":
        n_text = batch["tokens"].shape[1]
        loss = _xent(logits[:, -n_text:], batch["targets"], batch.get("loss_mask"))
    else:
        loss = _xent(logits, batch["targets"], batch.get("loss_mask"))
    total = loss + 0.01 * aux
    return total, {"xent": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params, batch, *, cache_cap: int,
            window_override: Optional[int] = None, exact_moe: bool = False):
    """(last-token logits (B, V) f32, or (B, K, V) for K codebooks, cache);
    the cache carries the int32 write position "pos" (the prompt's tokens
    and any vision prefix).  ``exact_moe``: every MoE block at full
    capacity, no token dropped."""
    logits, new_cache, _ = forward(cfg, params, batch, mode="prefill", cache_cap=cache_cap,
                                   window_override=window_override, exact_moe=exact_moe)
    seq = batch["tokens"].shape[-1]
    if cfg.frontend == "vision" and batch.get("patches") is not None:
        seq += batch["patches"].shape[1]
    pos = torch.full((), seq, dtype=torch.int32, device=logits.device)
    return logits[:, -1], {"layers": new_cache, "pos": pos}


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                window_override: Optional[int] = None):
    """tokens (B, 1) int, or (B, K, 1) for K codebooks.  Returns (logits
    (B, V) or (B, K, V) f32, cache).  The layer caches are updated in place
    and returned (``models.attention``); only "pos" is a new tensor."""
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


def cache_specs(cfg: ArchConfig, *, window_override: Optional[int] = None):
    """Logical axes in ``cache_shapes``' layout (the reference's sharding
    input; the port runs on one card and carries them only)."""
    return {"layers": S.stack_cache_specs(cfg, window_override), "pos": ()}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (prng key[, device] | torch.Generator) -> params
    apply: Callable  # (params, batch) -> logits
    loss: Callable  # (params, batch) -> (loss, aux)
    prefill: Callable  # (params, batch, cache_cap, exact_moe=False) -> (logits, cache)
    decode: Callable  # (params, cache, tokens) -> (logits, cache)
    cache_shapes: Callable  # (batch, cap) -> meta tensors in the cache's layout
    cache_specs: Callable  # () -> logical axes in the cache's layout


def build(cfg: ArchConfig, *, window_override: Optional[int] = None) -> Model:
    return Model(
        cfg=cfg,
        init=lambda src, device="cuda": model_init(src, cfg, device),
        apply=lambda p, b: forward(cfg, p, b, mode="train", window_override=window_override)[0],
        loss=lambda p, b: loss_fn(cfg, p, b),
        prefill=lambda p, b, cap, **kw: prefill(cfg, p, b, cache_cap=cap,
                                                window_override=window_override, **kw),
        decode=lambda p, c, t: decode_step(cfg, p, c, t, window_override=window_override),
        cache_shapes=lambda b, cap: cache_shapes(cfg, b, cap, window_override=window_override),
        cache_specs=lambda: cache_specs(cfg, window_override=window_override),
    )
