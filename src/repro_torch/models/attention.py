"""Grouped-query attention (full, sliding-window and local), the port of the
GQA half of ``src/repro/models/attention.py``; MLA waits for a later slice
(``ROADMAP.md`` item 8).

Modes:
  * ``train``   -- full sequence, no cache.
  * ``prefill`` -- full sequence through ``ops.flash_attention`` (kernel 16
                   on the card); returns a cache of capacity ``cache_cap``.
  * ``decode``  -- one token against the cache (``ops.attend_cache``).

Caches (per layer), as the reference's:
  full:  {"k": (B, cap, Hkv, hd), "v": (B, cap, Hkv, hd)}
  ring (window W): the same with cap == W; slot = pos % W and "k_pos": (W,)
        absolute position per slot (-1 = empty).

Decode writes the new key and value into the cache tensors in place
(``index_copy_`` at the position tensor, no host read) and returns them:
the reference's ``dynamic_update_slice`` builds new arrays, the port saves
the copy of every layer's cache per token.  A caller that keeps an old cache
must clone it first.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def gqa_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    k1, k2, k3, k4 = keys.split(4)
    return {
        "wq": L.dense_init(k1, (d, h, hd), dtype),
        "wk": L.dense_init(k2, (d, hkv, hd), dtype),
        "wv": L.dense_init(k3, (d, hkv, hd), dtype),
        "wo": L.dense_init(k4, (h, hd, d), dtype, scale=1.0 / (h * hd) ** 0.5),
    }


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product, contiguous."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])


def _out(o, wo):
    """einsum("bshk,hkd->bsd")."""
    B, S, H, hd = o.shape
    return (o.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).reshape(B, S, -1)


def gqa_apply(cfg: ArchConfig, params, x, *, mode: str, cache=None, pos=None,
              window: Optional[int] = None, cache_cap: int = 0):
    """x (B, S, D) (S == 1 in decode).  Returns (out, new_cache)."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    dev = x.device

    if mode in ("train", "prefill"):
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        cos, sin = L.rope_angles(positions, hd, cfg.rope_theta)
        q, k = L.rope_apply(q, cos, sin), L.rope_apply(k, cos, sin)
        out = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=0)
        new_cache = None
        if mode == "prefill":
            if window is not None:
                W = min(window, cache_cap or window)
                take = min(W, S)
                slots = torch.arange(S - take, S, device=dev) % W
                kc = torch.zeros((B, W, cfg.n_kv_heads, hd), dtype=k.dtype, device=dev)
                vc = torch.zeros((B, W, cfg.n_kv_heads, hd), dtype=v.dtype, device=dev)
                kc[:, slots] = k[:, S - take:]
                vc[:, slots] = v[:, S - take:]
                k_pos = torch.full((W,), -1, dtype=torch.int32, device=dev)
                k_pos[slots] = torch.arange(S - take, S, dtype=torch.int32, device=dev)
                new_cache = {"k": kc, "v": vc, "k_pos": k_pos}
            else:
                cap = max(cache_cap, S)
                kc = torch.zeros((B, cap, cfg.n_kv_heads, hd), dtype=k.dtype, device=dev)
                vc = torch.zeros((B, cap, cfg.n_kv_heads, hd), dtype=v.dtype, device=dev)
                kc[:, :S] = k
                vc[:, :S] = v
                new_cache = {"k": kc, "v": vc}
        return _out(out, params["wo"]), new_cache

    # ---- decode ----
    if S != 1 or cache is None or pos is None:
        raise ValueError("decode takes one token, a cache and its position")
    q_pos = pos.to(torch.int32)
    cos, sin = L.rope_angles(q_pos[None], hd, cfg.rope_theta)
    q = L.rope_apply(q, cos[None], sin[None])
    k = L.rope_apply(k, cos[None], sin[None])
    kc, vc = cache["k"], cache["v"]
    if window is not None:
        slot = torch.remainder(q_pos, kc.shape[1]).reshape(1).long()
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        k_pos = cache["k_pos"]
        k_pos.index_copy_(0, slot, q_pos.reshape(1))
        out = ops.attend_cache(q, kc, vc, q_pos, k_pos, window=window)
        new_cache = {"k": kc, "v": vc, "k_pos": k_pos}
    else:
        kc.index_copy_(1, q_pos.reshape(1).long(), k)
        vc.index_copy_(1, q_pos.reshape(1).long(), v)
        ar = torch.arange(kc.shape[1], device=dev)
        k_pos = torch.where(ar <= q_pos, ar, -1).to(torch.int32)
        out = ops.attend_cache(q, kc, vc, q_pos, k_pos, window=None)
        new_cache = {"k": kc, "v": vc}
    return _out(out, params["wo"]), new_cache


def gqa_cache_shape(cfg: ArchConfig, batch: int, cap: int, window: Optional[int], dtype):
    """One layer's cache as tensors on the meta device (shapes and dtypes,
    no storage: the reference's ``ShapeDtypeStruct``)."""
    hd = cfg.resolved_head_dim
    W = cap if window is None else min(window, cap)
    out = {name: torch.empty((batch, W, cfg.n_kv_heads, hd), dtype=dtype, device="meta")
           for name in ("k", "v")}
    if window is not None:
        out["k_pos"] = torch.empty((W,), dtype=torch.int32, device="meta")
    return out

