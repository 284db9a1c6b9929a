"""Attention, the port of ``src/repro/models/attention.py``: grouped-query
attention (full, sliding-window and local) and DeepSeek-V2's multi-head
latent attention (MLA) with its compressed cache and matrix-absorbed decode.

Modes:
  * ``train``   -- full sequence, no cache.
  * ``prefill`` -- full sequence through ``ops.flash_attention`` (kernel 16
                   on the card; MLA at hd 192, vd 128); returns a cache of
                   capacity ``cache_cap``.
  * ``decode``  -- one token against the cache: GQA through
                   ``ops.attend_cache``, MLA as the reference's plain f32
                   absorbed attention over the compressed cache.

Caches (per layer), as the reference's:
  GQA full:  {"k": (B, cap, Hkv, hd), "v": (B, cap, Hkv, hd)}
  GQA ring (window W): the same with cap == W; slot = pos % W and "k_pos":
        (W,) absolute position per slot (-1 = empty).
  MLA:       {"ckv": (B, cap, kv_lora), "kr": (B, cap, rope_hd)}

Decode writes the new entries into the cache tensors in place
(``index_copy_`` at the position tensor, no host read) and returns them:
the reference's ``dynamic_update_slice`` builds new arrays, the port saves
the copy of every layer's cache per token.  A caller that keeps an old cache
must clone it first.  ``gqa_cache_spec`` and ``mla_cache_spec`` are the
reference's logical axes of each cache leaf; the port runs on one card and
only carries them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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



def gqa_cache_spec(window):
    """Logical axes of ``gqa_cache_shape``'s leaves."""
    if window is not None:
        return {"k": ("batch", "seq", "kv", None), "v": ("batch", "seq", "kv", None),
                "k_pos": ("seq",)}
    return {"k": ("batch", "seq", "kv", None), "v": ("batch", "seq", "kv", None)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    ks = keys.split(5)
    return {
        "wq": L.dense_init(ks[0], (d, h, nope + rope_d), dtype),
        "wdkv": L.dense_init(ks[1], (d, kvl + rope_d), dtype),
        "wuk": L.dense_init(ks[2], (kvl, h, nope), dtype),
        "wuv": L.dense_init(ks[3], (kvl, h, vd), dtype),
        "wo": L.dense_init(ks[4], (h, vd, d), dtype, scale=1.0 / (h * vd) ** 0.5),
        "ckv_norm": L.norm_init("rmsnorm", kvl, keys.device),
    }


def mla_apply(cfg: ArchConfig, params, x, *, mode: str, cache=None, pos=None,
              cache_cap: int = 0):
    """x (B, S, D) (S == 1 in decode).  Returns (out, new_cache)."""
    B, S, D = x.shape
    h = cfg.n_heads
    nope, rope_d = cfg.nope_head_dim, cfg.rope_head_dim
    kvl = cfg.kv_lora_rank
    scale_dim = nope + rope_d
    dev, f32 = x.device, torch.float32

    q = _project(x, params["wq"])  # (B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = x @ params["wdkv"]  # (B, S, kvl + rope)
    ckv = L.norm_apply("rmsnorm", params["ckv_norm"], dkv[..., :kvl])
    k_rope = dkv[..., kvl:][:, :, None, :]  # (B, S, 1, rope)

    if mode in ("train", "prefill"):
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        cos, sin = L.rope_angles(positions, rope_d, cfg.rope_theta)
        q_rope = L.rope_apply(q_rope, cos, sin)
        k_rope = L.rope_apply(k_rope, cos, sin)
        k_nope = torch.einsum("bsl,lhk->bshk", ckv, params["wuk"])
        v = torch.einsum("bsl,lhk->bshk", ckv, params["wuv"]).contiguous()
        k_full = torch.cat([k_nope, k_rope.expand(B, S, h, rope_d)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention(q_full, k_full, v, causal=True, q_offset=0)
        new_cache = None
        if mode == "prefill":
            cap = max(cache_cap, S)
            ckv_c = torch.zeros((B, cap, kvl), dtype=ckv.dtype, device=dev)
            kr_c = torch.zeros((B, cap, rope_d), dtype=k_rope.dtype, device=dev)
            ckv_c[:, :S] = ckv
            kr_c[:, :S] = k_rope[:, :, 0, :]
            new_cache = {"ckv": ckv_c, "kr": kr_c}
        return _out(out, params["wo"]), new_cache

    # ---- decode: matrix-absorbed attention over the compressed cache ----
    if S != 1 or cache is None or pos is None:
        raise ValueError("decode takes one token, a cache and its position")
    q_pos = pos.to(torch.int32)
    cos, sin = L.rope_angles(q_pos[None], rope_d, cfg.rope_theta)
    q_rope = L.rope_apply(q_rope, cos[None], sin[None])
    k_rope = L.rope_apply(k_rope, cos[None], sin[None])
    ckv_c, kr_c = cache["ckv"], cache["kr"]
    at = q_pos.reshape(1).long()
    ckv_c.index_copy_(1, at, ckv)
    kr_c.index_copy_(1, at, k_rope[:, :, 0, :])
    cap = ckv_c.shape[1]
    # absorb W_uk into q: q_c[b,h,l] = sum_n q_nope[b,h,n] wuk[l,h,n]
    q_c = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].to(f32), params["wuk"].to(f32))
    s_nope = torch.einsum("bhl,bkl->bhk", q_c, ckv_c.to(f32))
    s_rope = torch.einsum("bhr,bkr->bhk", q_rope[:, 0].to(f32), kr_c.to(f32))
    s = (s_nope + s_rope) / float(np.sqrt(np.float32(scale_dim)))
    valid = torch.arange(cap, device=dev) <= q_pos
    s = torch.where(valid[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhk,bkl->bhl", p, ckv_c.to(f32))  # (B, H, kvl)
    out = torch.einsum("bhl,lhv->bhv", ctx_c, params["wuv"].to(f32))
    out = out[:, None].to(x.dtype)  # (B, 1, H, vd)
    return _out(out, params["wo"]), {"ckv": ckv_c, "kr": kr_c}


def mla_cache_shape(cfg: ArchConfig, batch: int, cap: int, dtype):
    """One MLA layer's cache as tensors on the meta device."""
    return {"ckv": torch.empty((batch, cap, cfg.kv_lora_rank), dtype=dtype, device="meta"),
            "kr": torch.empty((batch, cap, cfg.rope_head_dim), dtype=dtype, device="meta")}


def mla_cache_spec():
    """Logical axes of ``mla_cache_shape``'s leaves."""
    return {"ckv": ("batch", "seq", None), "kr": ("batch", "seq", None)}
