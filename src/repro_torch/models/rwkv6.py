"""RWKV-6 ("Finch") block, the port of ``src/repro/models/rwkv6.py``:
time mix with the data-dependent decay w_t = exp(-exp(w0 + tanh(x A) B)),
the per-head wkv state S (K x V) with bonus u, group norm on the wkv output,
and the squared-relu channel mix.  As in the reference, the r/k/v/g token
shift mixes are static (mu); the decay is fully dynamic.

Prefill runs the recurrence through ``ops.wkv6`` (kernel 17 on the card),
decode one step of plain tensor code (``ops.wkv6_step``).  State per layer:
{"tm_last": (B, D), "cm_last": (B, D), "s": (B, H, K, V) f32}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

DECAY_LORA = 64


def rwkv_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.wkv_head_dim
    h = d // hd
    dev = keys.device
    ks = keys.split(12)
    p = {nm: L.const_init(0.5, (d,), dtype, dev)
         for nm in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")}
    for i, nm in enumerate(("wr", "wk", "wv", "wg", "wo")):
        p[nm] = L.dense_init(ks[i], (d, d), dtype)
    # data-dependent decay: w = exp(-exp(w0 + tanh(xw @ A) @ B))
    p["w0"] = L.const_init(-6.0, (d,), torch.float32, dev)
    p["decay_a"] = L.dense_init(ks[5], (d, DECAY_LORA), dtype)
    p["decay_b"] = L.normal(ks[6], (DECAY_LORA, d), 0.01, dtype)
    p["u"] = L.normal(ks[7], (h, hd), 0.1, torch.float32)
    p["cm_mu_k"] = L.const_init(0.5, (d,), dtype, dev)
    p["cm_mu_r"] = L.const_init(0.5, (d,), dtype, dev)
    p["cm_wk"] = L.dense_init(ks[8], (d, cfg.d_ff), dtype)
    p["cm_wv"] = L.dense_init(ks[9], (cfg.d_ff, d), dtype)
    p["cm_wr"] = L.dense_init(ks[10], (d, d), dtype)
    return p


def _shift(x, last):
    """Token shift: x_{t-1}, with ``last`` for t = 0.  x (B, S, D)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(cfg: ArchConfig, params, x, *, mode: str, state=None):
    """x (B, S, D), the normalised block input.  Returns (out, new_state)."""
    B, S, D = x.shape
    hd = cfg.wkv_head_dim
    H = D // hd
    last = state["tm_last"] if state is not None else torch.zeros((B, D), dtype=x.dtype,
                                                                  device=x.device)
    xp = _shift(x, last) if mode != "decode" else last[:, None, :]

    def mix(mu):
        return x + (xp - x) * mu

    r = (mix(params["mu_r"]) @ params["wr"]).reshape(B, S, H, hd)
    k = (mix(params["mu_k"]) @ params["wk"]).reshape(B, S, H, hd)
    v = (mix(params["mu_v"]) @ params["wv"]).reshape(B, S, H, hd)
    g = F.silu(mix(params["mu_g"]) @ params["wg"])
    xw = mix(params["mu_w"])
    f32 = torch.float32
    dec = params["w0"] + (torch.tanh(xw @ params["decay_a"]).to(f32)
                          @ params["decay_b"].to(f32))
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, hd)  # in (0, 1)

    s0 = state["s"] if state is not None else torch.zeros((B, H, hd, hd), dtype=f32,
                                                          device=x.device)
    if mode == "decode":
        y, s_new = ops.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0].to(f32), params["u"], s0)
        y = y[:, None]
    else:
        y, s_new = ops.wkv6(r, k, v, w, params["u"].contiguous(), s0)
    y = L.groupnorm_heads(y.reshape(B, S, D), H) * g
    out = y @ params["wo"]
    new_state = None if mode == "train" else {"tm_last": x[:, -1, :], "s": s_new}
    return out, new_state


def rwkv_channel_mix(cfg: ArchConfig, params, x, *, mode: str, state=None):
    B, S, D = x.shape
    last = state["cm_last"] if state is not None else torch.zeros((B, D), dtype=x.dtype,
                                                                  device=x.device)
    xp = _shift(x, last) if mode != "decode" else last[:, None, :]
    xk = x + (xp - x) * params["cm_mu_k"]
    xr = x + (xp - x) * params["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ params["cm_wk"]))
    out = torch.sigmoid(xr @ params["cm_wr"]) * (kk @ params["cm_wv"])
    new_state = None if mode == "train" else {"cm_last": x[:, -1, :]}
    return out, new_state


def rwkv_state_shape(cfg: ArchConfig, batch: int, dtype):
    """One layer's state as tensors on the meta device."""
    d, hd = cfg.d_model, cfg.wkv_head_dim
    meta = {"device": "meta"}
    return {"tm_last": torch.empty((batch, d), dtype=dtype, **meta),
            "cm_last": torch.empty((batch, d), dtype=dtype, **meta),
            "s": torch.empty((batch, d // hd, hd, hd), dtype=torch.float32, **meta)}


def rwkv_state_spec():
    """Logical axes of ``rwkv_state_shape``'s leaves."""
    return {"tm_last": ("batch", None), "cm_last": ("batch", None),
            "s": ("batch", "heads", None, None)}
