"""Griffin / RecurrentGemma recurrent block, the port of
``src/repro/models/rglru.py``: input and gate branches, a short causal
depthwise conv, and the RG-LRU (real-gated linear recurrent unit)

    i_t = sigmoid(blockdiag(W_x) x_t)            (input gate)
    r_t = sigmoid(blockdiag(W_a) x_t)            (recurrence gate)
    log a_t = -c * softplus(Lambda) * r_t         (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

Prefill and training run the recurrence through ``ops.lru_scan`` (the
port's own kernel on the card, with ``lru_scan_bwd`` behind its gradient),
decode one step in plain tensor code.  State per layer:
{"h": (B, d_rnn) f32, "conv": (B, conv_width - 1, d_rnn)}.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

RG_C = 8.0


def rglru_init(keys: L.Keys, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    dr = cfg.rec_d_state or d
    h = cfg.n_heads
    bd = dr // h  # block-diagonal gate width
    ks = keys.split(7)
    return {
        "w_in": L.dense_init(ks[0], (d, dr), dtype),
        "w_gate": L.dense_init(ks[1], (d, dr), dtype),
        "w_out": L.dense_init(ks[2], (dr, d), dtype),
        "conv_k": L.dense_init(ks[3], (cfg.conv_width, dr), dtype, scale=0.5),
        "gx": L.dense_init(ks[4], (h, bd, bd), dtype),
        "ga": L.dense_init(ks[5], (h, bd, bd), dtype),
        # Lambda so that a ~ U(0.9, 0.999) at init; f32 in any model dtype
        "lam": ks[6].uniform((dr,), 2.5, 5.0),
    }


def _causal_conv(x, kernel, state):
    """Depthwise causal conv.  x (B, S, Dr), kernel (W, Dr), state (B, W-1,
    Dr) or None (zeros).  The W terms are summed in x's dtype from 0, in
    the reference's order."""
    W = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S + W - 1, Dr)
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1]] * kernel[i]
    return out, xp[:, -(W - 1):]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def rglru_apply(cfg: ArchConfig, params, x, *, mode: str, state=None):
    """x (B, S, D), the normalised block input.  Returns (out, new_state)."""
    B, S, D = x.shape
    dr = cfg.rec_d_state or D
    h = cfg.n_heads
    bd = dr // h
    f32 = torch.float32
    xin = x @ params["w_in"]
    gate = L.activation(x @ params["w_gate"], "gelu")

    conv_state = state["conv"] if state is not None else None
    xc, conv_new = _causal_conv(xin, params["conv_k"], conv_state)

    xh = xc.reshape(B, S, h, bd)
    i_t = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh, params["gx"])).reshape(B, S, dr)
    r_t = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh, params["ga"])).reshape(B, S, dr)
    log_a = -RG_C * _softplus(params["lam"]) * r_t.to(f32)
    a = torch.exp(log_a)
    # sqrt(1 - a^2), stably through expm1
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i_t.to(f32) * xc.to(f32))

    h0 = state["h"] if state is not None else torch.zeros((B, dr), dtype=f32, device=x.device)
    if mode == "decode":
        h_last = a[:, 0] * h0 + b[:, 0]
        y = h_last[:, None].to(x.dtype)
    else:
        y, h_last = ops.lru_scan(a.contiguous(), b.contiguous(), h0.contiguous())
        y = y.to(x.dtype)

    out = (y * gate) @ params["w_out"]
    new_state = None if mode == "train" else {"h": h_last, "conv": conv_new}
    return out, new_state


def rglru_state_shape(cfg: ArchConfig, batch: int, dtype):
    """One layer's state as tensors on the meta device."""
    dr = cfg.rec_d_state or cfg.d_model
    return {"h": torch.empty((batch, dr), dtype=torch.float32, device="meta"),
            "conv": torch.empty((batch, cfg.conv_width - 1, dr), dtype=dtype, device="meta")}


def rglru_state_spec():
    """Logical axes of ``rglru_state_shape``'s leaves (the sharding rules'
    input; the port runs on one card and only carries them)."""
    return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
