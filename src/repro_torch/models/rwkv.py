"""RWKV-6 (Finch) block: time-mix and channel-mix, prefill and decode.

The JAX model's math (``repro.models.rwkv``) with the WKV recurrence on
the port's kernels: prefill runs the chunked scan through kernel B4
(``kernels.wkv6.wkv6_chunked``) where the JAX model calls its jnp
``wkv_chunked``, and decode runs one token through kernel B3
(``kernels.wkv6.wkv6_decode``) where it has the einsums. The token shift
is a static per-channel lerp and the decay is data-dependent through a
LoRA, its log-rate clamped to (-8, 0.5) so the chunked factorisation
stays inside fp32.

The activations round bf16 where the JAX model does: mixing of a bf16
activation with an fp32 ``mu`` promotes to fp32 and casts back, and
sigmoid and silu round each op (``layers.sigmoid``, ``layers.silu``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6_chunked, wkv6_decode
from repro_torch.models.layers import sigmoid, silu

DECAY_LORA = 64
WKV_CHUNK = 32
_CLAMP_LO, _CLAMP_HI = -8.0, 0.5


def init_rwkv(cfg: ModelConfig, normal, uniform, dtype, device) -> dict:
    """One block's params with the JAX ``init_rwkv`` shapes, dtypes and
    scales. ``normal(shape, scale, dtype)`` and ``uniform(shape)`` draw
    the random leaves; ``mu``, ``w_base``, ``u``, ``ln_x`` and ``mu_cm``
    are fp32 whatever the model dtype."""
    d, ff = cfg.d_model, cfg.d_ff
    f32 = torch.float32
    s = 1.0 / math.sqrt(d)
    return {
        # time-mix
        "mu": uniform((5, d)),                       # r, k, v, g, w
        "w_base": torch.full((d,), -0.5, dtype=f32, device=device),
        "w1": normal((d, DECAY_LORA), s, dtype),
        "w2": normal((DECAY_LORA, d), 0.02, dtype),
        "wr": normal((d, d), s, dtype),
        "wk": normal((d, d), s, dtype),
        "wv": normal((d, d), s, dtype),
        "wg": normal((d, d), s, dtype),
        "wo": normal((d, d), s, dtype),
        "u": normal((d,), 0.1, f32),
        "ln_x": torch.ones(d, dtype=f32, device=device),
        # channel-mix
        "mu_cm": uniform((2, d)),                    # k, r
        "wk_cm": normal((d, ff), s, dtype),
        "wv_cm": normal((ff, d), 1.0 / math.sqrt(ff), dtype),
        "wr_cm": normal((d, d), s, dtype),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / ``prev`` at t = 0). x: [B,S,D]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    elif prev.dim() == 2:
        prev = prev[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _heads(x, hd):
    B, S, D = x.shape
    return x.reshape(B, S, D // hd, hd)


def _group_norm(y, scale, eps):
    """Per-head RMS norm in fp32; y: [B,S,H,hd] -> [B,S,H*hd]."""
    yf = y.float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    out = yf * torch.rsqrt(var + eps)
    B, S, H, hd = y.shape
    return out.reshape(B, S, H * hd) * scale[None, None]


def _mix(x, xs, mu):
    """x + mu * (xs - x), promoted to fp32 by ``mu`` and cast back."""
    return (x + mu * (xs - x)).to(x.dtype)


def _log_decay(xw, p):
    """The clamped data-dependent log-decay, fp32 (< 0)."""
    decay_in = p["w_base"] + torch.tanh(xw @ p["w1"]) @ p["w2"]
    return -torch.exp(torch.clamp(decay_in.float(), _CLAMP_LO, _CLAMP_HI))


def _wkv_chunk_inputs(x, p, cfg: ModelConfig, prev_tok):
    """Shared projections of time-mix: r, k, v [B,S,H,hd], g [B,S,D] and
    logw [B,S,H,hd]."""
    hd = cfg.rwkv.head_dim
    xs = _shift(x, prev_tok)
    mu = p["mu"]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))
    r = _heads(xr @ p["wr"], hd)
    k = _heads(xk @ p["wk"], hd)
    v = _heads(xv @ p["wv"], hd)
    g = xg @ p["wg"]
    return r, k, v, g, _heads(_log_decay(xw, p), hd)


def rwkv_time_mix(x, p, cfg: ModelConfig, state: Optional[dict] = None,
                  want_state: bool = False):
    """Prefill time-mix over x [B,S,D], the WKV scan on kernel B4.
    Returns (out [B,S,D], {"wkv", "shift_tm"} or None)."""
    hd = cfg.rwkv.head_dim
    prev_tok = state["shift_tm"] if state is not None else None
    r, k, v, g, logw = _wkv_chunk_inputs(x, p, cfg, prev_tok)
    B, _, H, _ = r.shape
    u = p["u"].reshape(H, hd)
    s0 = (state["wkv"] if state is not None
          else torch.zeros(B, H, hd, hd, dtype=torch.float32,
                           device=x.device))
    y, s_last = wkv6_chunked(r, k, v, logw, u, s0, chunk=WKV_CHUNK)
    y = _group_norm(y, p["ln_x"], cfg.norm_eps)
    out = (y.to(x.dtype) * silu(g)) @ p["wo"]
    new_state = None
    if want_state:
        new_state = {"wkv": s_last, "shift_tm": x[:, -1]}
    return out, new_state


def rwkv_channel_mix(x, p, cfg: ModelConfig, state: Optional[dict] = None,
                     want_state: bool = False):
    """Prefill channel-mix: sigmoid(r) * (relu(k)^2 @ wv)."""
    prev = state["shift_cm"] if state is not None else None
    xs = _shift(x, prev)
    xk = _mix(x, xs, p["mu_cm"][0])
    xr = _mix(x, xs, p["mu_cm"][1])
    kk = torch.square(torch.relu(xk @ p["wk_cm"]))
    out = sigmoid(xr @ p["wr_cm"]) * (kk @ p["wv_cm"])
    new_state = {"shift_cm": x[:, -1]} if want_state else None
    return out, new_state


def rwkv_time_mix_decode(x, p, cfg: ModelConfig, state: dict):
    """One token x [B,D] through time-mix, the recurrence on kernel B3.
    Returns (out [B,D], {"wkv": new state, "shift_tm": x})."""
    hd = cfg.rwkv.head_dim
    B, D = x.shape
    H = D // hd
    xs = state["shift_tm"]
    mu = p["mu"]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))
    r = (xr @ p["wr"]).reshape(B, H, hd).float()
    k = (xk @ p["wk"]).reshape(B, H, hd).float()
    v = (xv @ p["wv"]).reshape(B, H, hd).float()
    g = xg @ p["wg"]
    w = torch.exp(_log_decay(xw, p)).reshape(B, H, hd)
    u = p["u"].reshape(H, hd)
    y, s_new = wkv6_decode(r, k, v, w, u, state["wkv"])
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps)).reshape(B, D) * p["ln_x"]
    out = (y.to(x.dtype) * silu(g)) @ p["wo"]
    return out, {"wkv": s_new, "shift_tm": x}


def rwkv_channel_mix_decode(x, p, cfg: ModelConfig, state: dict):
    xs = state["shift_cm"]
    xk = _mix(x, xs, p["mu_cm"][0])
    xr = _mix(x, xs, p["mu_cm"][1])
    kk = torch.square(torch.relu(xk @ p["wk_cm"]))
    out = sigmoid(xr @ p["wr_cm"]) * (kk @ p["wv_cm"])
    return out, {"shift_cm": x}
