"""Common layer primitives: RMS norm, rotary embedding, the SwiGLU MLP."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32 and cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """[..., dim//2] rotary angles for integer positions."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, dim, 2, dtype=torch.float32,
                       device=positions.device) / dim)
    return positions.float()[..., None] * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [..., S, n, d]; angles: [S, d//2] or [..., S, d//2].

    Half-split rotation (the first and second halves of the head dim pair
    up), not interleaved, computed in fp32 and cast back.
    """
    dtype = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    ang = angles.unsqueeze(-2)                # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), written as ``jax.nn.sigmoid`` computes it: each
    op rounds in the input dtype, so bf16 results match the JAX model bit
    for bit (``torch.sigmoid`` rounds once and differs by an ulp)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), written as ``jax.nn.silu`` is: each op rounds in
    the input dtype, so bf16 results match the JAX model bit for bit
    (the fused ``F.silu`` rounds once and differs by an ulp)."""
    return x * sigmoid(x)


def init_dense_mlp(normal, d_model: int, d_ff: int, dtype) -> dict:
    """SwiGLU weights with the JAX ``init_dense_mlp`` shapes and scales;
    ``normal(shape, scale, dtype)`` draws each one."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"w_up": normal((d_model, d_ff), s_in, dtype),
            "w_down": normal((d_ff, d_model), s_out, dtype),
            "w_gate": normal((d_model, d_ff), s_in, dtype)}


def dense_mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    if cfg.act != "swiglu":
        raise ValueError(f"activation {cfg.act!r} is not ported yet "
                         f"(ROADMAP queue A6); the port has swiglu only")
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
