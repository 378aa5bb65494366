"""Common layer primitives: RMS norm, rotary embedding, dense MLPs."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32 and cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


# the Cephes polynomial XLA's CPU backend emits for float32 exp
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _fma32(a, b, c):
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, and the sum rounds once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def exp_f32(x) -> np.ndarray:
    """float32 exp with the bits of ``jnp.exp`` on XLA's CPU backend:
    n = floor(x log2(e) + 1/2), r = x - n ln 2 in two fused steps, the
    degree-5 polynomial in fused multiply-adds, times 2^n. ``torch.exp``
    and ``np.exp`` differ from it by an ulp on some inputs, and an ulp of
    a rotary frequency, times the position, grows along the sequence."""
    x = np.asarray(x, np.float32)
    n = np.floor(x * np.float32(1.44269504088896341) + np.float32(0.5))
    r = _fma32(n, np.float32(-0.693359375), x)
    r = _fma32(n, np.float32(2.12194440e-4), r)
    y = np.full_like(x, np.float32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = _fma32(y, r, np.float32(c))
    y = _fma32(y, r * r, r) + np.float32(1)
    return np.ldexp(y, n.astype(np.int32)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """[dim//2] rotary frequencies exp(-ln(theta) * 2i / dim), the
    reference's bits (``exp_f32``), computed once on the host per (dim,
    theta) and kept on each device they are asked for (read-only)."""
    arg = (np.float32(-math.log(theta))
           * np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim))
    return torch.from_numpy(exp_f32(arg)).to(device)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """[..., dim//2] rotary angles for integer positions: the float32
    product of each position and frequency, which rounds alike on every
    device, so the angles are the reference's bit for bit."""
    return positions.float()[..., None] * rope_freqs(dim, theta,
                                                     positions.device)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU written as ``jax.nn.gelu`` (its default,
    ``approximate=True``) is: x * (0.5 * (1 + tanh(c1 * (x + c2 * x^3))))
    with its constants rounded to the input dtype (0.796875 and
    0.044677734375 in bf16) and each op rounding in the input dtype, so
    bf16 results match the JAX model bit for bit (``F.gelu(approximate=
    "tanh")`` rounds once and differs on ~43% of bf16 inputs). In fp32 the
    two frameworks' ``tanh`` differ by an ulp on ~32% of inputs."""
    def const(c):
        return float(torch.tensor(c, dtype=x.dtype))
    cube = const(0.044715) * (x * x * x)
    inner = const(math.sqrt(2 / math.pi)) * (x + cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def sq_relu(x: torch.Tensor) -> torch.Tensor:
    """square(relu(x)), as the reference's ``sq_relu`` (exact in every
    dtype)."""
    return torch.square(torch.relu(x))


def activation(name: str):
    """The elementwise activation of a two-matrix MLP, for the configs'
    ``act`` values other than SwiGLU (built from its gate instead)."""
    acts = {"sq_relu": sq_relu, "gelu": gelu}
    if name not in acts:
        raise ValueError(f"activation {name!r}: the configs' two-matrix "
                         f"MLPs use {sorted(acts)}")
    return acts[name]


def init_dense_mlp(normal, d_model: int, d_ff: int, act: str,
                   dtype) -> dict:
    """Dense MLP weights with the JAX ``init_dense_mlp`` shapes and
    scales: (w_up, w_down), and w_gate for SwiGLU only;
    ``normal(shape, scale, dtype)`` draws each one."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    p = {"w_up": normal((d_model, d_ff), s_in, dtype),
         "w_down": normal((d_ff, d_model), s_out, dtype)}
    if act == "swiglu":
        p["w_gate"] = normal((d_model, d_ff), s_in, dtype)
    return p


def dense_mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Dense FFN: SwiGLU (silu(x @ w_gate) * (x @ w_up)) @ w_down, any
    other activation act(x @ w_up) @ w_down."""
    if cfg.act == "swiglu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activation(cfg.act)(x @ p["w_up"])
    return h @ p["w_down"]
