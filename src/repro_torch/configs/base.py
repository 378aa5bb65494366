"""Model / run configuration schema.

The config layer is part of the JingZhao "Semantics Subsystem" boundary: a
``ModelConfig`` fully describes *What format* the model computes in, while the
Queue/Resource/Transport subsystems (runtime, KV cache, fault tolerance) are
config-independent. Every assigned architecture is a pure-data instance of
this schema — no architecture-specific runtime code paths outside models/.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    moe_layer_period: int = 1     # MoE every `period` layers (Jamba: 2)
    first_dense: int = 0          # first N layers use a dense MLP (DeepSeek style)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "swiglu"           # swiglu | sq_relu | gelu
    swa_window: int = 0           # 0 = full attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # Per-layer kind pattern, tiled to n_layers. None => all "attn".
    # Jamba: ("mamba","mamba","mamba","mamba","attn","mamba","mamba","mamba")
    layer_pattern: Optional[Tuple[str, ...]] = None
    attn_free: bool = False       # rwkv: no attention anywhere
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""              # provenance tag: [hf:... ] / [arXiv:...]

    # ---- derived -----------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete per-layer block kind, length n_layers."""
        if self.attn_free:
            return tuple("rwkv" for _ in range(self.n_layers))
        if self.layer_pattern is None:
            base = ("attn",)
        else:
            base = self.layer_pattern
        reps = -(-self.n_layers // len(base))
        return (base * reps)[: self.n_layers]

    def mlp_kinds(self) -> Tuple[str, ...]:
        """Per-layer MLP kind: "dense" or "moe"."""
        out = []
        for i in range(self.n_layers):
            if self.moe is None:
                out.append("dense")
            elif i < self.moe.first_dense:
                out.append("dense")
            elif (i - self.moe.first_dense) % self.moe.moe_layer_period == 0:
                out.append("moe")
            else:
                out.append("dense")
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        return _param_count(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qdim = cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
        q = d * qdim if m.q_lora_rank == 0 else d * m.q_lora_rank + m.q_lora_rank * qdim
        kv_a = d * (m.kv_lora_rank + m.qk_rope_dim)
        kv_b = m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        o = cfg.n_heads * m.v_head_dim * d
        return q + kv_a + kv_b + o
    hd = cfg.head_dim
    qkv = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    if cfg.qkv_bias:
        qkv += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return qkv + cfg.n_heads * hd * d


def _mamba_params(cfg: ModelConfig) -> int:
    m = cfg.mamba
    d = cfg.d_model
    di = m.expand * d
    dtr = m.resolved_dt_rank(d)
    return (d * 2 * di            # in_proj
            + di * m.d_conv       # depthwise conv
            + di * (dtr + 2 * m.d_state)  # x_proj
            + dtr * di + di       # dt_proj
            + di * m.d_state      # A_log
            + di                  # D
            + di * d)             # out_proj


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    # time-mix: r,k,v,g,o projections + decay/bonus + lora for data-dep decay
    tm = 5 * d * d + 2 * d + 2 * (d * 64 + 64 * d)
    # channel-mix: k (d->ff), v (ff->d), r (d->d)
    cm = d * cfg.d_ff + cfg.d_ff * d + d * d
    return tm + cm


def _mlp_params(cfg: ModelConfig, kind: str) -> Tuple[int, int]:
    """Returns (total, active) params for one MLP of given kind."""
    d = cfg.d_model
    if kind == "dense":
        mult = 3 if cfg.act == "swiglu" else 2
        n = mult * d * cfg.d_ff
        return n, n
    moe = cfg.moe
    mult = 3 if cfg.act == "swiglu" else 2
    per_expert = mult * d * moe.d_expert
    router = d * moe.n_experts
    total = moe.n_experts * per_expert + moe.n_shared * per_expert + router
    active = moe.top_k * per_expert + moe.n_shared * per_expert + router
    return total, active


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    n = 2 * cfg.vocab_size * d  # embed + head (untied)
    if cfg.tie_embeddings:
        n = cfg.vocab_size * d
    kinds = cfg.layer_kinds()
    mlps = cfg.mlp_kinds()
    for kind, mlp in zip(kinds, mlps):
        if kind == "attn":
            n += _attn_params(cfg)
        elif kind == "mamba":
            n += _mamba_params(cfg)
        elif kind == "rwkv":
            n += _rwkv_params(cfg)
        if kind != "rwkv":  # rwkv channel-mix counted inside _rwkv_params
            total, active = _mlp_params(cfg, mlp)
            n += active if active_only else total
        n += 2 * d  # norms
    n += d  # final norm
    return n
