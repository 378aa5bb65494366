"""LM entry points: params, prefill, decode step, device-resident spans.

Params are a plain dict of tensors, ``{"embed": [V,D], "blocks": [...],
"final_norm": [D], "head": [D,V]}``, with the JAX package's ``[in, out]``
matrix layout. Decoding state is ``{"caches": [one entry per layer],
"lengths": [B] int32, "positions": [B] int32}`` on the device, plus
``"page_table": [B,MP] int32`` when the caches are shared page pools
(attention, the ``paged`` layout) rather than per-slot state (attention
slabs of the ``dense`` layout, Mamba's and RWKV's carries); decode
updates it in place.

Four families are served: plain attention with dense SwiGLU MLPs
(qwen3-8b), the same attention with MoE MLPs after ``first_dense`` dense
layers (moonshot-v1-16b-a3b), the Mamba + attention + MoE hybrid
(jamba-v0.1-52b), and pure RWKV-6 stacks (rwkv6-1.6b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import mamba, moe, rwkv
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_dense_mlp, rms_norm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else _DTYPES[cfg.dtype]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None) -> dict:
    """Random weights with the shapes and scales of the JAX
    ``lm.init_params``: normal draws from ``generator``, made on the
    generator's device and moved to ``device`` (``cuda`` unless given).
    Attention layers hold ``{"attn": ...}``, Mamba layers ``{"mamba":
    ...}`` (``dt_bias``, ``A_log`` and ``D_skip`` in fp32), RWKV layers
    ``{"rwkv": ...}``; attention and Mamba layers whose MLP kind is "moe"
    hold ``{"moe": ...}`` (an fp32 router, experts and shared experts),
    the others ``{"mlp": ...}``.
    The two frameworks' generators differ, so the numbers do too; the
    weight bridge (models/convert.py) carries JAX weights across."""
    tf.check_supported(cfg)
    device = resolve_device(device)
    dtype = param_dtype(cfg, dtype)
    d, V, hd, ff = cfg.d_model, cfg.vocab_size, cfg.head_dim, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale, dt=dtype):
        # scaled in place: at full width a MoE layer's expert tensor is
        # 369 MB (moonshot) or 1.88 GB (jamba), and no second copy of it
        # is ever alive
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dt)
        return x.mul_(scale).to(device)

    def uniform(shape, lo=0.0, hi=1.0):
        x = torch.rand(shape, generator=generator, device=generator.device)
        return x.mul_(hi - lo).add_(lo).to(device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    params = {"embed": normal((V, d), 0.02), "blocks": []}
    for kind, mlp_kind in zip(cfg.layer_kinds(), cfg.mlp_kinds()):
        block = {"norm1": ones(d), "norm2": ones(d)}
        if kind == "rwkv":
            block["rwkv"] = rwkv.init_rwkv(cfg, normal, uniform, dtype,
                                           device)
            params["blocks"].append(block)
            continue
        if kind == "mamba":
            block["mamba"] = mamba.init_mamba(cfg, normal, uniform, dtype,
                                              device)
        else:
            block["attn"] = {
                "wq": normal((d, H * hd), 1.0 / math.sqrt(d)),
                "wk": normal((d, KV * hd), 1.0 / math.sqrt(d)),
                "wv": normal((d, KV * hd), 1.0 / math.sqrt(d)),
                "wo": normal((H * hd, d), 1.0 / math.sqrt(H * hd))}
            if cfg.qkv_bias:
                block["attn"].update(bq=zeros(H * hd), bk=zeros(KV * hd),
                                     bv=zeros(KV * hd))
            if cfg.qk_norm:
                block["attn"].update(q_norm=ones(hd), k_norm=ones(hd))
        if mlp_kind == "moe":
            block["moe"] = moe.init_moe(cfg, normal, dtype)
        else:
            block["mlp"] = init_dense_mlp(normal, d, ff, dtype)
        params["blocks"].append(block)
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["head"] = normal((d, V), 1.0 / math.sqrt(d))
    return params


def embed(table, ids):
    """ids [...] -> [..., D]."""
    return table[ids.long()]


def head_logits(x, head_w):
    """x [B,D] -> logits [B,V]."""
    return x @ head_w


def _head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def prefill(params, tokens, cfg: ModelConfig,
            cache_len: Optional[int] = None):
    """Run `tokens` [B,S]; returns (last_logits [B,V], state). Attention
    layers' caches are K/V zero-padded to ``cache_len`` ([B, cache_len,
    KV, hd]); Mamba layers' the final carry {conv, ssm}; RWKV layers' the
    final carry {wkv, shift_tm, shift_cm}."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    ctx = {"mode": "prefill", "cache_len": cache_len or S}
    x, caches = tf.apply_stack(params, x, cfg, ctx, want_caches=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x[:, -1], _head_weight(params, cfg))
    dev = tokens.device
    state = {"caches": caches,
             "lengths": torch.full((B,), S, dtype=torch.int32, device=dev),
             "positions": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, state


def decode_step(params, tokens, state, cfg: ModelConfig, active=None):
    """One decode step. tokens: [B] int32. Returns (logits [B,V], state).
    The caches in ``state`` (page pools, or per-slot slabs and carries)
    are written in place, inactive slots left as they were; ``lengths`` and
    ``positions`` advance only where ``active`` (all slots if None)."""
    x = embed(params["embed"], tokens)
    ctx = {"mode": "decode", "positions": state["positions"],
           "lengths": state["lengths"], "active": active,
           "page_table": state.get("page_table")}
    x, caches = tf.apply_stack(params, x, cfg, ctx, caches=state["caches"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x, _head_weight(params, cfg))
    adv = 1 if active is None else active.to(torch.int32)
    new_state = {"caches": caches,
                 "lengths": state["lengths"] + adv,
                 "positions": state["positions"] + adv}
    if "page_table" in state:
        new_state["page_table"] = state["page_table"]
    return logits, new_state


def decode_span(params, tokens, state, cfg: ModelConfig, active, budgets, *,
                span: int, eos_token: int, cache_len: int, sample_fn=None):
    """Run ``span`` decode steps with no host read inside.

    The counterpart of the JAX ``lax.scan``: the stop conditions (the
    slot emitted ``eos_token``, spent its budget, or reached
    ``cache_len``) update an on-device ``active`` mask, finished slots
    keep running frozen (their pool writes dropped, their counters
    halted), and there is no early exit, so every span runs ``span``
    steps. ``sample_fn(logits, keys, params)`` selects each token on the
    device (None = argmax). Returns (toks [span,B] int32, emit [span,B]
    bool, state); emit[t,i] marks a real emission of slot i at step t.
    """
    toks, act, left = tokens, active, budgets
    out_t, out_e = [], []
    for _ in range(span):
        logits, state = decode_step(params, toks, state, cfg, active=act)
        nxt = select_token(logits, sample_fn)
        nxt = torch.where(act, nxt, toks)
        out_t.append(nxt)
        out_e.append(act)
        left = left - act.to(torch.int32)
        done = ((nxt == eos_token) | (left <= 0)
                | (state["positions"] >= cache_len))
        toks, act = nxt, act & ~done
    return torch.stack(out_t), torch.stack(out_e), state


def select_token(logits, sample_fn=None):
    """On-device token selection for a batch of logits: [B] int32. The
    sampler contract of ``decode_span``; greedy samplers take no keys and
    no parameters."""
    if sample_fn is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_fn(logits, None, ()).to(torch.int32)


def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=None, device=None) -> dict:
    """Fresh per-slot decoding state (the reference's ``filled=False``):
    every layer's state zeroed, lengths and positions 0."""
    tf.check_supported(cfg)
    device = resolve_device(device)
    dtype = param_dtype(cfg, dtype)
    i32 = dict(dtype=torch.int32, device=device)
    return {"caches": tf.init_stack_caches(cfg, batch, cache_len, dtype,
                                           device),
            "lengths": torch.zeros(batch, **i32),
            "positions": torch.zeros(batch, **i32)}


def init_paged_serve_state(cfg: ModelConfig, batch: int, n_pages: int,
                           page_size: int, max_pages: int, dtype=None,
                           device=None) -> dict:
    """Paged decoding state: shared per-layer page pools + per-slot table
    (rows rewritten by the engine as the PagePool allocates)."""
    tf.check_supported(cfg)
    if not tf.paged_stack_supported(cfg):
        kinds = sorted(set(cfg.layer_kinds()))
        raise ValueError(
            f"paged serving needs per-token cache blocks (plain attention "
            f"KV); {cfg.name} (layer kinds {kinds}) has none: use the "
            f"'dense' layout (per-slot slabs, every ported config) or the "
            f"'recurrent' layout (constant-size state for pure RWKV "
            f"configs)")
    device = resolve_device(device)
    dtype = param_dtype(cfg, dtype)
    i32 = dict(dtype=torch.int32, device=device)
    return {"caches": tf.init_paged_stack_caches(cfg, n_pages, page_size,
                                                 dtype, device),
            "lengths": torch.zeros(batch, **i32),
            "positions": torch.zeros(batch, **i32),
            "page_table": torch.zeros(batch, max_pages, **i32)}
