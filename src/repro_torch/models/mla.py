"""Multi-head Latent Attention (DeepSeek-V2) with the absorbed decode path.

The JAX package's ``repro.models.mla``. Prefill expands the latent KV to
per-head K/V and attends with kernel B2 (``chunked_causal_attention``) at
q/k head dim ``qk_nope_dim + qk_rope_dim`` (192 in deepseek-v2-lite-16b)
and v head dim ``v_head_dim`` (128). Decode absorbs W^UK into the query
and attends in latent space over a cache of ``[kv_lora_rank +
qk_rope_dim]`` values per token. The reference writes that decode in
plain jnp, with no Pallas kernel, so the port writes it in plain
PyTorch, step for step with its casts: fp32 scores over the latent and
rope caches, the mask ``arange < max(lengths, positions + 1)``, an fp32
softmax, the probabilities cast to the cache dtype before the latent
sum accumulated in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import NEG_INF, chunked_causal_attention
from repro_torch.models.layers import apply_rope, rms_norm, rope_angles


def init_mla(cfg: ModelConfig, normal, dtype, device) -> dict:
    """One MLA block's params with the JAX ``init_mla`` shapes and scales
    (``wq`` [D, H (nope + rope)], ``wkv_a`` [D, lora + rope], ``kv_norm``
    [lora] of ones, ``wkv_b`` [lora, H (nope + v)], ``wo`` [H v, D]);
    ``normal(shape, scale, dtype)`` draws each matrix."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qdim = m.qk_nope_dim + m.qk_rope_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": normal((d, H * qdim), s, dtype),
        "wkv_a": normal((d, m.kv_lora_rank + m.qk_rope_dim), s, dtype),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=dtype, device=device),
        "wkv_b": normal((m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)),
                        1.0 / math.sqrt(m.kv_lora_rank), dtype),
        "wo": normal((H * m.v_head_dim, d),
                     1.0 / math.sqrt(H * m.v_head_dim), dtype),
    }


def mla_prefill(x, p, cfg: ModelConfig, angles, want_cache: bool = False):
    """x: [B,S,D]; angles [S, rope/2]. Returns (out [B,S,D], cache|None),
    cache = {c_kv [B,S,lora], k_rope [B,S,rope]}."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q = (x @ p["wq"]).reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], angles)
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, m.kv_lora_rank:], angles)  # [B,S,1,r]
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    out = chunked_causal_attention(q, k, v, scale=scale)
    out = out.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    cache = ({"c_kv": c_kv, "k_rope": k_rope[..., 0, :]} if want_cache
             else None)
    return out, cache


def mla_decode(x, p, cfg: ModelConfig, cache, positions, lengths):
    """One token per slot, absorbed. x: [B,D]; cache {c_kv [B,Smax,lora],
    k_rope [B,Smax,rope]}; positions, lengths [B]. The new token's latent
    row is written into ``cache`` IN PLACE at ``positions`` (a position
    past Smax writes nothing, as the reference's scatter drops it); then
    each slot attends over ``arange(Smax) < max(lengths, positions + 1)``.
    Returns out [B,D]."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    Smax = c_cache.shape[1]
    ang = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)  # [B, r/2]
    q = (x @ p["wq"]).reshape(B, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[:, None, :, m.qk_nope_dim:], ang[:, None])[:, 0]
    kv_a = x @ p["wkv_a"]
    c_new = rms_norm(kv_a[:, :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    r_new = apply_rope(kv_a[:, None, None, m.kv_lora_rank:],
                       ang[:, None])[:, 0, 0]
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(positions, max=Smax - 1).long()
    in_range = (positions < Smax)[:, None]
    for buf, new in ((c_cache, c_new), (r_cache, r_new)):
        buf.index_put_((rows, slot), torch.where(
            in_range, new.to(buf.dtype), buf[rows, slot]))
    lengths = torch.maximum(lengths, positions + 1)
    # absorb W^UK into q: q_lat[b,h,l] = sum_n q_nope[b,h,n] w_k[l,h,n]
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H,
                               m.qk_nope_dim + m.v_head_dim)
    w_k, w_v = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope, w_k)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    c32 = c_cache.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat.float(), c32)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                        r_cache.float())) * scale
    valid = torch.arange(Smax, device=x.device)[None] < lengths[:, None]
    s = torch.where(valid[:, None], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", prob.to(c_cache.dtype).float(), c32)
    out = torch.einsum("bhl,lhv->bhv", o_lat.to(x.dtype), w_v)
    return out.reshape(B, H * m.v_head_dim) @ p["wo"]
