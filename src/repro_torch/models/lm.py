"""LM entry points: params, the training loss, prefill, decode step,
device-resident spans.

Params are a plain dict of tensors, ``{"embed": [V,D], "blocks": [...],
"final_norm": [D], "head": [D,V]}``, with the JAX package's ``[in, out]``
matrix layout. Decoding state is ``{"caches": [one entry per layer],
"lengths": [B] int32, "positions": [B] int32}`` on the device, plus
``"page_table": [B,MP] int32`` when the caches are shared page pools
(attention, the ``paged`` layout) rather than per-slot state (attention
slabs of the ``dense`` layout, Mamba's and RWKV's carries); decode
updates it in place.

``prefill_chunk`` extends dense caches by one prompt chunk (chunked
prefill, plain attention stacks). Every family of the registry is
served: plain attention with dense MLPs (SwiGLU, squared ReLU or GELU;
QKV biases, qk-norm and sliding-window ring caches as the config says:
qwen3-8b, qwen1.5-4b, nemotron-4-15b, h2o-danube-3-4b, chameleon-34b,
musicgen-large), the same attention with MoE MLPs after ``first_dense``
dense layers (moonshot-v1-16b-a3b), MLA attention with MoE MLPs
(deepseek-v2-lite-16b; latent caches, on per-slot slabs or shared
latent page pools), the Mamba + attention + MoE hybrid (jamba-v0.1-52b),
and pure RWKV-6 stacks (rwkv6-1.6b). ``decode_span``
and ``select_token`` pick tokens through a pluggable sampler with keys
derived on the device (kernels/sampling.py).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import sampling as ksamp
from repro_torch.models import mamba, mla, moe, rwkv
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_dense_mlp, rms_norm
from repro_torch.sharding.policy import NULL_POLICY, Policy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else _DTYPES[cfg.dtype]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None, tp: int = 1) -> dict:
    """Random weights with the shapes and scales of the JAX
    ``lm.init_params``: normal draws from ``generator``, made on the
    generator's device and moved to ``device`` (``cuda`` unless given).
    Attention layers hold ``{"attn": ...}`` (MLA's weights for an MLA
    config, ``models/mla.py``), Mamba layers ``{"mamba":
    ...}`` (``dt_bias``, ``A_log`` and ``D_skip`` in fp32), RWKV layers
    ``{"rwkv": ...}``; attention and Mamba layers whose MLP kind is "moe"
    hold ``{"moe": ...}`` (an fp32 router, experts and shared experts),
    the others ``{"mlp": ...}``.
    The two frameworks' generators differ, so the numbers do too; the
    weight bridge (models/convert.py) carries JAX weights across.
    Plain attention takes ``transformer.eff_heads(cfg, tp)`` heads, the
    reference's alignment to ``tp`` model ranks. On the ``meta`` device
    (``abstract_params``) no generator is read and no value is drawn."""
    device = resolve_device(device)
    dtype = param_dtype(cfg, dtype)
    d, V, hd, ff = cfg.d_model, cfg.vocab_size, cfg.head_dim, cfg.d_ff
    H, KV = tf.eff_heads(cfg, tp)
    meta = device.type == "meta"

    def normal(shape, scale, dt=dtype):
        if meta:
            return torch.empty(shape, dtype=dt, device=device)
        # scaled in place: at full width a MoE layer's expert tensor is
        # 369 MB (moonshot) or 1.88 GB (jamba), and no second copy of it
        # is ever alive
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dt)
        return x.mul_(scale).to(device)

    def uniform(shape, lo=0.0, hi=1.0):
        if meta:
            return torch.empty(shape, device=device)
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
        elif cfg.mla is not None:
            block["attn"] = mla.init_mla(cfg, normal, dtype, device)
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
            block["mlp"] = init_dense_mlp(normal, d, ff, cfg.act, dtype)
        params["blocks"].append(block)
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["head"] = normal((d, V), 1.0 / math.sqrt(d))
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes of every leaf of ``init_params``' tree."""
    s = {"embed": ("vocab", None), "blocks": tf.stack_specs(cfg),
         "final_norm": (None,)}
    if not cfg.tie_embeddings:
        s["head"] = (None, "vocab")
    return s


def abstract_params(cfg: ModelConfig, tp: int = 1) -> dict:
    """``init_params``' tree as ``meta`` tensors: shapes and dtypes, no
    memory."""
    return init_params(cfg, None, device="meta", tp=tp)


def embed(table, ids):
    """ids [...] -> [..., D]."""
    return table[ids.long()]


def head_logits(x, head_w, policy: Policy = NULL_POLICY):
    """x [B,D] -> logits [B,V] (vocab-sharded under a mesh)."""
    return policy.constrain(x @ head_w, "batch", "vocab")


def _head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# tokens of one cross-entropy chunk: at qwen3's vocab of 151936 its fp32
# logits take 622 MB, where a whole 4096-token row's would take 2.5 GB
CE_CHUNK = 1024


def _ce_rows(x, head_w, targets):
    """Per-token CE of rows x [N,D] against targets [N], in fp32 over the
    logits (the reference's ``_ce_from_logits``)."""
    logits = (x @ head_w).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[:, None].long())[:, 0]
    return lse - tgt


def ce_loss(x, head_w, targets, mask, chunk: int = CE_CHUNK):
    """Mean CE over masked tokens (the reference's ``chunked_ce_loss``
    without a mesh). x: [B,S,D]; targets, mask: [B,S]. The per-token
    values are formed ``chunk`` tokens at a time, each chunk under
    ``torch.utils.checkpoint`` when autograd records, so no more than one
    chunk's logits are alive; the mean is the reference's, over the whole
    [B,S] at once."""
    B, S, D = x.shape
    xf, tf_ = x.reshape(B * S, D), targets.reshape(B * S)
    parts = []
    for lo in range(0, B * S, chunk):
        args = (xf[lo:lo + chunk], head_w, tf_[lo:lo + chunk])
        if torch.is_grad_enabled():
            parts.append(torch.utils.checkpoint.checkpoint(
                _ce_rows, *args, use_reentrant=False))
        else:
            parts.append(_ce_rows(*args))
    per_tok = torch.cat(parts).reshape(B, S)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def forward_loss(params, tokens, cfg: ModelConfig, remat: bool = True, *,
                 policy: Policy = NULL_POLICY):
    """Next-token CE loss of tokens [B,S] (int32), the last position
    masked, plus ``router_aux_weight`` times the summed ``moe_aux`` for
    an MoE config, as the reference's. Returns (loss, metrics), metrics
    ``{"ce", "moe_aux", "moe_dropped"}`` (the router stats summed over
    the layers; zero for a stack without MoE). With ``remat`` each block
    after the reference's prefix is replayed in the backward
    (``transformer.apply_stack``). Every family trains: plain and MLA
    attention through B2 and B2-bwd, MoE through B7 and B7-bwd, Mamba
    through B6 and B6-bwd, RWKV-6 through B4 and B4-bwd. Every entry
    point takes a sharding ``policy`` and refuses one whose mesh has more
    than one rank."""
    policy.require_one_rank("lm.forward_loss")
    x = embed(params["embed"], tokens)
    ctx = {"mode": "train", "remat": remat}
    x, stats = tf.apply_stack(params, x, cfg, ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])],
                     dim=1).to(torch.float32)
    ce = ce_loss(x, _head_weight(params, cfg), targets, mask)
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * stats["moe_aux"]
    return loss, {"ce": ce, **stats}


def prefill(params, tokens, cfg: ModelConfig,
            cache_len: Optional[int] = None, *,
            policy: Policy = NULL_POLICY):
    """Run `tokens` [B,S]; returns (last_logits [B,V], state). Attention
    layers' caches are K/V zero-padded to ``cache_len`` ([B, cache_len,
    KV, hd]), or with a sliding window W the ring slab of ``min(W,
    cache_len)`` rows (``transformer.attn_forward``); Mamba layers' the
    final carry {conv, ssm}; RWKV layers' the final carry {wkv, shift_tm,
    shift_cm}."""
    policy.require_one_rank("lm.prefill")
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    ctx = {"mode": "prefill", "cache_len": cache_len or S}
    x, caches = tf.apply_stack(params, x, cfg, ctx, want_caches=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x[:, -1], _head_weight(params, cfg), policy)
    dev = tokens.device
    state = {"caches": caches,
             "lengths": torch.full((B,), S, dtype=torch.int32, device=dev),
             "positions": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, state


def prefill_chunk(params, tokens, caches, start: int, n_valid: int,
                  cfg: ModelConfig, *, policy: Policy = NULL_POLICY):
    """Chunked prefill: extend dense caches by one prompt chunk, IN PLACE.

    tokens: [B,C], the chunk at absolute positions start..start+C-1;
    ``caches`` is a dense cache list (attention leaves [B, cache_len, KV,
    hd]) holding positions [0, start). Tokens past ``n_valid`` are
    padding: their K/V lands past the valid length (masked by
    ``lengths`` downstream) and their outputs are never read. ``start``
    and ``n_valid`` are host ints, so no index is read back from the
    device. Returns (logits [B,V] at the last valid chunk token, the
    caches). Chaining chunks over a prompt gives ``prefill``'s logits."""
    policy.require_one_rank("lm.prefill_chunk")
    if not tf.chunked_prefill_supported(cfg):
        kinds = sorted(set(cfg.layer_kinds()))
        raise ValueError(
            f"chunked prefill needs per-token dense attention caches that "
            f"extend row-by-row; {cfg.name} (layer kinds {kinds}, "
            f"mla={cfg.mla is not None}, swa_window={cfg.swa_window}) "
            f"doesn't expose them — use monolithic prefill")
    if isinstance(start, torch.Tensor) or isinstance(n_valid, torch.Tensor):
        raise TypeError("prefill_chunk: start and n_valid are host ints; "
                        "a device tensor would be read back on every use")
    x = embed(params["embed"], tokens)
    ctx = {"mode": "prefill_chunk", "start": start}
    x, caches = tf.apply_stack(params, x, cfg, ctx, caches=caches)
    x = rms_norm(x[:, n_valid - 1], params["final_norm"], cfg.norm_eps)
    return head_logits(x, _head_weight(params, cfg), policy), caches


def decode_step(params, tokens, state, cfg: ModelConfig, active=None, *,
                policy: Policy = NULL_POLICY):
    """One decode step. tokens: [B] int32. Returns (logits [B,V], state).
    The caches in ``state`` (page pools, or per-slot slabs and carries)
    are written in place, inactive slots left as they were; ``lengths`` and
    ``positions`` advance only where ``active`` (all slots if None)."""
    policy.require_one_rank("lm.decode_step")
    x = embed(params["embed"], tokens)
    ctx = {"mode": "decode", "positions": state["positions"],
           "lengths": state["lengths"], "active": active,
           "page_table": state.get("page_table"), "policy": policy}
    x, caches = tf.apply_stack(params, x, cfg, ctx, caches=state["caches"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(x, _head_weight(params, cfg), policy)
    adv = 1 if active is None else active.to(torch.int32)
    new_state = {"caches": caches,
                 "lengths": state["lengths"] + adv,
                 "positions": state["positions"] + adv}
    if "page_table" in state:
        new_state["page_table"] = state["page_table"]
    return logits, new_state


def decode_span(params, tokens, state, cfg: ModelConfig, active, budgets, *,
                span: int, eos_token: int, cache_len: int, sample_fn=None,
                sampler_params=None, rng=None, want_logprobs: bool = False,
                policy: Policy = NULL_POLICY):
    """Run ``span`` decode steps with no host read inside.

    The counterpart of the JAX ``lax.scan``: the stop conditions (the
    slot emitted ``eos_token``, spent its budget, or reached
    ``cache_len``) update an on-device ``active`` mask, finished slots
    keep running frozen (their pool writes dropped, their counters
    halted), and there is no early exit, so every span runs ``span``
    steps. ``sample_fn(logits, keys, sampler_params)`` selects each token
    on the device (None = argmax). With ``rng = (seeds [B], req_ids [B],
    counters [B])`` each step's keys are ``derive_keys(seed, req_id,
    counter)`` and the counter advances only where a slot emits, so a
    slot's key stream depends on its ``(seed, req_id)`` and stream
    position alone, whatever the span, the batch or parking did.
    Returns (toks [span,B] int32, emit [span,B] bool, state), or with
    ``want_logprobs`` (toks, emit, logprobs [span,B] float32, state);
    emit[t,i] marks a real emission of slot i at step t.
    """
    policy.require_one_rank("lm.decode_span")
    toks, act, left = tokens, active, budgets
    ctr = rng[2] if rng is not None else None
    out_t, out_e, out_lp = [], [], []
    for _ in range(span):
        logits, state = decode_step(params, toks, state, cfg, active=act,
                                    policy=policy)
        step_rng = None if rng is None else (rng[0], rng[1], ctr)
        nxt, _ = select_token(logits, sample_fn, sampler_params, step_rng,
                              want_logprob=False)
        nxt = torch.where(act, nxt, toks)
        out_t.append(nxt)
        out_e.append(act)
        if want_logprobs:
            out_lp.append(ksamp.token_logprob(logits, nxt))
        step = act.to(torch.int32)
        left = left - step
        if ctr is not None:
            ctr = ctr + step
        done = ((nxt == eos_token) | (left <= 0)
                | (state["positions"] >= cache_len))
        toks, act = nxt, act & ~done
    if want_logprobs:
        return (torch.stack(out_t), torch.stack(out_e), torch.stack(out_lp),
                state)
    return torch.stack(out_t), torch.stack(out_e), state


def select_token(logits, sample_fn=None, sampler_params=None, rng=None,
                 want_logprob: bool = True):
    """On-device token selection for a batch of logits, the sampler
    contract of ``decode_span``: ``rng = (seeds, req_ids, indices)``
    gives each row its key (index 0 for a prefill's first token).
    Returns (tokens [B] int32, logprobs [B] float32 under the raw
    logits, or None without ``want_logprob``)."""
    if sample_fn is None:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        keys = ksamp.derive_keys(*rng) if rng is not None else None
        tok = sample_fn(logits, keys, sampler_params).to(torch.int32)
    return tok, (ksamp.token_logprob(logits, tok) if want_logprob else None)


def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=None, device=None) -> dict:
    """Fresh per-slot decoding state (the reference's ``filled=False``):
    every layer's state zeroed, lengths and positions 0."""
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
    (rows rewritten by the engine as the PagePool allocates). The pools
    are [n_pages, page_size, KV, hd] K and V (plain attention) or
    [n_pages, page_size, lora|rope] latent pools (MLA)."""
    device = resolve_device(device)
    dtype = param_dtype(cfg, dtype)
    if tf.paged_stack_supported(cfg):
        caches = tf.init_paged_stack_caches(cfg, n_pages, page_size, dtype,
                                            device)
    elif tf.latent_paged_stack_supported(cfg):
        caches = tf.init_latent_paged_stack_caches(cfg, n_pages, page_size,
                                                   dtype, device)
    else:
        # the reference's message: page indirection needs per-token cache
        # blocks, which SWA rings and recurrent (mamba/rwkv) carries
        # don't have
        kinds = sorted(set(cfg.layer_kinds()))
        raise ValueError(
            f"paged serving needs per-token cache blocks (plain attention "
            f"KV or an MLA latent cache, no SWA ring); {cfg.name} (layer "
            f"kinds {kinds}, swa_window={cfg.swa_window}) has none — use "
            f"the 'dense' layout (serves every config) or 'recurrent' "
            f"(constant-size state for pure RWKV/Mamba configs)")
    i32 = dict(dtype=torch.int32, device=device)
    return {"caches": caches,
            "lengths": torch.zeros(batch, **i32),
            "positions": torch.zeros(batch, **i32),
            "page_table": torch.zeros(batch, max_pages, **i32)}


def serve_state_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes of ``init_serve_state``'s tree."""
    return {"caches": tf.stack_cache_specs(cfg), "lengths": ("batch",),
            "positions": ("batch",)}
