"""Block assembly: attention, Mamba and RWKV-6 stacks.

The JAX model stacks its repeating unit of blocks with a grouped
``lax.scan`` (params and caches carry a leading group axis). PyTorch runs
eagerly, so the port holds one block per layer, in layer order: a params
dict ``{"blocks": [block, ...]}`` and a cache list with one entry per
layer. ``plan_layers`` is kept to read the reference's grouped layout
(models/convert.py). The port serves every family of the reference:
plain attention layers with dense MLPs (SwiGLU, squared ReLU or GELU),
the same layers with MoE MLPs (``models/moe.py``; layers before
``first_dense`` keep a dense MLP), MLA attention layers
(``models/mla.py``) with the same MLPs, hybrids that interleave plain
attention layers with Mamba layers (``models/mamba.py``, jamba), and
pure RWKV-6 stacks (time- and channel-mix, no MLP).

Attention decodes through a shared page pool (``paged`` layout) when the
decode state carries a page table, else against per-slot slabs
``[B, cache_len, KV, hd]`` (``dense`` layout). With a sliding window W
the slab is a ring of ``min(W, cache_len)`` rows, slot ``t % W`` holding
token t, so the window is implicit in what the slab holds; such stacks
serve on ``dense`` only, monolithically (``paged_stack_supported``,
``chunked_prefill_supported``). MLA layers cache the latent ``{c_kv,
k_rope}`` rows of each token: per-slot slabs on ``dense``, or shared
latent page pools behind the page table (the ``latent`` layout,
``latent_paged_stack_supported``), monolithically. Mamba and RWKV layers
carry constant-size per-slot state. The ``prefill_chunk`` mode extends a
dense cache by one prompt chunk (chunked prefill): plain attention
stacks only (``chunked_prefill_supported``); the engine stages a paged
slot's pages as such a cache (``pages_to_dense``).

MoE layers return the router's stats (``moe_aux``, ``moe_dropped``);
serving has no loss to add them to and drops them unread, so no value
crosses to the host. The ``train`` mode sums them over the layers, as
the reference's ``apply_stack`` does, for the loss.

Cache tensors are updated IN PLACE (paged and dense decode appends,
prefill inserts, unpark restores, Mamba and RWKV decode commit their new
carry): JAX returns new caches that XLA updates in place under jit, while
eager torch would copy every cache on every step.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import paged_append
from repro_torch.models import mamba, mla, moe, rwkv
from repro_torch.models.attention import (chunk_prefix_attention,
                                          chunked_causal_attention,
                                          decode_attention,
                                          paged_decode_attention)
from repro_torch.models.layers import (apply_rope, dense_mlp, mlp_specs,
                                       rms_norm, rope_angles)
from repro_torch.sharding.policy import NULL_POLICY


def plan_layers(cfg: ModelConfig) -> Tuple[List, List, int]:
    """Return (prefix pairs, unit pairs, n_groups) of (kind, mlp_kind),
    the grouping of the JAX stack's params and caches."""
    pairs = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    for prefix in (0, 1, 2):
        rest = pairs[prefix:]
        if not rest:
            continue
        for p in (1, 2, 4, 8):
            if len(rest) % p:
                continue
            unit = rest[:p]
            if all(rest[i] == unit[i % p] for i in range(len(rest))):
                return pairs[:prefix], unit, len(rest) // p
    return pairs, [], 0


def paged_stack_supported(cfg: ModelConfig) -> bool:
    """Paged KV needs every layer to be plain (non-MLA, non-SWA)
    attention."""
    return (all(k == "attn" for k in cfg.layer_kinds())
            and cfg.mla is None and cfg.swa_window == 0)


def latent_paged_stack_supported(cfg: ModelConfig) -> bool:
    """Latent pages need every layer to be MLA attention (no SWA
    ring)."""
    return (all(k == "attn" for k in cfg.layer_kinds())
            and cfg.mla is not None and cfg.swa_window == 0)


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked prefill (and the block prefix cache built on it) extends
    per-token attention rows: the same gate as the paged layout."""
    return paged_stack_supported(cfg)


def recurrent_state_supported(cfg: ModelConfig) -> bool:
    """Constant-size slot state needs every mixer to carry a recurrence
    (RWKV/Mamba): any attention layer grows per token."""
    kinds = set(cfg.layer_kinds())
    return bool(kinds) and kinds <= {"mamba", "rwkv"}


# --------------------------------------------------------------------------
# attention block
# --------------------------------------------------------------------------

def eff_heads(cfg: ModelConfig, tp: int = 1) -> Tuple[int, int]:
    """(H_eff, KV_eff) after aligning the heads to ``tp`` model ranks, as
    the reference's: with fewer KV heads than ``tp`` and ``tp`` a
    multiple of them, KV heads are duplicated (Megatron's convention);
    heads that do not divide ``tp`` are padded up to a multiple, and
    KV_eff becomes H_eff where the grouping would not stay integral."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if tp <= 1:
        return H, KV
    H_eff = -(-H // tp) * tp
    if KV < tp and tp % KV == 0 and H_eff == H:
        KV_eff = tp
    else:
        KV_eff = -(-KV // tp) * tp
    if H_eff % KV_eff:
        KV_eff = H_eff
    return H_eff, KV_eff


def attn_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes of a plain attention layer's leaves."""
    s = {"wq": (None, "heads"), "wk": (None, "kv_heads"),
         "wv": (None, "kv_heads"), "wo": ("heads", None)}
    if cfg.qkv_bias:
        s.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        s.update(q_norm=(None,), k_norm=(None,))
    return s


def block_specs(cfg: ModelConfig, kind: str, mlp_kind: str) -> dict:
    """Logical sharding axes of one block's leaves."""
    s: Dict = {"norm1": (None,), "norm2": (None,)}
    if kind == "attn":
        s["attn"] = (mla.mla_specs(cfg) if cfg.mla is not None
                     else attn_specs(cfg))
    elif kind == "mamba":
        s["mamba"] = mamba.mamba_specs(cfg)
    elif kind == "rwkv":
        s["rwkv"] = rwkv.rwkv_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind != "rwkv":
        s["mlp" if mlp_kind == "dense" else "moe"] = (
            mlp_specs(cfg) if mlp_kind == "dense" else moe.moe_specs(cfg))
    return s


def stack_specs(cfg: ModelConfig) -> List[dict]:
    """``block_specs`` of every layer, in layer order (the reference's
    ``stack_specs`` without the group axis its stacked leaves carry)."""
    return [block_specs(cfg, kind, mlp)
            for kind, mlp in zip(cfg.layer_kinds(), cfg.mlp_kinds())]


def _qkv(x, p, cfg: ModelConfig):
    """x: [..., D] -> q [..., H, hd], k/v [..., KV, hd] (normed, no rope)."""
    hd = cfg.head_dim
    H = p["wq"].shape[1] // hd
    KV = p["wk"].shape[1] // hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*x.shape[:-1], H, hd)
    k = k.reshape(*x.shape[:-1], KV, hd)
    v = v.reshape(*x.shape[:-1], KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_forward(x, p, cfg: ModelConfig, ctx, want_cache: bool = False):
    """Prefill attention. x: [B,S,D]. The cache, when wanted, is K/V
    zero-padded to ``ctx["cache_len"]`` ([B, cache_len, KV, hd]). With a
    sliding window W it is the ring slab ``init_block_cache`` gives the
    layer, ``min(W, cache_len)`` rows, slot ``t % W`` holding token t: for
    S >= W the last W rows rolled by ``S % W`` (the reference's ring); for
    S < W the rows zero-padded to the slab's length. The reference pads
    those to ``cache_len`` instead, a cache its own dense slab cannot take
    when ``cache_len > W`` (ROADMAP C3)."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    angles = rope_angles(torch.arange(S, device=x.device), cfg.head_dim,
                         cfg.rope_theta)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    out = chunked_causal_attention(q, k, v, window=cfg.swa_window)
    out = out.reshape(B, S, -1) @ p["wo"]
    cache = None
    if want_cache:
        W = cfg.swa_window
        if W and S >= W:
            cache = {"k": torch.roll(k[:, -W:], S % W, dims=1),
                     "v": torch.roll(v[:, -W:], S % W, dims=1)}
        else:
            pad = slab_len(cfg, ctx.get("cache_len", S)) - S
            cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                     "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return out, cache


def mla_forward(x, p, cfg: ModelConfig, ctx, want_cache: bool = False):
    """MLA prefill. x: [B,S,D]. The cache, when wanted, is the latent
    {c_kv, k_rope} rows zero-padded to ``ctx["cache_len"]``."""
    S = x.shape[1]
    angles = rope_angles(torch.arange(S, device=x.device),
                         cfg.mla.qk_rope_dim, cfg.rope_theta)
    out, cache = mla.mla_prefill(x, p, cfg, angles, want_cache=want_cache)
    if cache is not None:
        pad = ctx.get("cache_len", S) - S
        cache = {n: torch.nn.functional.pad(t, (0, 0, 0, max(pad, 0)))
                 for n, t in cache.items()}
    return out, cache


def attn_prefill_chunk(x, p, cfg: ModelConfig, ctx, cache):
    """Chunked prefill: extend a dense cache by one prompt chunk. x:
    [B,C,D], the chunk's tokens at absolute positions start..start+C-1
    (``ctx["start"]``, a host int); cache {k,v: [B,L,KV,hd]} holds
    positions [0, start). The chunk's K/V is written IN PLACE at its
    positions, rows past L dropped (the padding of a tail chunk that
    straddles cache_len), as the reference's scatter with mode="drop":
    host-int slice bounds do that with no device read, and never shift
    the write back over valid rows as a clamped fixed-width slice would.
    Attention then runs causally over absolute positions against rows
    [0, start + C) of the cache; every later row is masked for every
    chunk row."""
    B, C, _ = x.shape
    start = ctx["start"]
    q, k_new, v_new = _qkv(x, p, cfg)
    pos = start + torch.arange(C, device=x.device)
    ang = rope_angles(pos, cfg.head_dim, cfg.rope_theta)       # [C, hd/2]
    q = apply_rope(q, ang)
    k_new = apply_rope(k_new, ang)
    end = min(start + C, cache["k"].shape[1])
    for n, val in (("k", k_new), ("v", v_new)):
        cache[n][:, start:end] = val[:, :end - start].to(cache[n].dtype)
    out = chunk_prefix_attention(q, cache["k"][:, :end],
                                 cache["v"][:, :end], pos)
    return out.reshape(B, C, -1) @ p["wo"], cache


def attn_decode_paged(x, p, cfg: ModelConfig, ctx, cache):
    """Paged decode. x: [B,D]; cache {k,v: [NP,page,KV,hd]} is the pool
    shared by every slot; ctx carries positions/lengths [B], page_table
    [B,MP] and the optional ``active`` mask. The new token's K/V is
    written into its page in place (inactive slots' writes dropped), then
    attention reads through the table over ``lengths + 1`` positions."""
    positions, lengths = ctx["positions"], ctx["lengths"]
    table = ctx["page_table"]
    q, k_new, v_new = _qkv(x, p, cfg)                  # [B,H,hd],[B,KV,hd]
    ang = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q[:, None], ang[:, None])[:, 0]
    k_new = apply_rope(k_new[:, None], ang[:, None])[:, 0]
    paged_append(cache["k"], cache["v"], k_new, v_new, table, positions,
                 active=ctx.get("active"))
    policy = ctx.get("policy", NULL_POLICY)
    q = policy.constrain(q, "batch", "heads", None)
    k_pages = policy.constrain(cache["k"], "pages", None, "kv_heads", None)
    v_pages = policy.constrain(cache["v"], "pages", None, "kv_heads", None)
    out = paged_decode_attention(q.contiguous(), table, k_pages, v_pages,
                                 lengths + 1)
    return out.reshape(x.shape[0], -1) @ p["wo"], cache


def attn_decode(x, p, cfg: ModelConfig, ctx, cache):
    """Dense decode. x: [B,D]; cache {k,v: [B,Smax,KV,hd]} holds one slab
    per slot; ctx carries positions/lengths [B] and the optional
    ``active`` mask. The new token's K/V goes into the slab IN PLACE at
    ``min(positions, Smax - 1)``, or at ``positions % Smax`` in a
    sliding-window ring, and attention reads ``min(lengths + 1, Smax)``
    entries, as the reference's ``attn_decode``: once the ring is full
    it holds exactly the window's tokens. Every slot attends with its new
    row in place, as there; then the rows of inactive slots get their old
    values back, so a frozen slot's slab is left as it was (the
    reference's freeze). The row indices are 1-d device tensors: nothing
    is read back."""
    B = x.shape[0]
    positions, lengths = ctx["positions"], ctx["lengths"]
    q, k_new, v_new = _qkv(x, p, cfg)                  # [B,H,hd],[B,KV,hd]
    ang = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q[:, None], ang[:, None])[:, 0]
    k_new = apply_rope(k_new[:, None], ang[:, None])[:, 0]
    Smax = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = (positions % Smax if cfg.swa_window
            else torch.clamp(positions, max=Smax - 1)).long()
    active = ctx.get("active")
    new = {"k": k_new, "v": v_new}
    old = ({n: cache[n][rows, slot] for n in new} if active is not None
           else None)
    for n, val in new.items():
        cache[n].index_put_((rows, slot), val.to(cache[n].dtype))
    policy = ctx.get("policy", NULL_POLICY)
    out = decode_attention(
        policy.constrain(q, "batch", "heads", None),
        policy.constrain(cache["k"], "batch", "kv_seq", "kv_heads", None),
        policy.constrain(cache["v"], "batch", "kv_seq", "kv_heads", None),
        torch.clamp(lengths + 1, max=Smax))
    if active is not None:
        keep = active[:, None, None]
        for n, val in new.items():
            cache[n].index_put_((rows, slot), torch.where(
                keep, val.to(cache[n].dtype), old[n]))
    return out.reshape(B, -1) @ p["wo"], cache


def mla_decode_dense(x, p, cfg: ModelConfig, ctx, cache):
    """MLA decode against per-slot latent slabs (the reference's
    ``_mla_decode_wrap``). x: [B,D]; cache {c_kv: [B,Smax,lora], k_rope:
    [B,Smax,rope]}. ``mla.mla_decode`` writes the new rows in place and
    attends over ``min(lengths + 1, Smax)`` entries (with the new row);
    then the rows of inactive slots get their old values back (the
    reference's freeze)."""
    positions = ctx["positions"]
    Smax = cache["c_kv"].shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    slot = torch.clamp(positions, max=Smax - 1).long()
    active = ctx.get("active")
    old = ({n: t[rows, slot] for n, t in cache.items()}
           if active is not None else None)
    out = mla.mla_decode(x, p, cfg, cache, positions,
                         torch.clamp(ctx["lengths"] + 1, max=Smax))
    if active is not None:
        for n, t in cache.items():
            t.index_put_((rows, slot), torch.where(active[:, None],
                                                   t[rows, slot], old[n]))
    return out, cache


def mla_decode_paged(x, p, cfg: ModelConfig, ctx, cache):
    """MLA decode against shared latent pages (the ``latent`` layout; the
    reference's ``_mla_decode_paged``). cache {c_kv: [NP,page,lora],
    k_rope: [NP,page,rope]} is the pool shared by every slot; ctx carries
    positions/lengths [B], page_table [B,MP] and the optional ``active``
    mask. Each slot's latent rows are gathered through the table into
    token order (a copy), the absorbed math runs on that dense view as on
    the dense layout, and only the new token's row goes back into its
    page, inactive slots' writes dropped (``paged_append``)."""
    table = ctx["page_table"]
    positions = ctx["positions"]
    B, MP = table.shape
    L = MP * cache["c_kv"].shape[1]
    view = {n: t[table.long()].reshape(B, L, t.shape[-1])
            for n, t in cache.items()}
    out = mla.mla_decode(x, p, cfg, view, positions,
                         torch.clamp(ctx["lengths"] + 1, max=L))
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(positions, max=L - 1).long()
    paged_append(cache["c_kv"], cache["k_rope"], view["c_kv"][rows, slot],
                 view["k_rope"][rows, slot], table, positions,
                 active=ctx.get("active"))
    return out, cache


def commit_slots(cache, new, active=None):
    """Write a decode step's new per-slot state into ``cache`` IN PLACE.
    Slots where ``active`` is False (parked, finished or free) keep their
    carry bit for bit. All on the device, a ``where`` and a ``copy_``:
    selecting the active rows on the host would read the device."""
    for key, old in cache.items():
        val = new[key].to(old.dtype)
        if active is not None:
            a = active.reshape((-1,) + (1,) * (old.dim() - 1))
            val = torch.where(a, val, old)
        old.copy_(val)
    return cache


def _rwkv_block(p, x, cfg: ModelConfig, ctx, cache, want_cache: bool):
    """norm1 -> time-mix -> residual -> norm2 -> channel-mix -> residual
    (no MLP). Decode commits the new carry into ``cache`` in place."""
    decode = ctx["mode"] == "decode"
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if decode:
        a, tm = rwkv.rwkv_time_mix_decode(h, p["rwkv"], cfg, cache)
    else:
        a, tm = rwkv.rwkv_time_mix(h, p["rwkv"], cfg, state=cache,
                                   want_state=want_cache)
    x = x + a
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if decode:
        m, cm = rwkv.rwkv_channel_mix_decode(h2, p["rwkv"], cfg, cache)
    else:
        m, cm = rwkv.rwkv_channel_mix(h2, p["rwkv"], cfg, state=cache,
                                      want_state=want_cache)
    new_cache = {**tm, **cm} if tm is not None else None
    if decode:
        new_cache = commit_slots(cache, new_cache, ctx.get("active"))
    return x + m, new_cache


def _moe_block_mlp(h2, p, cfg: ModelConfig, decode: bool, stats=None):
    """The MoE MLP as the reference's ``apply_block`` calls it: decode
    tokens [B,D] form one group with capacity factor 2.0, prefill runs
    one group per sequence at the config's factor (a prefill chunk one
    group of its C tokens, padding rows included, as there). The stats
    go into ``stats`` when it is a dict, else they are dropped."""
    if decode:
        out, _ = moe.moe_mlp(h2[None], p, cfg, capacity_factor=2.0)
        return out[0]
    out, st = moe.moe_mlp(h2, p, cfg)
    if stats is not None:
        stats.update(st)
    return out


def _mixer(h, kind: str, p, cfg: ModelConfig, ctx, cache,
           want_cache: bool):
    """The attention or Mamba mixer of one layer. Decode writes its new
    state into ``cache`` in place: attention into the page pool (a page
    table in ``ctx``) or the slot's slab, Mamba through
    ``commit_slots`` under the active mask. A prefill chunk extends the
    attention cache in place (``attn_prefill_chunk``)."""
    if ctx["mode"] == "prefill_chunk":
        return attn_prefill_chunk(h, p["attn"], cfg, ctx, cache)
    if ctx["mode"] != "decode":
        if kind == "mamba":
            return mamba.mamba_forward(h, p["mamba"], cfg, state=cache,
                                       want_state=want_cache)
        if cfg.mla is not None:
            return mla_forward(h, p["attn"], cfg, ctx, want_cache)
        return attn_forward(h, p["attn"], cfg, ctx, want_cache=want_cache)
    if kind == "mamba":
        a, new = mamba.mamba_decode(h, p["mamba"], cfg, cache)
        return a, commit_slots(cache, new, ctx.get("active"))
    paged = ctx.get("page_table") is not None
    if cfg.mla is not None:
        return (mla_decode_paged if paged else mla_decode_dense)(
            h, p["attn"], cfg, ctx, cache)
    if paged:
        return attn_decode_paged(h, p["attn"], cfg, ctx, cache)
    return attn_decode(h, p["attn"], cfg, ctx, cache)


def apply_block(p, x, kind: str, mlp_kind: str, cfg: ModelConfig, ctx,
                cache=None, want_cache: bool = False, stats=None):
    """One layer of kind ``kind`` ("attn", "mamba" or "rwkv") with an MLP
    of kind ``mlp_kind`` ("dense" or "moe"; RWKV has none). Attention and
    Mamba: norm -> mixer -> residual -> norm -> MLP -> residual. Returns
    (x, new_cache); an MoE MLP's stats go into ``stats`` if it is a
    dict."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, ctx, cache, want_cache)
    decode = ctx["mode"] == "decode"
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, new_cache = _mixer(h, kind, p, cfg, ctx, cache, want_cache)
    x = x + a
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if mlp_kind == "moe":
        return (x + _moe_block_mlp(h2, p["moe"], cfg, decode, stats),
                new_cache)
    return x + dense_mlp(h2, p["mlp"], cfg), new_cache


def apply_stack(params, x, cfg: ModelConfig, ctx, caches=None,
                want_caches: bool = False):
    """Run every block in layer order. Returns (x, new_caches), or in
    ``train`` mode (x, stats).

    ``ctx["mode"] == "train"`` runs the blocks for a loss: no cache is
    read or written, and with ``ctx["remat"]`` each block after the
    reference's prefix (``plan_layers``: moonshot's and deepseek's dense
    first layer; none in a dense stack) runs under
    ``torch.utils.checkpoint``, as the reference wraps each block of its
    scan in ``jax.checkpoint``: the backward replays one block at a time,
    so a block's activations are never kept past it. The stats
    ``{"moe_aux", "moe_dropped"}`` are fp32 scalars summed over the
    layers in layer order from zero, as the reference's ``apply_stack``
    sums them; a layer without an MoE MLP adds zeros. They leave each
    checkpointed block as outputs of its own, so ``moe_aux`` keeps its
    gradient through the router."""
    if ctx["mode"] == "train":
        if caches is not None or want_caches:
            raise ValueError("train mode reads and writes no cache")
        n_prefix = len(plan_layers(cfg)[0])
        aux = dropped = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
        for i, (bp, kind, mlp_kind) in enumerate(zip(
                params["blocks"], cfg.layer_kinds(), cfg.mlp_kinds())):
            run = functools.partial(_train_block, bp, kind, mlp_kind, cfg,
                                    ctx)
            if ctx.get("remat") and i >= n_prefix:
                x, a, d = torch.utils.checkpoint.checkpoint(
                    run, x, use_reentrant=False)
            else:
                x, a, d = run(x)
            aux, dropped = aux + a, dropped + d
        return x, {"moe_aux": aux, "moe_dropped": dropped}
    new_caches = []
    for i, (bp, kind, mlp_kind) in enumerate(zip(
            params["blocks"], cfg.layer_kinds(), cfg.mlp_kinds())):
        c = caches[i] if caches is not None else None
        x, nc = apply_block(bp, x, kind, mlp_kind, cfg, ctx, cache=c,
                            want_cache=want_caches)
        new_caches.append(nc)
    return x, new_caches


def _train_block(bp, kind: str, mlp_kind: str, cfg: ModelConfig, ctx, x):
    """One block for a loss: (x, moe_aux, moe_dropped), the stats zero
    for a block without an MoE MLP."""
    stats = {}
    x = apply_block(bp, x, kind, mlp_kind, cfg, ctx, stats=stats)[0]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, stats.get("moe_aux", zero), stats.get("moe_dropped", zero)


# --------------------------------------------------------------------------
# caches and page-granular movement
# --------------------------------------------------------------------------

def slab_len(cfg: ModelConfig, cache_len: int) -> int:
    """Rows of an attention layer's per-slot slab: ``cache_len``, or the
    ring of ``min(W, cache_len)`` rows with a sliding window W."""
    W = cfg.swa_window
    return min(W, cache_len) if W else cache_len


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-slot state of one layer, as the reference's
    ``init_block_cache``: attention slabs {k, v: [B, slab_len, KV, hd]}
    (``slab_len``), or MLA's {c_kv: [B, cache_len, lora], k_rope: [B,
    cache_len, rope]}, in the model dtype (the dense layout); Mamba's conv
    window [B, K-1, Di] in the model dtype and its SSM state [B, Di, N]
    fp32; RWKV's [B,H,hd,hd] fp32 carry and its two token-shift rows
    [B,D] in the model dtype."""
    d = cfg.d_model
    if kind == "attn" and cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros(batch, cache_len, m.kv_lora_rank,
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros(batch, cache_len, m.qk_rope_dim,
                                      dtype=dtype, device=device)}
    if kind == "attn":
        shape = (batch, slab_len(cfg, cache_len), cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mamba":
        m = cfg.mamba
        di = m.expand * d
        return {"conv": torch.zeros(batch, m.d_conv - 1, di, dtype=dtype,
                                    device=device),
                "ssm": torch.zeros(batch, di, m.d_state,
                                   dtype=torch.float32, device=device)}
    if kind != "rwkv":
        raise ValueError(f"unknown layer kind {kind!r}")
    hd = cfg.rwkv.head_dim
    return {"wkv": torch.zeros(batch, d // hd, hd, hd, dtype=torch.float32,
                               device=device),
            "shift_tm": torch.zeros(batch, d, dtype=dtype, device=device),
            "shift_cm": torch.zeros(batch, d, dtype=dtype, device=device)}


def init_stack_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                      device) -> List[Dict[str, torch.Tensor]]:
    """Per-slot state of every layer, in layer order."""
    return [init_block_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds()]


def cache_specs(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    """Logical sharding axes of one layer's per-slot state."""
    if kind == "attn":
        if cfg.mla is not None:
            # the latent cache has no head dim: along the sequence
            return {"c_kv": ("batch", "mla_seq", None),
                    "k_rope": ("batch", "mla_seq", None)}
        return {"k": ("batch", "kv_seq", "kv_heads", None),
                "v": ("batch", "kv_seq", "kv_heads", None)}
    if kind == "mamba":
        return {"conv": ("batch", None, "inner"),
                "ssm": ("batch", "inner", None)}
    if kind == "rwkv":
        return {"wkv": ("batch", "inner", None, None),
                "shift_tm": ("batch", None), "shift_cm": ("batch", None)}
    raise ValueError(f"unknown layer kind {kind!r}")


def stack_cache_specs(cfg: ModelConfig) -> List[Dict[str, tuple]]:
    """``cache_specs`` of every layer, in layer order."""
    return [cache_specs(cfg, kind) for kind in cfg.layer_kinds()]


def init_paged_stack_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                            dtype, device) -> List[Dict[str, torch.Tensor]]:
    """Shared pools: every attention layer holds [NP, page, KV, hd] K and
    V pools, shared by all serving slots and separated only by the page
    table."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def init_latent_paged_stack_caches(cfg: ModelConfig, n_pages: int,
                                   page_size: int, dtype,
                                   device) -> List[Dict[str, torch.Tensor]]:
    """Shared latent pools: every MLA layer holds [NP, page, lora] and
    [NP, page, rope] pools, the absorbed decode's cache behind the same
    page table as ``init_paged_stack_caches``, at lora + rope values per
    token instead of 2 KV hd."""
    m = cfg.mla
    return [{"c_kv": torch.zeros(n_pages, page_size, m.kv_lora_rank,
                                 dtype=dtype, device=device),
             "k_rope": torch.zeros(n_pages, page_size, m.qk_rope_dim,
                                   dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def dense_to_pages(dense_caches, n_pages: int, page_size: int):
    """Chunk a batch-1 dense cache list into page-granular data: leaves
    [1, L, ...] -> [n_pages, page, ...] (L >= n_pages * page; the
    prefill pads to cache_len, so tail pages past the length are zeros,
    masked by ``lengths`` at attention time)."""
    def one(d):
        L = d.shape[1]
        return d[0].reshape((L // page_size, page_size)
                            + tuple(d.shape[2:]))[:n_pages]
    return [{k: one(v) for k, v in layer.items()} for layer in dense_caches]


def pages_to_dense(page_caches, cache_len: int, page_size: int):
    """Inverse of ``dense_to_pages``: page-granular data in token order
    back to a batch-1 dense cache list zero-padded to ``cache_len``:
    leaves [P, page, KV, hd] -> [1, cache_len, KV, hd] (new tensors).
    Chunked prefill stages a paged slot's pages this way as the dense
    cache ``attn_prefill_chunk`` extends."""
    def one(p):
        d = p.reshape((p.shape[0] * page_size,) + tuple(p.shape[2:]))
        pad = (0, 0) * (d.dim() - 1) + (0, cache_len - d.shape[0])
        return torch.nn.functional.pad(d, pad)[None]
    return [{k: one(v) for k, v in layer.items()} for layer in page_caches]


def _device(pool_caches) -> torch.device:
    return next(iter(pool_caches[0].values())).device


def gather_pages(pool_caches, page_ids):
    """Pull the listed pages out of every pool (copies, on the pools'
    device)."""
    ids = torch.as_tensor(page_ids, dtype=torch.long,
                          device=_device(pool_caches))
    return [{k: pool[ids] for k, pool in layer.items()}
            for layer in pool_caches]


def scatter_pages(pool_caches, page_data, page_ids):
    """Write page-granular data into the listed pool pages, IN PLACE.
    Returns the same pool list."""
    dev = _device(pool_caches)
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
    for layer, data in zip(pool_caches, page_data):
        for k, pool in layer.items():
            pool.index_copy_(0, ids, data[k].to(device=dev,
                                                 dtype=pool.dtype))
    return pool_caches
