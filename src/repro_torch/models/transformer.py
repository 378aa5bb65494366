"""Block assembly: attention, Mamba and RWKV-6 stacks.

The JAX model stacks its repeating unit of blocks with a grouped
``lax.scan`` (params and caches carry a leading group axis). PyTorch runs
eagerly, so the port holds one block per layer, in layer order: a params
dict ``{"blocks": [block, ...]}`` and a cache list with one entry per
layer. ``plan_layers`` is kept to read the reference's grouped layout
(models/convert.py). The port serves four families so far: plain
attention layers with dense (SwiGLU) MLPs, the same layers with MoE MLPs
(``models/moe.py``; layers before ``first_dense`` keep a dense MLP),
hybrids that interleave such attention layers with Mamba layers
(``models/mamba.py``, jamba), and pure RWKV-6 stacks (time- and
channel-mix, no MLP). MLA and sliding-window caches raise until their
slices (ROADMAP queue A).

Attention decodes through a shared page pool (``paged`` layout) when the
decode state carries a page table, else against per-slot slabs
``[B, cache_len, KV, hd]`` (``dense`` layout). Mamba and RWKV layers
carry constant-size per-slot state.

MoE layers return the router's stats (``moe_aux``, ``moe_dropped``);
serving has no loss to add them to and drops them unread, so no value
crosses to the host.

Cache tensors are updated IN PLACE (paged and dense decode appends,
prefill inserts, unpark restores, Mamba and RWKV decode commit their new
carry): JAX returns new caches that XLA updates in place under jit, while
eager torch would copy every cache on every step.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import paged_append
from repro_torch.models import mamba, moe, rwkv
from repro_torch.models.attention import (chunked_causal_attention,
                                          decode_attention,
                                          paged_decode_attention)
from repro_torch.models.layers import (apply_rope, dense_mlp, rms_norm,
                                       rope_angles)


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


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer is plain attention or Mamba with a SwiGLU
    MLP, dense or MoE, or every layer is RWKV-6; name the ROADMAP item of
    any other."""
    kinds = set(cfg.layer_kinds())
    mlps = set(cfg.mlp_kinds())
    if kinds == {"rwkv"}:
        return
    if (kinds <= {"attn", "mamba"} and mlps <= {"dense", "moe"}
            and cfg.mla is None and not cfg.swa_window
            and cfg.act == "swiglu"):
        return
    item = ("A8 (MLA)" if cfg.mla is not None
            else "A6 (the rest of the dense family)")
    raise ValueError(
        f"{cfg.name}: the port serves stacks of plain attention and Mamba "
        f"layers with SwiGLU dense or MoE MLPs, and pure RWKV-6 stacks, so "
        f"far (layers {sorted(kinds)}, mlps {sorted(mlps)}, "
        f"mla={cfg.mla is not None}, swa_window={cfg.swa_window}, "
        f"act={cfg.act}); this family waits for ROADMAP item {item}")


def paged_stack_supported(cfg: ModelConfig) -> bool:
    """Paged KV needs every layer to be plain (non-MLA, non-SWA)
    attention."""
    return (all(k == "attn" for k in cfg.layer_kinds())
            and cfg.mla is None and cfg.swa_window == 0)


def recurrent_state_supported(cfg: ModelConfig) -> bool:
    """Constant-size slot state needs every mixer to carry a recurrence
    (RWKV/Mamba): any attention layer grows per token."""
    kinds = set(cfg.layer_kinds())
    return bool(kinds) and kinds <= {"mamba", "rwkv"}


# --------------------------------------------------------------------------
# attention block
# --------------------------------------------------------------------------

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
    zero-padded to ``ctx["cache_len"]`` ([B, cache_len, KV, hd])."""
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
        pad = ctx.get("cache_len", S) - S
        cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return out, cache


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
    out = paged_decode_attention(q.contiguous(), table, cache["k"],
                                 cache["v"], lengths + 1)
    return out.reshape(x.shape[0], -1) @ p["wo"], cache


def attn_decode(x, p, cfg: ModelConfig, ctx, cache):
    """Dense decode. x: [B,D]; cache {k,v: [B,Smax,KV,hd]} holds one slab
    per slot; ctx carries positions/lengths [B] and the optional
    ``active`` mask. The new token's K/V goes into the slab at
    ``min(positions, Smax - 1)`` IN PLACE and attention reads
    ``min(lengths + 1, Smax)`` entries, as the reference's
    ``attn_decode``. Every slot attends with its new row in place, as
    there; then the rows of inactive slots get their old values back, so
    a frozen slot's slab is left as it was (the reference's freeze). The
    row indices are 1-d device tensors: nothing is read back."""
    B = x.shape[0]
    positions, lengths = ctx["positions"], ctx["lengths"]
    q, k_new, v_new = _qkv(x, p, cfg)                  # [B,H,hd],[B,KV,hd]
    ang = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q[:, None], ang[:, None])[:, 0]
    k_new = apply_rope(k_new[:, None], ang[:, None])[:, 0]
    Smax = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(positions, max=Smax - 1).long()
    active = ctx.get("active")
    new = {"k": k_new, "v": v_new}
    old = ({n: cache[n][rows, slot] for n in new} if active is not None
           else None)
    for n, val in new.items():
        cache[n].index_put_((rows, slot), val.to(cache[n].dtype))
    out = decode_attention(q, cache["k"], cache["v"],
                           torch.clamp(lengths + 1, max=Smax))
    if active is not None:
        keep = active[:, None, None]
        for n, val in new.items():
            cache[n].index_put_((rows, slot), torch.where(
                keep, val.to(cache[n].dtype), old[n]))
    return out.reshape(B, -1) @ p["wo"], cache


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


def _moe_block_mlp(h2, p, cfg: ModelConfig, decode: bool):
    """The MoE MLP as the reference's ``apply_block`` calls it: decode
    tokens [B,D] form one group with capacity factor 2.0, prefill runs
    one group per sequence at the config's factor. The stats are
    dropped."""
    if decode:
        out, _ = moe.moe_mlp(h2[None], p, cfg, capacity_factor=2.0)
        return out[0]
    out, _ = moe.moe_mlp(h2, p, cfg)
    return out


def _mixer(h, kind: str, p, cfg: ModelConfig, ctx, cache,
           want_cache: bool):
    """The attention or Mamba mixer of one layer. Decode writes its new
    state into ``cache`` in place: attention into the page pool (a page
    table in ``ctx``) or the slot's slab, Mamba through
    ``commit_slots`` under the active mask."""
    if ctx["mode"] != "decode":
        if kind == "mamba":
            return mamba.mamba_forward(h, p["mamba"], cfg, state=cache,
                                       want_state=want_cache)
        return attn_forward(h, p["attn"], cfg, ctx, want_cache=want_cache)
    if kind == "mamba":
        a, new = mamba.mamba_decode(h, p["mamba"], cfg, cache)
        return a, commit_slots(cache, new, ctx.get("active"))
    if ctx.get("page_table") is not None:
        return attn_decode_paged(h, p["attn"], cfg, ctx, cache)
    return attn_decode(h, p["attn"], cfg, ctx, cache)


def apply_block(p, x, kind: str, mlp_kind: str, cfg: ModelConfig, ctx,
                cache=None, want_cache: bool = False):
    """One layer of kind ``kind`` ("attn", "mamba" or "rwkv") with an MLP
    of kind ``mlp_kind`` ("dense" or "moe"; RWKV has none). Attention and
    Mamba: norm -> mixer -> residual -> norm -> MLP -> residual. Returns
    (x, new_cache)."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, ctx, cache, want_cache)
    decode = ctx["mode"] == "decode"
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, new_cache = _mixer(h, kind, p, cfg, ctx, cache, want_cache)
    x = x + a
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if mlp_kind == "moe":
        return x + _moe_block_mlp(h2, p["moe"], cfg, decode), new_cache
    return x + dense_mlp(h2, p["mlp"], cfg), new_cache


def apply_stack(params, x, cfg: ModelConfig, ctx, caches=None,
                want_caches: bool = False):
    """Run every block in layer order. Returns (x, new_caches)."""
    new_caches = []
    for i, (bp, kind, mlp_kind) in enumerate(zip(
            params["blocks"], cfg.layer_kinds(), cfg.mlp_kinds())):
        c = caches[i] if caches is not None else None
        x, nc = apply_block(bp, x, kind, mlp_kind, cfg, ctx, cache=c,
                            want_cache=want_caches)
        new_caches.append(nc)
    return x, new_caches


# --------------------------------------------------------------------------
# caches and page-granular movement
# --------------------------------------------------------------------------

def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-slot state of one layer, as the reference's
    ``init_block_cache``: attention slabs {k, v: [B, cache_len, KV, hd]}
    in the model dtype (the dense layout); Mamba's conv window [B, K-1,
    Di] in the model dtype and its SSM state [B, Di, N] fp32; RWKV's
    [B,H,hd,hd] fp32 carry and its two token-shift rows [B,D] in the
    model dtype."""
    d = cfg.d_model
    if kind == "attn":
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
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


def init_paged_stack_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                            dtype, device) -> List[Dict[str, torch.Tensor]]:
    """Shared pools: every attention layer holds [NP, page, KV, hd] K and
    V pools, shared by all serving slots and separated only by the page
    table."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def dense_to_pages(dense_caches, n_pages: int, page_size: int):
    """Chunk a batch-1 dense cache list into page-granular data: leaves
    [1, L, KV, hd] -> [n_pages, page, KV, hd] (L >= n_pages * page; the
    prefill pads to cache_len, so tail pages past the length are zeros,
    masked by ``lengths`` at attention time)."""
    def one(d):
        L = d.shape[1]
        return d[0].reshape((L // page_size, page_size)
                            + tuple(d.shape[2:]))[:n_pages]
    return [{k: one(v) for k, v in layer.items()} for layer in dense_caches]


def gather_pages(pool_caches, page_ids):
    """Pull the listed pages out of every pool (copies, on the pools'
    device)."""
    ids = torch.as_tensor(page_ids, dtype=torch.long,
                          device=pool_caches[0]["k"].device)
    return [{k: pool[ids] for k, pool in layer.items()}
            for layer in pool_caches]


def scatter_pages(pool_caches, page_data, page_ids):
    """Write page-granular data into the listed pool pages, IN PLACE.
    Returns the same pool list."""
    dev = pool_caches[0]["k"].device
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
    for layer, data in zip(pool_caches, page_data):
        for k, pool in layer.items():
            pool.index_copy_(0, ids, data[k].to(device=dev,
                                                 dtype=pool.dtype))
    return pool_caches
