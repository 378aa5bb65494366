"""Attention for the model: causal prefill, paged decode, dense decode.

``chunked_causal_attention`` keeps the JAX model's name and layout
([B,S,H,hd]) and computes the same function as its jnp pair-list scan
with kernel B2, causal flash attention. Under autograd it is
differentiable as the reference's custom VJP is: the forward is B2 with
its log-sum-exp, and the backward is kernel B2-bwd
(``flash_attention.FlashAttention``).
``paged_decode_attention`` runs kernel B1 through the page table.
``decode_attention`` attends over per-slot slabs (the ``dense`` layout),
and ``chunk_prefix_attention`` attends a prompt chunk over the cache
written so far (chunked prefill), both in plain PyTorch, as the JAX
model does in jnp: the reference has no Pallas kernel for either. GQA is
native in all four: KV is never expanded to H heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

NEG_INF = -1e30


def chunked_causal_attention(q, k, v, *, window: int = 0,
                             scale: Optional[float] = None):
    """q: [B,S,H,hd], k: [B,S,KV,hd], v: [B,S,KV,hd_v] -> [B,S,H,hd_v]
    (causal, +SWA), for any hd and hd_v B2 has an instance for or up to
    its largest square head dim.

    B2 is built for the (hd, hd_v) pairs ``fa.INSTANCES``: the square
    head dims ``fa.HEAD_DIMS`` and MLA's q/k 192 with v 128, which runs
    as it is. Other head dims zero-pad q, k and v to the smallest square
    head dim that holds both hd and hd_v, with the scale of the unpadded
    q passed explicitly. The zero columns add nothing to the scores, and
    the output's padded columns are sliced off. The CPU path takes the
    same route. When autograd records (any of q, k, v requires grad) the
    B2 wrapper goes through ``fa.FlashAttention``, B2 with its lse forward
    and B2-bwd backward, at every instance, MLA's (192, 128) included;
    the padding and the slice stay outside it and are differentiated by
    autograd, so a padded head dim's gradients come back through the
    slice."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    width = max(hd, hd_v)
    if (hd, hd_v) in fa.INSTANCES:
        P = None
    elif width <= fa.HEAD_DIMS[-1]:
        P = next(d for d in fa.HEAD_DIMS if d >= width)
    else:
        raise ValueError(
            f"chunked_causal_attention: head dims q/k {hd}, v {hd_v}; B2 "
            f"is built for (q/k, v) {fa.INSTANCES} and pads others up to "
            f"{fa.HEAD_DIMS[-1]}")

    def heads_first(t):                  # [B,S,n,d] -> [B,n,S,P or d]
        t = t.transpose(1, 2)
        if P is not None:
            t = torch.nn.functional.pad(t, (0, P - t.shape[-1]))
        return t.contiguous()

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    out = fa.flash_attention(q, k, v, window=window, scale=scale)
    return out[..., :hd_v].transpose(1, 2)


def paged_decode_attention(q, page_table, k_pages, v_pages, lengths, *,
                           scale: Optional[float] = None):
    """q: [B,H,hd]; page_table: [B,MP] int32; pools [NP,page,KV,hd];
    lengths: [B] int32 valid positions per slot -> [B,H,hd]."""
    return pa.paged_decode_attention(q, k_pages, v_pages, page_table,
                                     lengths, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """One token per slot against its slab. q: [B,H,hd]; k_cache/v_cache:
    [B,Smax,KV,hd]; lengths: [B] valid entries -> [B,H,hd].

    Step for step the JAX model's ``decode_attention``: scores of the
    cache dtype accumulated in fp32, a masked fp32 softmax over Smax,
    the probabilities cast to the value dtype, the weighted sum
    accumulated in fp32 and cast to q's dtype."""
    B, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths[:, None])                        # [B,Smax]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def chunk_prefix_attention(q, k_cache, v_cache, q_pos, *,
                           scale: Optional[float] = None):
    """One prompt chunk against a dense cache (chunked prefill).
    q: [B,C,H,hd], chunk token i at absolute position q_pos[i] ([C]);
    k_cache/v_cache: [B,L,KV,hd] hold every position written so far,
    this chunk's included -> [B,C,H,hd].

    Step for step the JAX model's ``chunk_prefix_attention``: scores
    accumulated in fp32, the causal mask ``arange(L) <= q_pos`` over
    absolute positions, an fp32 softmax, the probabilities cast to the
    cache dtype, the weighted sum accumulated in fp32 and cast to q's
    dtype. So a prompt run in chunks computes the rows of monolithic
    prefill attention that belong to each chunk. Rows of padding (q_pos
    past the prompt) are computed and never read."""
    B, C, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, C, KV, H // KV, hd)
    s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k_cache.float()) * scale
    causal = (torch.arange(L, device=q.device)[None, :]
              <= q_pos[:, None])                        # [C,L]
    s = torch.where(causal[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, C, H, v_cache.shape[-1]).to(q.dtype)
