"""Attention for the model: causal prefill, paged decode, dense decode.

``chunked_causal_attention`` keeps the JAX model's name and layout
([B,S,H,hd]) and computes the same function as its jnp pair-list scan
(forward only) with kernel B2, causal flash attention.
``paged_decode_attention`` runs kernel B1 through the page table.
``decode_attention`` attends over per-slot slabs (the ``dense`` layout)
in plain PyTorch, as the JAX model does in jnp: the reference has no
Pallas kernel for it. GQA is native in all three: KV is never expanded
to H heads.
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
    (causal, +SWA), for any hd and hd_v up to B2's largest head dim.

    B2 is built for the head dims ``fa.HEAD_DIMS``; q, k and v are
    zero-padded to the smallest of them that holds both hd and hd_v, with
    the scale of the unpadded q passed explicitly. The zero columns add
    nothing to the scores, and the output's padded columns are sliced
    off. The CPU path takes the same route."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    width = max(hd, hd_v)
    if width > fa.HEAD_DIMS[-1]:
        raise ValueError(
            f"chunked_causal_attention: head dims q/k {hd}, v {hd_v}; B2 "
            f"takes at most {fa.HEAD_DIMS[-1]} (MLA's 192 needs an instance "
            f"or a split of B2: ROADMAP item A8)")
    P = next(d for d in fa.HEAD_DIMS if d >= width)

    def heads_first(t):                  # [B,S,n,d] -> [B,n,S,P]
        return torch.nn.functional.pad(t.transpose(1, 2),
                                       (0, P - t.shape[-1])).contiguous()

    out = fa.flash_attention(heads_first(q), heads_first(k),
                             heads_first(v), window=window, scale=scale)
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
