"""Attention for the model: causal prefill and paged decode.

Both run through the port's kernels. ``chunked_causal_attention`` keeps
the JAX model's name and layout ([B,S,H,hd]) and computes the same
function as its jnp pair-list scan (forward only) with kernel B2, causal
flash attention. ``paged_decode_attention`` runs kernel B1 through the
page table. GQA is native in both: KV is never expanded to H heads.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa


def chunked_causal_attention(q, k, v, *, window: int = 0,
                             scale: Optional[float] = None):
    """q: [B,S,H,hd], k/v: [B,S,KV,hd] -> [B,S,H,hd] (causal, +SWA)."""
    out = fa.flash_attention(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(),
                             window=window, scale=scale)
    return out.transpose(1, 2)


def paged_decode_attention(q, page_table, k_pages, v_pages, lengths, *,
                           scale: Optional[float] = None):
    """q: [B,H,hd]; page_table: [B,MP] int32; pools [NP,page,KV,hd];
    lengths: [B] int32 valid positions per slot -> [B,H,hd]."""
    return pa.paged_decode_attention(q, k_pages, v_pages, page_table,
                                     lengths, scale=scale)
