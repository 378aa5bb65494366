"""The kernels' public entry points under the reference's names and
keywords (``repro.kernels.ops``), over the port's wrappers.

Each name reaches its wrapper: CUDA tensors launch the hand-written
Hopper kernel, CPU tensors take its plain version, as the wrapper does
on its own; no entry point adds a fallback. ``interpret`` (the Pallas
interpreter) has no meaning here: only None or False is taken.
``block_q``, ``block_k`` and ``block_d`` are the TPU kernels' tile sizes;
the Hopper kernels pick their own tiles, so they are taken and not used.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import (flash_attention as _fa, linear_scan as _ls,
                                 moe_dispatch as _md, paged_attention as _pd,
                                 sampling as _sp, ssm_decode as _ssd,
                                 wkv6 as _wkv)


def _no_interpret(interpret: Optional[bool]) -> None:
    if interpret:
        raise ValueError("interpret=True asks for the Pallas interpreter; "
                         "the port's kernels run on the card, their plain "
                         "versions on the CPU")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    interpret: Optional[bool] = None):
    """q [B,H,S,hd], k and v [B,KV,S,hd] -> [B,H,S,hd_v]: B2."""
    _no_interpret(interpret)
    if not causal:
        raise ValueError("non-causal attention is not used by this "
                         "framework")
    return _fa.flash_attention(q, k, v, window=window)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           interpret: Optional[bool] = None):
    """q [B,H,hd] through the page table -> [B,H,hd]: B1."""
    _no_interpret(interpret)
    return _pd.paged_decode_attention(q, k_pages, v_pages, page_table,
                                      lengths)


def sample_logits(logits, keys, temperature, top_k, top_p):
    return _sp.sample_logits(logits, keys, temperature, top_k, top_p)


def moe_dispatch(tokens, expert_ids, positions, n_experts: int,
                 capacity: int, interpret: Optional[bool] = None):
    """tokens [T,D] -> per-expert capacity buffers [E,C,D]: B7."""
    _no_interpret(interpret)
    return _md.moe_dispatch(tokens, expert_ids, positions, n_experts,
                            capacity)


def linear_scan(a, b, h0, *, block_d: int = 256,
                interpret: Optional[bool] = None):
    """(h_all, h_last) of h_t = a_t * h_{t-1} + b_t: B6."""
    _no_interpret(interpret)
    return _ls.linear_scan(a, b, h0)


def wkv6_chunked(r, k, v, logw, u, state0, *, chunk: int = 32,
                 interpret: Optional[bool] = None):
    """(y, final state) of WKV-6 over a sequence: B4."""
    _no_interpret(interpret)
    return _wkv.wkv6_chunked(r, k, v, logw, u, state0, chunk=chunk)


def wkv6_decode(r, k, v, w, u, state, *, interpret: Optional[bool] = None):
    """(y, new state) of one WKV-6 token: B3."""
    _no_interpret(interpret)
    return _wkv.wkv6_decode(r, k, v, w, u, state)


def ssm_decode_step(h, dA, dtx, B_ssm, C_ssm, *, block_d: int = 256,
                    interpret: Optional[bool] = None):
    """(y, h') of one selective-scan token: B5."""
    _no_interpret(interpret)
    return _ssd.ssm_decode_step(h, dA, dtx, B_ssm, C_ssm)
