"""Paged KV decode attention (kernel B1) and its Scatter-Data half.

``paged_decode_attention`` is the wrapper of the hand-written CUDA kernel
in ``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``repro.kernels.paged_attention._paged_decode_pallas``.
``paged_decode_plain`` is the same function in plain PyTorch (a gather of
``k_pages[page_table]`` and a masked softmax, the
``ref.paged_decode_attention_ref`` oracle with the kernel's l == 0 guard,
so a row of length 0 returns 0): the wrapper takes it only for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against it.
The kernel splits each slot's table into partitions of
``partition_pages(MP, page)`` pages (a split pass and a reduce pass);
``paged_decode_split_plain`` is that algorithm in plain PyTorch, for the
tests only.

Layouts follow the JAX package: q [B,H,hd]; pools [NP,page,KV,hd];
page_table [B,MP] int32; lengths [B] int32 -> [B,H,hd].

``paged_append`` writes one token's K/V per slot into the pools, in place.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
# a partition holds at most this many tokens, and a slot is cut into at
# least this many partitions where its table has the pages
PARTITION_TOKENS = 256
MIN_SPLITS = 8


def partition_pages(max_pages: int, page: int) -> int:
    """Pages per partition of the kernel's split pass, from the shapes
    alone (never from ``lengths``): at most PARTITION_TOKENS tokens, and
    at least MIN_SPLITS partitions per slot while a partition keeps one
    page or more. MP 128, page 16 gives 16 pages (8 partitions); MP 16
    gives 2 (8 partitions of 32 tokens)."""
    return max(1, min(PARTITION_TOKENS // page, max_pages // MIN_SPLITS))


def paged_decode_plain(q, k_pages, v_pages, page_table, lengths, *,
                       scale: Optional[float] = None):
    """Gather every table entry's page, masked fp32 softmax."""
    B, H, hd = q.shape
    NP, page, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = page_table.long()
    k = k_pages[idx].reshape(B, MP * page, KV, hd)
    v = v_pages[idx].reshape(B, MP * page, KV, hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    valid = (torch.arange(MP * page, device=q.device)[None]
             < lengths[:, None])                              # [B, MP*page]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a row with no valid position has no keys at all: 0, not a mean of V
    p = torch.where((lengths > 0)[:, None, None, None], p,
                    torch.zeros_like(p))
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_split_plain(q, k_pages, v_pages, page_table, lengths, *,
                             partition_pages: int,
                             scale: Optional[float] = None):
    """The kernel's split-K algorithm in plain PyTorch, for the tests:
    per partition of ``partition_pages`` table entries a partial (m, l,
    acc) over its live positions (min(length, MP * page) capped; an empty
    partition has m = -1e30, l = 0), then the reduce: each partial
    rescaled by exp(m_i - m_max), empty ones skipped, added in partition
    order and divided by the summed l; all empty gives 0. fp32 math, the
    probabilities unrounded, as in the kernel."""
    B, H, hd = q.shape
    NP, page, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    live = torch.clamp(lengths.long(), max=MP * page)
    qg = q.float().reshape(B, KV, G, hd) * scale
    ms, ls, accs = [], [], []
    for lo in range(0, MP, partition_pages):
        cols = page_table[:, lo:lo + partition_pages].long()
        n = cols.shape[1] * page
        k = k_pages[cols].reshape(B, n, KV, hd).float()
        v = v_pages[cols].reshape(B, n, KV, hd).float()
        pos = lo * page + torch.arange(n, device=q.device)
        valid = (pos[None] < live[:, None])[:, None, None]  # [B,1,1,n]
        s = torch.einsum("bkgd,bskd->bkgs", qg, k)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.where(valid, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v))
    m, l = torch.stack(ms, -1), torch.stack(ls, -1)     # [B,KV,G,splits]
    acc = torch.stack(accs, -2)                         # [...,splits,hd]
    live_part = l > 0
    m_max = torch.where(live_part, m, torch.full_like(m, NEG_INF)).amax(-1)
    w = torch.where(live_part, torch.exp(m - m_max[..., None]),
                    torch.zeros_like(m))
    l_sum = (l * w).sum(-1)
    a_sum = (acc * w[..., None]).sum(-2)
    o = torch.where((l_sum > 0)[..., None],
                    a_sum / torch.where(l_sum > 0, l_sum,
                                        torch.ones_like(l_sum))[..., None],
                    torch.zeros_like(a_sum))
    return o.reshape(B, H, hd).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want q [B,H,hd], pools [NP,page,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != hd or H % KV:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} must be one of {HEAD_DIMS}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.shape[1] < 1 or tuple(lengths.shape) != (B,):
        raise ValueError(f"want page_table [B,MP>=1], lengths [B]; got "
                         f"{tuple(page_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, "
                        f"one dtype; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"page_table and lengths must be int32; got "
                        f"{page_table.dtype}, {lengths.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device; got {devs}")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: Optional[float] = None):
    """Single-token attention through a page table. CUDA tensors launch
    the B1 kernels (split pass, then reduce pass; ``launches`` counts
    calls); CPU tensors take ``paged_decode_plain``. The kernel reads
    min(length, MP * page) positions of each slot and never reads the
    table past MP."""
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"not {q.device}")
    ts = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention reads the pools in 16-byte "
                         "loads: they must be 16-byte aligned")
    B, H, hd = q.shape
    NP, page, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pp = partition_pages(MP, page)
    splits = -(-MP // pp)
    out = torch.empty_like(q)
    # partials of the split pass: acc [B,H,splits,hd], then (m, l)
    scratch = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_decode(q.data_ptr(), k_pages.data_ptr(),
                               v_pages.data_ptr(), page_table.data_ptr(),
                               lengths.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), B, H, KV, hd, page, MP,
                               pp, float(scale), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                 I, ctypes.c_float, I, P]
    lib.paged_decode.restype = I
    return lib


def live_table_width(n_live_pages: int, max_pages: int) -> int:
    """Page-table width covering ``n_live_pages``, bucketed to powers of
    two (capped at ``max_pages``): decode cost follows the batch's live
    page residency, and the number of distinct table widths stays at
    log2(max_pages). Entries past a slot's live pages are id 0, masked by
    ``lengths``, so any width >= the live count gives the same result."""
    w = 1
    while w < min(max(n_live_pages, 1), max_pages):
        w *= 2
    return min(w, max_pages)


def paged_append(k_pages, v_pages, k_new, v_new, page_table, positions,
                 active: Optional[torch.Tensor] = None):
    """Write one token's K/V per slot into the shared pools, IN PLACE.

    k_pages/v_pages: [NP, page, KV, hd]; k_new/v_new: [B, KV, hd];
    page_table: [B, MP]; positions: [B] slot each token lands at.
    ``active`` [B] bool: inactive (parked, finished or free) slots' writes
    are dropped, so a frozen sequence never touches pages owned by another.

    The JAX reference drops them by sending them to page id NP under
    ``mode="drop"``; torch raises on an out-of-range index, and selecting
    the active rows on the host would read the device. So the inactive
    rows are aimed at the first active row's target with that row's
    value: duplicate writes of one value, whatever order they land in.
    With no active row at all, every row writes back the value already at
    row 0's target. The table column is clamped to MP - 1 first: a parked
    slot keeps its length while ``sync`` may narrow the table below it.
    Returns the same (updated) pools.
    """
    page = k_pages.shape[1]
    B, MP = page_table.shape
    bidx = torch.arange(B, device=positions.device)
    col = torch.clamp(positions // page, max=MP - 1).long()
    pid = page_table[bidx, col].long()
    off = (positions % page).long()
    if active is None:
        k_pages[pid, off] = k_new.to(k_pages.dtype)
        v_pages[pid, off] = v_new.to(v_pages.dtype)
        return k_pages, v_pages
    # a [1]-shaped index stays a device gather; a 0-d one would be read
    # back to the host as a Python int on every use
    first = torch.argmax(active.to(torch.int32)).reshape(1)
    tgt_pid = torch.where(active, pid, pid[first])
    tgt_off = torch.where(active, off, off[first])
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        new = new.to(pages.dtype)
        first_val = torch.where(active[first].reshape(1, 1, 1), new[first],
                                pages[pid[first], off[first]])  # [1,KV,hd]
        val = torch.where(active[:, None, None], new, first_val)
        pages[tgt_pid, tgt_off] = val
    return k_pages, v_pages
