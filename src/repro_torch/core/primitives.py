"""JingZhao's Table-1 primitives (``repro.core.primitives``), for the port.

Append/Remove Header frame documents and pack them into fixed-width rows
with segment ids (the data pipeline's framing format), in numpy, with the
reference's bits. Scatter/Gather Data move page-granular rows between a
page pool and a dense buffer, in torch, as the paged KV cache does.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

HEADER_LEN = 2  # [doc_id, doc_len]: the "packet header" of a packed doc


def append_header(doc: np.ndarray, doc_id: int) -> np.ndarray:
    """Encapsulate payload tokens into a framed packet (host-side)."""
    return np.concatenate([np.asarray([doc_id, len(doc)], doc.dtype), doc])


def remove_header(packet: np.ndarray) -> Tuple[int, np.ndarray]:
    """Decapsulate: returns (doc_id, payload)."""
    doc_id, n = int(packet[0]), int(packet[1])
    return doc_id, packet[HEADER_LEN: HEADER_LEN + n]


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack documents into fixed [N, seq_len] rows and segment ids.

    Greedy: each document continues the last row and spills into new
    ones. Returns (tokens, segment_ids) int32, segment ids counting
    documents from 1 (0 = padding)."""
    rows: List[List[int]] = [[]]
    segs: List[List[int]] = [[]]
    for seg, doc in enumerate(docs, 1):
        doc = list(map(int, doc))
        while doc:
            space = seq_len - len(rows[-1])
            if space == 0:
                rows.append([])
                segs.append([])
                space = seq_len
            take, doc = doc[:space], doc[space:]
            rows[-1].extend(take)
            segs[-1].extend([seg] * len(take))
    tokens = np.full((len(rows), seq_len), pad_id, np.int32)
    segments = np.zeros((len(rows), seq_len), np.int32)
    for i, (r, s) in enumerate(zip(rows, segs)):
        tokens[i, :len(r)] = r
        segments[i, :len(s)] = s
    return tokens, segments


def unpack_documents(tokens: np.ndarray, segments: np.ndarray
                     ) -> List[np.ndarray]:
    """Inverse of ``pack_documents`` (padding dropped, order kept)."""
    out = {}
    for t, s in zip(tokens.reshape(-1), segments.reshape(-1)):
        if s == 0:
            continue
        out.setdefault(int(s), []).append(int(t))
    return [np.asarray(out[k], np.int32) for k in sorted(out)]


def scatter_pages(pool: torch.Tensor, page_ids: torch.Tensor,
                  data: torch.Tensor) -> torch.Tensor:
    """Write [P, page, ...] rows into a copy of pool [NP, page, ...] at
    ``page_ids`` (the reference returns a new array)."""
    out = pool.clone()
    out[page_ids.long()] = data.to(pool.dtype)
    return out


def gather_pages(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """The listed pages of the pool -> [P, page, ...]."""
    return pool[page_ids.long()]
