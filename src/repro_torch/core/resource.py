"""Resource Subsystem: the KV page pool (MTT) and the host bus model.

Copied from ``repro.core.resource`` (``PagePool`` and ``BusModel``): pure
host bookkeeping, kept here so the port imports nothing of ``repro``.
With the paged layout the pool's tables are the memory layout the decode
kernel chases: row b of ``table_matrix`` names the pool pages holding
slot b's KV, in token order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class BusModel:
    """PCIe-like transfer cost model (paper §6.2 settings)."""
    latency_s: float = 350e-9        # one transaction RTT
    bandwidth_Bps: float = 25e9      # host <-> device
    throughput_ops: float = 200e6    # transactions/s cap

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


@dataclass
class PagePool:
    """Shared KV page pool + free-list (Dynamic Insert/Delete).

    This is the MTT analogue (DESIGN.md §3): the pool owns *allocation*
    metadata — which pages are free, which sequence maps to which pages —
    while the page tensors themselves (``[n_pages, page_size, KV, hd]``
    per layer) live in the serving state. ``ensure_capacity`` implements
    alloc-on-append: the engine calls it with the token count *about to be
    written* and pages are claimed exactly at page-boundary crossings, so
    a sequence only ever holds ``ceil(len/page_size)`` pages instead of a
    worst-case dense reservation.

    Pages are *refcounted* (DESIGN.md §3.5): a page allocated by `alloc`
    starts with one reference (its owner's table row); `share` appends the
    same physical pages to another sequence's table, and `addref`/`decref`
    let a non-sequence owner (the prefix block cache) pin pages without a
    table. A page returns to the free list only when its last reference
    drops, so N sequences with a common prefix hold the prefix pages once.

    ``peak`` is the pool's own high-water mark of ``n_used``: every page
    claim funnels through `alloc`, so the peak registers even when an
    alloc+release happens entirely inside a backend call between engine
    observation points (the engine's ``stats["pages_peak"]`` is a mirror
    of this value, never an independent sample).
    """
    n_pages: int
    page_size: int
    free: List[int] = field(default_factory=list)
    tables: Dict[int, List[int]] = field(default_factory=dict)
    refcnt: Dict[int, int] = field(default_factory=dict)
    peak: int = 0

    def __post_init__(self):
        if not self.free:
            self.free = list(range(self.n_pages - 1, -1, -1))
        self.peak = max(self.peak, self.n_used)

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self.free)

    def pages_of(self, seq_id: int) -> List[int]:
        return list(self.tables.get(seq_id, []))

    def alloc(self, seq_id: int, n: int = 1) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.refcnt[p] = 1
        self.tables.setdefault(seq_id, []).extend(pages)
        self.peak = max(self.peak, self.n_used)
        return pages

    def share(self, seq_id: int, pages: List[int]) -> None:
        """Append already-allocated pages to seq's table (one new ref
        each) — the prefix-sharing fast path: no data moves, no alloc."""
        self.addref(pages)
        self.tables.setdefault(seq_id, []).extend(pages)

    def addref(self, pages: List[int]) -> None:
        for p in pages:
            self.refcnt[p] = self.refcnt.get(p, 0) + 1

    def decref(self, pages: List[int]) -> None:
        """Drop one reference per page; free pages whose count hits 0."""
        for p in reversed(list(pages)):
            rc = self.refcnt.get(p, 0) - 1
            if rc <= 0:
                self.refcnt.pop(p, None)
                self.free.append(p)
            else:
                self.refcnt[p] = rc

    def refcount(self, page: int) -> int:
        return self.refcnt.get(page, 0)

    def ensure_capacity(self, seq_id: int, n_tokens: int) -> bool:
        """Alloc-on-append: grow seq's table to cover n_tokens slots."""
        need = -(-n_tokens // self.page_size)
        have = len(self.tables.get(seq_id, []))
        if need > have:
            return self.alloc(seq_id, need - have) is not None
        return True

    def release(self, seq_id: int):
        self.decref(self.tables.pop(seq_id, []))

    def table_array(self, seq_id: int, max_pages: int) -> np.ndarray:
        t = self.tables.get(seq_id, [])
        out = np.zeros(max_pages, np.int32)
        out[:len(t)] = t[:max_pages]
        return out

    def table_matrix(self, seq_ids: List[Optional[int]],
                     max_pages: int) -> np.ndarray:
        """[B, max_pages] MTT export for a batch of slots (None -> zeros).

        This array is what the decode step consumes: row b names the pool
        pages holding slot b's KV, in token order.
        """
        out = np.zeros((len(seq_ids), max_pages), np.int32)
        for b, sid in enumerate(seq_ids):
            if sid is not None:
                out[b] = self.table_array(sid, max_pages)
        return out
