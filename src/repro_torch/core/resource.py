"""Resource Subsystem: the KV page pool (MTT), the host bus model and the
two-tier store with VoQ non-blocking misses.

Copied from ``repro.core.resource`` (``BusModel``, ``FetchRequest``,
``VoQResourceStore``, ``PagePool``): pure host bookkeeping, kept here so
the port imports nothing of ``repro``. With the paged layout the pool's
tables are the memory layout the decode kernel chases: row b of
``table_matrix`` names the pool pages holding slot b's KV, in token
order. ``VoQResourceStore`` is the paper's §4.1.1 design: a miss parks
only its own connection on that connection's virtual output queue, while
``blocking=True`` gives the Fig. 6 strawman, where one outstanding miss
stalls every lookup; its clock is the port's (``core/timing.py``) unless
the caller injects one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.multiqueue import HostMultiQueue
from repro_torch.core.timing import DEFAULT_CLOCK, sleep


@dataclass
class BusModel:
    """PCIe-like transfer cost model (paper §6.2 settings)."""
    latency_s: float = 350e-9        # one transaction RTT
    bandwidth_Bps: float = 25e9      # host <-> device
    throughput_ops: float = 200e6    # transactions/s cap

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


@dataclass
class FetchRequest:
    conn: int                 # connection / sequence id
    key: Any                  # resource key (e.g. page id)
    nbytes: float
    issued_at: float = 0.0


class VoQResourceStore:
    """Fast-tier cache over a slow tier, miss handling per connection.

    - ``lookup(conn, key)`` -> value | None (None = miss; the fetch is
      queued on that connection's VoQ; other connections go on).
    - ``poll()`` completes the fetches whose bus time has passed.
    - ``blocking=True`` is the paper's Fig. 6 strawman: one in-flight
      miss stalls every lookup (the benchmark's baseline).
    """

    def __init__(self, slow_get: Callable[[Any], np.ndarray],
                 capacity_items: int, item_bytes: float,
                 bus: Optional[BusModel] = None, blocking: bool = False,
                 n_connections: int = 1024,
                 now: Optional[Callable[[], float]] = None):
        self._slow_get = slow_get
        self._cache: Dict[Any, np.ndarray] = {}
        self._lru: deque = deque()
        self.capacity = capacity_items
        self.item_bytes = item_bytes
        self.bus = bus or BusModel()
        self.blocking = blocking
        self._pending: Dict[Any, float] = {}       # key -> ready time
        self._voq = HostMultiQueue(n_connections, capacity=1 << 16)
        self._now = now or DEFAULT_CLOCK
        self.stats = {"hits": 0, "misses": 0, "stalled_lookups": 0,
                      "bytes_fetched": 0.0}

    # -- internal -------------------------------------------------------
    def _evict_if_needed(self):
        while len(self._cache) > self.capacity and self._lru:
            old = self._lru.popleft()
            self._cache.pop(old, None)

    def _issue(self, conn: int, key: Any):
        ready = self._now() + self.bus.transfer_time(self.item_bytes)
        self._pending[key] = ready
        self._voq.push(conn, FetchRequest(conn, key, self.item_bytes,
                                          self._now()))
        self.stats["bytes_fetched"] += self.item_bytes

    # -- public ---------------------------------------------------------
    def lookup(self, conn: int, key: Any) -> Optional[np.ndarray]:
        if self.blocking and self._pending:
            # head-of-line: any outstanding miss stalls every connection
            self.stats["stalled_lookups"] += 1
            return None
        if key in self._cache:
            self.stats["hits"] += 1
            return self._cache[key]
        self.stats["misses"] += 1
        if key not in self._pending:
            self._issue(conn, key)
        return None

    def poll(self) -> List[Any]:
        """Complete the fetches whose (simulated) bus time has passed."""
        now = self._now()
        done = [k for k, t in self._pending.items() if t <= now]
        for k in done:
            self._pending.pop(k)
            self._cache[k] = self._slow_get(k)
            self._lru.append(k)
        self._evict_if_needed()
        return done

    def wait_all(self):
        while self._pending:
            soonest = min(self._pending.values())
            dt = soonest - self._now()
            if dt > 0:
                sleep(min(dt, 0.01))
            self.poll()

    def resident(self, key: Any) -> bool:
        return key in self._cache

    def invalidate(self, key: Any):
        self._cache.pop(key, None)


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
