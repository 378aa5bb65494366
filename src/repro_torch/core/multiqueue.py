"""Dynamic MultiQueue, host side: N logical FIFOs in one shared slot pool.

Copied from ``repro.core.multiqueue.HostMultiQueue`` (the in-graph JAX
ring buffers of that module are not on the port's path). It backs the
schedulers' QoS class queues.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np


class HostMultiQueue:
    """N logical FIFOs in one shared slot pool with a free-list.

    push/pop are O(1); the pool is the paper's shared block RAM, the
    free-list its Dynamic Insert/Delete.
    """

    def __init__(self, n_queues: int, capacity: int):
        self.capacity = capacity
        self.n_queues = n_queues
        self._next = np.full(capacity, -1, np.int64)    # linked slots
        self._payload: List[Any] = [None] * capacity
        self._head = np.full(n_queues, -1, np.int64)
        self._tail = np.full(n_queues, -1, np.int64)
        self._len = np.zeros(n_queues, np.int64)
        self._free = list(range(capacity - 1, -1, -1))  # stack of free slots

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def qlen(self, q: int) -> int:
        return int(self._len[q])

    def push(self, q: int, item: Any) -> bool:
        """Dynamic Enqueue; False when the shared pool is exhausted."""
        if not self._free:
            return False
        slot = self._free.pop()
        self._payload[slot] = item
        self._next[slot] = -1
        if self._tail[q] >= 0:
            self._next[self._tail[q]] = slot
        else:
            self._head[q] = slot
        self._tail[q] = slot
        self._len[q] += 1
        return True

    def pop(self, q: int) -> Optional[Any]:
        """Dynamic Dequeue; None when the logical queue is empty."""
        slot = self._head[q]
        if slot < 0:
            return None
        item = self._payload[slot]
        self._payload[slot] = None
        self._head[q] = self._next[slot]
        if self._head[q] < 0:
            self._tail[q] = -1
        self._next[slot] = -1
        self._free.append(int(slot))
        self._len[q] -= 1
        return item

    def items(self, q: int) -> List[Any]:
        """Queue q's payloads in pop order, without disturbing it (the
        snapshot read path walks the links and leaves the pool intact)."""
        out: List[Any] = []
        slot = int(self._head[q])
        while slot >= 0:
            out.append(self._payload[slot])
            slot = int(self._next[slot])
        return out

    # -- QoS pop helpers (paper Fig 9: class queues share one pool) -----
    @property
    def total_len(self) -> int:
        return int(self._len.sum())

    def pop_first(self) -> Tuple[Optional[Any], int]:
        """Strict-priority pop: first non-empty queue in index order
        (lower index = higher class). Returns (item, q) or (None, -1)
        when every queue is empty."""
        for q in range(self.n_queues):
            item = self.pop(q)
            if item is not None:
                return item, q
        return None, -1

    def pop_round_robin(self, start: int = 0
                        ) -> Tuple[Optional[Any], int]:
        """Fair pop: first non-empty queue scanning cyclically from
        `start`. Returns (item, q) or (None, -1)."""
        for i in range(self.n_queues):
            q = (start + i) % self.n_queues
            item = self.pop(q)
            if item is not None:
                return item, q
        return None, -1
