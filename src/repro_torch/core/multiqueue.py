"""Dynamic MultiQueue (``repro.core.multiqueue``), the paper's core
building block (Table 1, Fig. 9), in two forms.

- ``HostMultiQueue``: N logical FIFOs in one shared slot pool with a
  free-list, on the host; it backs the schedulers' QoS class queues.
- ``MQState`` with ``mq_init``, ``mq_push``, ``mq_pop`` and ``mq_sizes``:
  ring buffers on the device, ``[Q, C, ...payload]`` with absolute head
  and tail counters per queue (a queue's slot is ``counter % C``). The
  queue index ``q`` is a 0-d int tensor on the state's device; push and
  pop read nothing back to the host and branch on no device value, so a
  device-resident span can run them. They write the state IN PLACE, as
  the port's caches are written, and return it.
- ``batched_enqueue``: T items into per-queue capacity buffers at once,
  positions by a cumsum of one-hot in arrival order, overflow dropped:
  the MoE dispatch's enqueue, which B7 (``kernels/moe_dispatch.py``)
  computes from the same positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device


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


# --------------------------------------------------------------------------
# device multiqueue: ring buffers with absolute counters
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MQState:
    """Ring-buffer multiqueue: [n_queues, capacity] payload + head/tail."""
    buf: torch.Tensor       # [Q, C, ...payload]
    head: torch.Tensor      # [Q] int32 (absolute counters)
    tail: torch.Tensor      # [Q] int32


def mq_init(n_queues: int, capacity: int, payload_shape: Tuple[int, ...],
            dtype=torch.float32, device=None) -> MQState:
    device = resolve_device(device)
    return MQState(
        buf=torch.zeros((n_queues, capacity) + tuple(payload_shape),
                        dtype=dtype, device=device),
        head=torch.zeros(n_queues, dtype=torch.int32, device=device),
        tail=torch.zeros(n_queues, dtype=torch.int32, device=device))


def _ring(state: MQState, q: torch.Tensor):
    """(q as a 1-element index, the [Q*C, P] view of the buffer, queue q's
    head and tail as 1-element tensors). A 1-d index, never a 0-d one:
    torch reads a 0-d index tensor back to the host."""
    qi = q.reshape(1).long()
    flat = state.buf.view(state.buf.shape[0] * state.buf.shape[1], -1)
    return qi, flat, state.head.index_select(0, qi), \
        state.tail.index_select(0, qi)


def mq_push(state: MQState, q: torch.Tensor, item: torch.Tensor
            ) -> Tuple[MQState, torch.Tensor]:
    """Push ``item`` to queue ``q`` (a 0-d int tensor). Returns (state,
    ok): ok (0-d bool) is False, and nothing changes, when q is full."""
    cap = state.buf.shape[1]
    qi, flat, head, tail = _ring(state, q)
    ok = (tail - head) < cap
    row = qi * cap + (tail % cap).long()
    new = item.reshape(1, -1).to(state.buf.dtype)
    flat.index_copy_(0, row, torch.where(ok[:, None], new,
                                         flat.index_select(0, row)))
    state.tail.index_add_(0, qi, ok.to(torch.int32))
    return state, ok[0]


def mq_pop(state: MQState, q: torch.Tensor
           ) -> Tuple[MQState, torch.Tensor, torch.Tensor]:
    """Pop from queue ``q``. Returns (state, item, ok); an empty queue
    gives zeros and ok False."""
    cap = state.buf.shape[1]
    qi, flat, head, tail = _ring(state, q)
    ok = (tail - head) > 0
    item = flat.index_select(0, qi * cap + (head % cap).long())
    item = torch.where(ok[:, None], item, torch.zeros_like(item))
    state.head.index_add_(0, qi, ok.to(torch.int32))
    return state, item.reshape(state.buf.shape[2:]), ok[0]


def mq_sizes(state: MQState) -> torch.Tensor:
    return state.tail - state.head


# --------------------------------------------------------------------------
# batched enqueue into per-queue capacity buffers (the MoE dispatch shape)
# --------------------------------------------------------------------------

def batched_enqueue(items: torch.Tensor, queue_ids: torch.Tensor,
                    n_queues: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Enqueue T items into per-queue buffers in one shot.

    items: [T, D]; queue_ids: [T] int, each in [0, n_queues) -> (buffers
    [Q, C, D], positions [T] int32, kept [T] bool). A position is the
    item's arrival index within its queue (cumsum of one-hot); items at
    or past ``capacity`` are dropped. Plain torch, as the reference's
    jnp: a scatter into [Q, C+1, D] whose row C takes the dropped items,
    then a slice. The buffers equal B7's ``moe_dispatch(items,
    queue_ids, positions, Q, C)``."""
    ids = queue_ids.long()
    onehot = (ids[:, None] == torch.arange(n_queues, device=ids.device)
              ).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32).gather(
        1, ids[:, None])[:, 0] - 1
    kept = pos < capacity
    pos_safe = torch.where(kept, pos, capacity).long()
    buf = torch.zeros(n_queues, capacity + 1, items.shape[1],
                      dtype=items.dtype, device=items.device)
    buf.index_put_((ids, pos_safe), items)
    return buf[:, :capacity], pos, kept
