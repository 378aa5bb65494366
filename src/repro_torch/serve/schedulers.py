"""Built-in Scheduler implementations (Queue Subsystem).

Each scheduler is a thin policy over an N-queue `HostMultiQueue`:
`submit` pushes a request onto its QoS class queue, `next` pops by
policy. `requeue` routes through `class_of`, so work bounced back by
admission or preempt-restart keeps its class.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.multiqueue import HostMultiQueue
from repro_torch.serve.api import Request, register_scheduler


class _MultiQueueScheduler:
    """Shared plumbing: an N-class HostMultiQueue + qos -> class mapping."""

    def __init__(self, n_classes: int = 4, capacity: int = 1 << 12):
        self.n_classes = max(1, int(n_classes))
        self.mq = HostMultiQueue(self.n_classes, capacity=capacity)

    def class_of(self, req: Request) -> int:
        return min(max(int(getattr(req, "qos", 0)), 0), self.n_classes - 1)

    def submit(self, req: Request) -> bool:
        return self.mq.push(self.class_of(req), req)

    # a requeued request is not a new arrival: same class, tail of queue
    requeue = submit

    @property
    def pending(self) -> int:
        return self.mq.total_len

    @property
    def space(self) -> int:
        """Free submit capacity (the bounded-queue backpressure signal)."""
        return self.mq.free_slots


@register_scheduler("fcfs")
class FcfsScheduler(_MultiQueueScheduler):
    """Single arrival-order queue."""

    def __init__(self, n_classes: int = 1, capacity: int = 1 << 12):
        super().__init__(n_classes=1, capacity=capacity)

    def next(self) -> Optional[Request]:
        return self.mq.pop(0)


@register_scheduler("priority")
class PriorityScheduler(_MultiQueueScheduler):
    """Strict priority: class 0 drains fully before class 1, etc."""

    def next(self) -> Optional[Request]:
        item, _ = self.mq.pop_first()
        return item


@register_scheduler("round_robin")
class RoundRobinScheduler(_MultiQueueScheduler):
    """Fair drain: one admission per class in cyclic order."""

    def __init__(self, n_classes: int = 4, capacity: int = 1 << 12):
        super().__init__(n_classes=n_classes, capacity=capacity)
        self._cursor = 0

    def next(self) -> Optional[Request]:
        item, q = self.mq.pop_round_robin(self._cursor)
        if item is not None:
            self._cursor = (q + 1) % self.n_classes
        return item
