"""Host-tier ParkingTransport (Transport Subsystem).

Parked KV really moves to host tensors, and the `BusModel` decides when
the transfer is done: a restore is offered only once the modeled PCIe
time has passed on the engine's injected clock.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.resource import BusModel
from repro_torch.core.timing import DEFAULT_CLOCK
from repro_torch.serve.api import ParkMeta


def _nbytes(caches) -> int:
    """Bytes of every tensor in a per-layer list of {name: tensor}."""
    return sum(t.numel() * t.element_size()
               for layer in caches for t in layer.values())


class HostParkingTransport:
    """In-process host-memory tier with bus-timed park/restore."""

    def __init__(self, bus: Optional[BusModel] = None,
                 clock: Callable[[], float] = DEFAULT_CLOCK):
        self.bus = bus or BusModel()
        self._clock = clock
        self._tier: Dict[int, Tuple[Any, ParkMeta]] = {}
        self._ready_at: Dict[int, float] = {}
        self.bytes_moved = 0.0

    def begin(self, req_id: int, caches, meta: ParkMeta) -> None:
        nbytes = _nbytes(caches)
        self._tier[req_id] = (caches, meta)
        self._ready_at[req_id] = (self._clock()
                                  + self.bus.transfer_time(nbytes))
        self.bytes_moved += nbytes

    def ready(self, now: Optional[float] = None) -> List[int]:
        now = self._clock() if now is None else now
        return [rid for rid, t in list(self._ready_at.items()) if t <= now]

    def peek(self, req_id: int) -> Tuple[Any, ParkMeta]:
        return self._tier[req_id]

    def complete(self, req_id: int) -> None:
        del self._ready_at[req_id]
        del self._tier[req_id]

    @property
    def in_flight(self) -> int:
        return len(self._tier)
