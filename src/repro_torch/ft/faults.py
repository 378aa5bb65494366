"""Serving-side fault injection, as ``repro.ft.faults``.

Deterministic mid-run faults driven from a front end's `step_hooks`: a
park storm or a slot kill in the middle of live traffic must not change
a single byte of any client stream (parking restores exact state; a kill
replays through recompute preemption and the handle dedupes the
replayed prefix).
"""
from __future__ import annotations

from typing import Iterable, List, Set

import numpy as np


class ServingFaultInjector:
    """Deterministic fault schedule keyed on frontend step count.

    - park storm at step s: evict every evictable running slot at once
      (VoQ overflow to the host tier, bus-timed restore).
    - slot kill at step s: preempt-restart one victim slot (pages
      released, request replayed from token 0 — recompute preemption).

    Attach with `injector.attach(frontend)`; `injector.log` records
    every fault actually landed, so a run can assert faults happened.
    """

    def __init__(self, engine, park_storm_at: Iterable[int] = (),
                 kill_at: Iterable[int] = (), seed: int = 0):
        self.engine = engine
        self.park_storm_at: Set[int] = set(int(s) for s in park_storm_at)
        self.kill_at: Set[int] = set(int(s) for s in kill_at)
        self.rng = np.random.default_rng(seed)
        self.log: List[dict] = []

    def attach(self, frontend) -> "ServingFaultInjector":
        frontend.step_hooks.append(self)
        return self

    def _victims(self) -> List[int]:
        eng = self.engine
        return [i for i in range(eng.ecfg.slots)
                if eng.active[i] and eng.running[i]
                and not eng.prefilling[i] and eng.slot_req[i] is not None]

    def __call__(self, step: int) -> None:
        # every scheduled fault leaves a log entry, even with no eligible
        # victims ("slots": []): a reliability assert can distinguish
        # "the fault landed" from "the schedule silently missed", so
        # stream-identity checks can never pass vacuously
        if step in self.park_storm_at:
            parked = [i for i in self._victims()
                      if self.engine._park_slot(i)]
            self.log.append({"step": step, "fault": "park_storm",
                             "slots": parked})
        if step in self.kill_at:
            victims = self._victims()
            if victims:
                slot = int(victims[self.rng.integers(len(victims))])
                rid = self.engine.slot_req[slot].req_id
                self.engine._preempt_restart(slot)
                self.log.append({"step": step, "fault": "kill",
                                 "slots": [slot], "req_id": rid})
            else:
                self.log.append({"step": step, "fault": "kill",
                                 "slots": []})
