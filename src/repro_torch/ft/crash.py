"""Whole-process crash recovery for the serving engine, as
``repro.ft.crash``.

`ft/faults.py` injects faults a live engine survives (park storms, slot
kills); this module injects the fault that kills the engine itself. A
`CrashInjector` rides a front end's `step_hooks`: it keeps a rolling
`ServingEngine.snapshot()` and, at each scheduled crash step, discards
the engine object outright, builds a fresh one, restores the snapshot,
applies the per-class recovery policy and reattaches the front end's
streaming handles: the loop that steps the front end never learns that
its engine was replaced mid-run.

Recovery policies:

- "snapshot" (alias "gbn"): resume the slot from the restored state;
  cheap in recompute, pays for snapshot bytes.
- "replay" (alias "sr"): drop the slot's restored state and requeue the
  request for a from-scratch prefill through the engine's
  `_preempt_restart`; needs no snapshot bytes, pays in recomputed
  tokens.

Either policy gives byte-identical client streams (the front end's
handles dedupe by emitted index; sampler keys re-derive from
`len(tokens_out)`). The log keeps each crash's work counters at the
crash and after the restore, so recomputed work (and the kernels'
launches across incarnations) can be accounted.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

POLICY_SNAPSHOT = "snapshot"     # restore-from-snapshot (GBN analog)
POLICY_REPLAY = "replay"         # replay-from-zero (SR / recompute analog)
_ALIASES = {"gbn": POLICY_SNAPSHOT, "sr": POLICY_REPLAY}


def policy_of(qos: int, policy: Tuple[str, ...]) -> str:
    """Per-class recovery policy; a shorter tuple broadcasts its last
    entry (the `slo_budget` convention), () means snapshot for all."""
    if not policy:
        return POLICY_SNAPSHOT
    p = policy[qos] if qos < len(policy) else policy[-1]
    p = _ALIASES.get(str(p), str(p))
    if p not in (POLICY_SNAPSHOT, POLICY_REPLAY):
        raise ValueError(f"unknown recovery policy {p!r}")
    return p


class CrashInjector:
    """Kill-and-restore the engine at chosen frontend step boundaries.

    `rebuild()` must return a fresh engine over the SAME config and
    injected clock (the crashed process's successor). `snapshot_every`
    controls the rolling-snapshot cadence (1 = every boundary, the
    crash-anywhere sweep; larger values leave a stale snapshot so the
    replay/dedupe path is exercised; 0 = never, a cold restart). `log`
    records every crash with the snapshot step it restored from and the
    slots the per-class policy replayed.
    """

    def __init__(self, frontend, rebuild: Callable[[], object],
                 crash_at: Iterable[int] = (), snapshot_every: int = 1,
                 policy: Tuple[str, ...] = ()):
        self.frontend = frontend
        self.engine = frontend.engine
        self.rebuild = rebuild
        self.crash_at = set(int(s) for s in crash_at)
        self.snapshot_every = int(snapshot_every)
        self.policy = tuple(policy)
        self.snap: Optional[dict] = None
        self.snap_step: Optional[int] = None
        self.crashes = 0
        self.log: List[dict] = []

    def attach(self, frontend=None) -> "CrashInjector":
        (frontend or self.frontend).step_hooks.append(self)
        return self

    def __call__(self, step: int) -> None:
        # snapshot BEFORE a same-step crash: "crash at boundary s" means
        # the newest snapshot is the state at s, exactly what the
        # crash-anywhere sweep restores
        if self.snapshot_every > 0 and step % self.snapshot_every == 0:
            self.snap = self.engine.snapshot()
            self.snap_step = step
        if step in self.crash_at:
            self.crash(step)

    _WORK_KEYS = ("prefills", "decode_spans")

    def crash(self, step: int) -> None:
        """The engine object dies here; its successor takes over."""
        # the dying engine's work counters vanish with it; record them
        # (and what the successor starts from) so recomputed work can be
        # measured as total-across-incarnations minus the clean run
        dying = {k: int(self.engine.stats[k]) for k in self._WORK_KEYS}
        eng = self.rebuild()
        if self.snap is not None:
            eng.restore(self.snap)
        replayed = []
        for slot in range(eng.ecfg.slots):
            req = eng.slot_req[slot]
            if req is None:
                continue
            if policy_of(int(req.qos), self.policy) == POLICY_REPLAY:
                eng.replay_from_zero(slot)
                replayed.append(int(req.req_id))
        # reattach re-points self.engine too (hooks with an `engine`
        # attribute are rebound onto the restored engine)
        self.frontend.reattach(eng)
        self.crashes += 1
        self.log.append({"step": step, "fault": "crash",
                         "restored_from": self.snap_step,
                         "replayed": replayed,
                         "work_at_crash": dying,
                         "work_restored": {
                             k: int(eng.stats[k])
                             for k in self._WORK_KEYS}})
