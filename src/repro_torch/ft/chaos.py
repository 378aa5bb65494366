"""Deterministic chaos harness: crash-anywhere serving, as
``repro.ft.chaos``.

The acceptance property for engine crash recovery is absolute: for a
virtual-clock trace, a crash and restore injected at ANY engine step
boundary must leave every client token stream byte-identical to the
fault-free run, preserve `host_syncs == prefills + decode_spans`, and
strand zero requests. This module is what the port's crash tests and the
crash phase of chip_smoke.py run:

- `drive` runs one trace through a fresh frontend with an optional fault
  schedule (crash / park storm / slot kill, freely mixed) and returns a
  `ChaosReport` with the streams and logs; it asserts the sync invariant
  and explicit terminal outcomes internally.
- `crash_anywhere_sweep` replays the SAME trace once per step boundary
  of the clean run, crashing at each, and asserts stream identity.
- `random_schedule` derives seeded mixed fault schedules for the
  randomized soak.

Everything reads the injected `VirtualClock`, so every run, the
restored half of a crashed one included, is a pure function of its
inputs. The engines run on ``cuda`` unless `device` says otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import pack_tree
from repro_torch.ft.crash import CrashInjector
from repro_torch.ft.faults import ServingFaultInjector
from repro_torch.serve.api import EngineConfig, make_engine, make_frontend
from repro_torch.serve.frontend import VirtualClock


@dataclass
class ChaosReport:
    steps: int
    streams: Dict[int, Tuple[int, ...]]      # req_id -> client stream
    outcomes: Dict[int, str]                 # req_id -> terminal outcome
    engine_stats: dict
    frontend_stats: dict
    fault_log: List[dict] = field(default_factory=list)
    crash_log: List[dict] = field(default_factory=list)
    snapshot_bytes: int = 0                  # last snapshot's tensor bytes


def build_stack(cfg, params, ecfg_kw: dict, step_dt: float = 1.0,
                device=None):
    """(frontend, rebuild): a fresh engine and front end over a fresh
    VirtualClock, plus the successor-engine factory a CrashInjector
    needs: the same config object, clock and device, so restored time
    stays monotonic and a snapshot taken on the card is restored onto
    the card."""
    kw = dict(ecfg_kw)
    kw["clock"] = VirtualClock()
    ecfg = EngineConfig(**kw)

    def rebuild():
        return make_engine(cfg, params, ecfg, device=device)

    fe = make_frontend("local", rebuild(), step_dt=step_dt)
    return fe, rebuild


def drive(cfg, params, ecfg_kw: dict, arrivals: Iterable, *,
          crash_at: Iterable[int] = (), snapshot_every: int = 1,
          policy: Tuple[str, ...] = (), park_storm_at: Iterable[int] = (),
          kill_at: Iterable[int] = (), fault_seed: int = 0,
          step_dt: float = 1.0, max_steps: int = 5000,
          device=None) -> ChaosReport:
    """One full run of `arrivals` under a fault schedule.

    `arrivals` must be freshly generated per call (Requests mutate as
    they run). Asserts the host-sync invariant and that every handle
    reached an explicit terminal outcome: zero stranded requests."""
    fe, rebuild = build_stack(cfg, params, ecfg_kw, step_dt=step_dt,
                              device=device)
    finj = cinj = None
    if park_storm_at or kill_at:
        finj = ServingFaultInjector(
            fe.engine, park_storm_at=park_storm_at, kill_at=kill_at,
            seed=fault_seed).attach(fe)
    if crash_at or snapshot_every:
        cinj = CrashInjector(fe, rebuild, crash_at=crash_at,
                             snapshot_every=snapshot_every,
                             policy=policy).attach()
    handles = fe.run(list(arrivals), max_steps=max_steps)
    eng = fe.engine
    s = eng.stats
    assert s["host_syncs"] == s["prefills"] + s["decode_spans"], (
        f"host-sync invariant broken after faults: {s['host_syncs']} != "
        f"{s['prefills']} + {s['decode_spans']}")
    stranded = [h.req.req_id for h in handles if not h.done]
    assert not stranded, f"requests stranded without outcome: {stranded}"
    snap_bytes = 0
    if cinj is not None and cinj.snap is not None:
        leaves, _ = pack_tree(cinj.snap)
        snap_bytes = int(sum(_nbytes(a) for a in leaves))
    return ChaosReport(
        steps=fe.steps,
        streams={h.req.req_id: tuple(h.streamed) for h in handles},
        outcomes={h.req.req_id: h.outcome for h in handles},
        engine_stats=dict(s),
        frontend_stats=dict(fe.stats),
        fault_log=list(finj.log) if finj else [],
        crash_log=list(cinj.log) if cinj else [],
        snapshot_bytes=snap_bytes)


def crash_anywhere_sweep(cfg, params, ecfg_kw: dict,
                         trace_fn: Callable[[], Iterable], *,
                         snapshot_every: int = 1,
                         policy: Tuple[str, ...] = (),
                         boundaries: Optional[Iterable[int]] = None,
                         step_dt: float = 1.0,
                         backend: Optional[str] = None, device=None
                         ) -> Tuple[ChaosReport, List[ChaosReport]]:
    """Crash at every step boundary of the clean run (or the given
    subset), asserting each crashed run's client streams byte-identical
    to the fault-free run. `trace_fn` regenerates the reference trace
    for each run. `backend` overrides the StateBackend layout, so one
    trace sweeps the invariant over dense/paged/latent/recurrent."""
    if backend is not None:
        ecfg_kw = dict(ecfg_kw, kv_layout=backend)
    clean = drive(cfg, params, ecfg_kw, trace_fn(), step_dt=step_dt,
                  device=device)
    bounds = list(boundaries) if boundaries is not None \
        else list(range(clean.steps))
    reports = []
    for s in bounds:
        r = drive(cfg, params, ecfg_kw, trace_fn(), crash_at=(s,),
                  snapshot_every=snapshot_every, policy=policy,
                  step_dt=step_dt, device=device)
        assert r.crash_log and r.crash_log[0]["step"] == s, (
            f"crash at boundary {s} did not land (ran {r.steps} steps)")
        assert r.streams == clean.streams, (
            f"crash at step {s} changed a client stream: "
            f"{_stream_diff(clean.streams, r.streams)}")
        assert r.outcomes == clean.outcomes, (
            f"crash at step {s} changed an outcome: "
            f"{clean.outcomes} vs {r.outcomes}")
        reports.append(r)
    return clean, reports


def random_schedule(seed: int, n_steps: int, n_crash: int = 1,
                    n_park: int = 1, n_kill: int = 1) -> dict:
    """A seeded mixed fault schedule over [1, n_steps) — crash, park
    storm, and kill steps drawn independently (collisions allowed:
    a park storm and a crash on one boundary is the hard case)."""
    rng = np.random.default_rng(seed)
    hi = max(2, int(n_steps))

    def pick(n):
        return tuple(sorted(int(x) for x in
                            rng.integers(1, hi, size=max(0, n))))

    return {"crash_at": pick(n_crash), "park_storm_at": pick(n_park),
            "kill_at": pick(n_kill)}


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def _stream_diff(a: Dict[int, tuple], b: Dict[int, tuple]) -> str:
    bad = [rid for rid in sorted(set(a) | set(b))
           if a.get(rid) != b.get(rid)]
    return f"req_ids {bad}"
