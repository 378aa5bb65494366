"""Serving front end of the port — the client side of the engine, as
``repro.serve.frontend``:

- **continuous arrivals**: `submit` is legal at any time, including
  between spans of an in-flight run; a timed arrival trace
  (serve/loadgen.py) replays through `run` against the injected clock
  (`EngineConfig.clock`), which tests swap for a `VirtualClock` so
  arrival interleaving, eviction tie-breaks, and bus-timed unparks are
  fully deterministic; a real clock naps through idle gaps
  (`core.timing.sleep`).
- **per-token streaming**: the engine's `_emit` funnel fires a
  request's `on_tokens` hook at its existing host-sync points (one per
  prefill completion, one per decode span — zero added syncs); the
  `RequestHandle` turns that into an ordered client stream that is
  byte-identical to `tokens_out`, deduping preempt-restart replays by
  emitted index.
- **SLO-graded admission control**: per-class TTFT/TPOT budgets on
  `EngineConfig` plus a bounded wait pool. Under overload the pool
  sheds or degrades the LOWEST classes — a class-c arrival may only
  displace a strictly-lower-priority waiter, mirroring the engine's
  eviction invariant (the Resource tier never parks a higher class for
  a lower one; the admission tier never sheds one). Every request ends
  in an explicit terminal outcome: completed | rejected | shed. No
  silent drops.

`step_hooks` are fired with the step count before each engine step (the
fault and crash injectors of ``repro_torch.ft`` ride them), and
`reattach` rebinds live handles to an engine restored from a snapshot.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Iterable, List, Optional, Tuple

from repro_torch.core.timing import sleep
from repro_torch.serve.api import Request, register_frontend, slo_budget

OUTCOME_COMPLETED = "completed"
OUTCOME_REJECTED = "rejected"    # refused at submit (no lower victim)
OUTCOME_SHED = "shed"            # dropped from the wait pool (capacity
#                                  displacement or SLO-TTFT expiry)


class VirtualClock:
    """A deterministic clock: time passes only when `advance` is called.

    Plugs into `EngineConfig.clock`; the frontend advances it by
    `step_dt` per engine step, so one virtual second is a pure function
    of the step count — arrival ordering, SLO expiry and bus-timed
    unpark readiness replay exactly across runs and machines.
    """

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class RequestHandle:
    """Per-request future + token stream.

    `streamed` is the client-visible token sequence; on completion it is
    byte-identical to `req.tokens_out` (pinned by tests): emissions
    arrive from the engine's `_emit` funnel in order, and a
    preempt-restart's replay is deduped by emitted index, so the client
    never sees a token twice or out of order. Terminal states:
    `outcome` in {completed, rejected, shed}; `reason` says why.
    """

    def __init__(self, req: Request, clock: Callable[[], float],
                 on_token: Optional[Callable[[int, int], None]] = None):
        self.req = req
        self._clock = clock
        self.on_token = on_token          # on_token(token, index)
        self.outcome: Optional[str] = None
        self.reason = ""
        self.degraded = False
        self.streamed: List[int] = []
        self.submitted_at = clock()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    # -- stream side (wired to Request.on_tokens by the frontend) ------
    def _feed(self, req: Request, new: List[int]) -> None:
        start = len(req.tokens_out) - len(new)
        for k, tok in enumerate(new):
            if start + k < len(self.streamed):
                continue      # preempt-restart replay of delivered tokens
            if self.first_token_at is None:
                self.first_token_at = self._clock()
            self.streamed.append(int(tok))
            if self.on_token is not None:
                self.on_token(int(tok), len(self.streamed) - 1)

    def _finish(self, outcome: str, reason: str = "") -> None:
        self.outcome = outcome
        self.reason = reason
        self.finished_at = self._clock()

    # -- future side ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self.outcome is not None

    @property
    def ok(self) -> bool:
        return self.outcome == OUTCOME_COMPLETED

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Mean per-token time after the first (None until finished or
        with a single-token stream — there is no inter-token gap)."""
        if (self.finished_at is None or self.first_token_at is None
                or len(self.streamed) < 2):
            return None
        return ((self.finished_at - self.first_token_at)
                / (len(self.streamed) - 1))

    def meets_slo(self, slo_ttft: Tuple[float, ...] = (),
                  slo_tpot: Tuple[float, ...] = ()) -> bool:
        """Completed within this request's class budgets (the goodput
        predicate; an unset budget always passes)."""
        if not self.ok:
            return False
        bt = slo_budget(self.req.qos, slo_ttft)
        if bt is not None and (self.ttft is None or self.ttft > bt):
            return False
        bp = slo_budget(self.req.qos, slo_tpot)
        if bp is not None and self.tpot is not None and self.tpot > bp:
            return False
        return True


@register_frontend("local")
class LocalFrontend:
    """In-process Frontend over one ServingEngine.

    The wait pool (bounded by `EngineConfig.admit_capacity`, shared
    across classes like the HostMultiQueue's slot pool) is where
    admission policy acts; the engine's scheduler queue is kept as a
    shallow dispatch buffer (`feed_depth`, default `slots`) so waiting
    mass stays where shed/expire decisions can still reach it.
    """

    def __init__(self, engine, step_dt: float = 0.0):
        self.engine = engine
        self.ecfg = engine.ecfg
        self.clock = engine.clock
        # virtual-clock seconds per engine step; ignored for real clocks
        # (which advance themselves)
        self.step_dt = float(step_dt)
        self.feed_depth = self.ecfg.feed_depth or self.ecfg.slots
        n = max(1, int(self.ecfg.qos_classes))
        self.n_classes = n
        self._wait: List[Deque[RequestHandle]] = [deque() for _ in range(n)]
        self._handles = {}                # req_id -> handle, fed to engine
        self.steps = 0
        self.step_hooks: List[Callable[[int], None]] = []   # ft injectors
        self.stats = {"submitted": 0, "admitted": 0, "completed": 0,
                      "rejected": 0, "shed_capacity": 0, "shed_slo": 0,
                      "degraded": 0}
        self.shed_log: List[dict] = []    # explicit record of every drop

    # -- helpers -------------------------------------------------------
    def _class_of(self, req: Request) -> int:
        return min(max(int(req.qos), 0), self.n_classes - 1)

    def _waiting(self) -> int:
        return sum(len(q) for q in self._wait)

    @property
    def live(self) -> bool:
        eng = self.engine
        return bool(self._waiting() or eng.active.any()
                    or eng.sched.pending or eng.transport.in_flight)

    # -- admission -----------------------------------------------------
    def submit(self, req: Request,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> RequestHandle:
        """Admit, degrade, displace a lower-class waiter, or reject —
        decided now, surfaced on the returned handle. Legal mid-run."""
        h = RequestHandle(req, self.clock, on_token)
        self.stats["submitted"] += 1
        c = self._class_of(req)
        cap = self.ecfg.admit_capacity
        if cap > 0 and self._waiting() >= cap:
            if not self._displace_below(c):
                # every waiter outranks (or ties) the arrival: the
                # arrival is its own victim — never shed a higher class
                # to admit a lower one
                h._finish(OUTCOME_REJECTED, "wait pool full")
                self.stats["rejected"] += 1
                self.shed_log.append({"req_id": req.req_id, "qos": c,
                                      "reason": "reject-full",
                                      "trigger_qos": c, "t": self.clock()})
                return h
        if (self.ecfg.degrade_max_new > 0 and c > 0
                and self._waiting() >= max(1, cap // 2)):
            # graceful degradation for non-top classes under pressure:
            # admit, but cap the response length instead of queueing the
            # full ask behind an already-deep pool
            if req.max_new_tokens > self.ecfg.degrade_max_new:
                req.max_new_tokens = self.ecfg.degrade_max_new
                h.degraded = True
                self.stats["degraded"] += 1
        self._wait[c].append(h)
        self._pump()
        return h

    def _displace_below(self, c: int) -> bool:
        """Drop the newest waiter of the lowest class STRICTLY below the
        arriving class `c` (tail-drop); False if no such victim."""
        for v in range(self.n_classes - 1, c, -1):
            if self._wait[v]:
                victim = self._wait[v].pop()
                victim._finish(OUTCOME_SHED, "displaced by higher class")
                self.stats["shed_capacity"] += 1
                self.shed_log.append({"req_id": victim.req.req_id,
                                      "qos": v, "reason": "capacity",
                                      "trigger_qos": c, "t": self.clock()})
                return True
        return False

    def _expire(self) -> None:
        """Shed waiters whose class TTFT budget is already blown — they
        cannot meet their SLO, and holding them only delays work that
        still can (explicit outcome, not a silent timeout)."""
        if not self.ecfg.slo_ttft:
            return
        now = self.clock()
        for cls in range(self.n_classes):
            budget = slo_budget(cls, self.ecfg.slo_ttft)
            if budget is None or not self._wait[cls]:
                continue
            keep: Deque[RequestHandle] = deque()
            for h in self._wait[cls]:
                if now - h.submitted_at > budget:
                    h._finish(OUTCOME_SHED, "slo-ttft expired in queue")
                    self.stats["shed_slo"] += 1
                    self.shed_log.append({"req_id": h.req.req_id,
                                          "qos": cls, "reason": "slo-ttft",
                                          "trigger_qos": None, "t": now})
                else:
                    keep.append(h)
            self._wait[cls] = keep

    def _pump(self) -> None:
        """Feed the engine's scheduler up to `feed_depth`, highest class
        first; scheduler-full is backpressure (waiters stay put), an
        impossible request is an explicit rejection."""
        while self.engine.sched.pending < self.feed_depth:
            h = None
            for q in self._wait:
                if q:
                    h = q.popleft()
                    break
            if h is None:
                return
            try:
                ok = self.engine.try_submit(h.req)
            except ValueError as e:
                h._finish(OUTCOME_REJECTED, f"invalid request: {e}")
                self.stats["rejected"] += 1
                continue
            if not ok:
                self._wait[self._class_of(h.req)].appendleft(h)
                return
            h.req.on_tokens = h._feed
            h.req.on_done = self._on_done
            self._handles[h.req.req_id] = h
            self.stats["admitted"] += 1

    def _on_done(self, req: Request) -> None:
        h = self._handles.pop(req.req_id)
        h._finish(OUTCOME_COMPLETED)
        self.stats["completed"] += 1

    # -- crash recovery ------------------------------------------------
    def reattach(self, engine) -> None:
        """Rebind live streaming handles to a restored engine.

        A snapshot serializes Requests without their process-local
        callbacks, and a crash may strike AFTER a handle's request was
        fed but BEFORE any snapshot recorded it. Both cases converge
        here: handles whose request the restored engine still owns are
        re-wired onto the restored object; the rest replay from zero
        through the admission path. Either way the client stream stays
        byte-identical: `_feed` dedupes by emitted index and the
        sampler's keys replay from `len(tokens_out)`."""
        self.engine = engine
        self.clock = engine.clock
        live = engine.live_requests()
        lost: List[RequestHandle] = []
        for rid, h in list(self._handles.items()):
            req = live.get(rid)
            if req is not None:
                h.req = req
                req.on_tokens = h._feed
                req.on_done = self._on_done
            else:
                del self._handles[rid]
                h.req.on_tokens = None
                h.req.on_done = None
                h.req.tokens_out.clear()
                h.req.logprobs_out.clear()
                lost.append(h)
        # back to the FRONT of each class queue in admission order: work
        # the engine had already accepted outranks waiters behind it
        for h in reversed(lost):
            self._wait[self._class_of(h.req)].appendleft(h)
        for hook in self.step_hooks:
            if hasattr(hook, "engine"):
                hook.engine = engine

    # -- drive loop ----------------------------------------------------
    def step(self) -> None:
        """One frontend pump + engine step: expire SLO-dead waiters,
        feed the scheduler, fire the step hooks, step the engine (token
        callbacks and completions fire inside), advance a virtual
        clock."""
        self._expire()
        self._pump()
        for hook in self.step_hooks:
            hook(self.steps)
        # a step consumes step_dt of virtual time BEFORE its tokens
        # appear, so emissions/completions are stamped strictly after
        # the arrivals that preceded the step (TTFT is never zero)
        if self.step_dt and hasattr(self.clock, "advance"):
            self.clock.advance(self.step_dt)
        self.engine.step()
        self.steps += 1

    def run(self, arrivals: Optional[Iterable] = None,
            max_steps: int = 100_000, drain: bool = True
            ) -> List[RequestHandle]:
        """Replay a timed trace of `(t, Request[, on_token])` events —
        each submitted once the clock reaches its arrival time — and
        (by default) drive until nothing is live. Idle gaps before the
        next arrival fast-forward a virtual clock and nap a real one."""
        pending: Deque = deque(
            sorted(arrivals, key=lambda ev: ev[0]) if arrivals else ())
        handles: List[RequestHandle] = []
        steps0 = self.steps
        while pending or (drain and self.live):
            while pending and pending[0][0] <= self.clock():
                ev = pending.popleft()
                handles.append(self.submit(
                    ev[1], on_token=ev[2] if len(ev) > 2 else None))
            if pending and not self.live:
                gap = pending[0][0] - self.clock()
                if gap > 0:
                    if hasattr(self.clock, "advance"):
                        self.clock.advance(gap)
                    else:
                        sleep(min(gap, 1e-3))
                    continue
            self.step()
            if self.steps - steps0 > max_steps:
                raise RuntimeError(
                    f"frontend.run exhausted max_steps={max_steps} with "
                    f"{self._waiting()} waiting and "
                    f"{len(self._handles)} in-engine requests")
        return handles
