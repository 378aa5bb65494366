"""Continuous-batching serving engine of the port: a thin driver over the
pluggable subsystems of serve/api.py.

The loop is the JAX engine's (``repro.serve.engine``): admit from the
scheduler, restore due unparks, run the backend's alloc-on-append pass,
reserve page headroom for the coming decode span, sync page tables, then
decode up to ``decode_span`` tokens on the device with the active mask
freezing finished and parked slots. Stop conditions (EOS, max_new_tokens,
cache_len, span budget) are evaluated on the device, and the host reads
the emitted tokens once per span. Prefill is monolithic. Parked slots'
state (KV pages, or a recurrent carry) really moves to host tensors and
back. The loop never branches on the layout: the backend's
`needs_growth` decides admission charges, growth, span reservation and
prefix-cache eviction.

Every read the serving loop makes off the device goes through
``_host_sync``, so ``host_syncs == prefills + decode_spans``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.paged_attention import live_table_width
from repro_torch.models import lm
from repro_torch.serve.api import (EngineConfig, ParkingTransport, Request,
                                   Sampler, SamplingParams, Scheduler,
                                   StateBackend, make_sampler,
                                   make_scheduler, make_state_backend)
from repro_torch.serve.parking import HostParkingTransport
from repro_torch.serve.prefix_cache import PrefixCache


class ServingEngine:

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device=None, scheduler: Optional[Scheduler] = None,
                 kv_backend: Optional[StateBackend] = None,
                 transport: Optional[ParkingTransport] = None,
                 sampler: Optional[Sampler] = None):
        if ecfg.decode_span < 1:
            raise ValueError(
                f"decode_span must be >= 1, got {ecfg.decode_span}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(device)
        B = ecfg.slots
        self.clock = ecfg.clock
        self.kv = kv_backend or make_state_backend(ecfg.kv_layout, cfg,
                                                   ecfg, self.device)
        self.state = self.kv.init_state()
        self.sched = scheduler or make_scheduler(
            ecfg.scheduler, n_classes=ecfg.qos_classes,
            capacity=ecfg.queue_capacity)
        self.transport = transport or HostParkingTransport(
            ecfg.bus, clock=self.clock)
        self.sampler = sampler or make_sampler(ecfg.sampler)
        self.active = np.zeros(B, bool)          # slot has a sequence
        self.running = np.zeros(B, bool)         # decoding (not parked)
        self.slot_req: List[Optional[Request]] = [None] * B
        # held at capacity 0 (EngineConfig refuses anything else): inert,
        # its evict_one is the first reclaim valve under page pressure
        self.prefix = PrefixCache(ecfg.prefix_cache_entries,
                                  block=ecfg.page_size)
        self._stalled: set = set()               # req_ids frozen in place
        self.completed: List[Request] = []
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "decode_spans": 0, "host_syncs": 0, "span_shrinks": 0,
                      "prefills": 0, "prefill_tokens": 0,
                      "parked": 0, "unparked": 0,
                      "page_allocs": 0, "pages_peak": 0,
                      "preempt_restarts": 0}

    @property
    def pool(self):
        """The StateBackend's PagePool (MTT accounting)."""
        return self.kv.pool

    def _host_sync(self, tensors):
        """THE accounted blocking device->host transfer: one per decode
        span, one per prefill first token. Returns numpy arrays."""
        self.stats["host_syncs"] += 1
        return tuple(t.cpu().numpy() for t in tensors)

    # ------------------------------------------------------------------
    def try_submit(self, req: Request) -> bool:
        """Validate + enqueue; False means scheduler-queue backpressure.
        Impossible requests raise."""
        if len(req.prompt) + 1 > self.ecfg.cache_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} does not fit "
                f"cache_len {self.ecfg.cache_len} (need len+1 <= cache_len)")
        if req.sampling != SamplingParams():
            raise ValueError(
                f"request {req.req_id}: sampling parameters "
                f"{req.sampling} are not ported yet; the port serves exact "
                f"greedy only (stochastic sampling and logprobs: ROADMAP "
                f"item A5)")
        err = self.kv.admission_error(req)
        if err is not None:
            raise ValueError(err)
        req.arrived_at = self.clock()
        return self.sched.submit(req)

    def submit(self, req: Request):
        if not self.try_submit(req):
            raise RuntimeError(
                f"scheduler queue full (capacity "
                f"{self.ecfg.queue_capacity}); request {req.req_id} rejected")

    # -- slot management -------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        idle = np.nonzero(~self.active)[0]
        return int(idle[0]) if len(idle) else None

    def _release_slot(self, slot: int):
        self.active[slot] = False
        self.running[slot] = False
        self.slot_req[slot] = None

    def _complete(self, slot: int, req: Request):
        req.finished_at = self.clock()
        self.completed.append(req)
        self.kv.release(req.req_id)
        self._release_slot(slot)

    def _admit(self) -> int:
        admitted = 0
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            req: Optional[Request] = self.sched.next()
            if req is None:
                break
            if self.kv.needs_growth:
                n_tok = len(req.prompt) + 1      # prompt + first decode token
            else:
                n_tok = self.kv.footprint(req)   # reserved up front
            if not self._append_or_free(req.req_id, n_tok,
                                        self.sched.class_of(req)):
                self.kv.release(req.req_id)
                self._requeue(req)               # requeue; others proceed
                break
            self.active[slot] = True
            self.running[slot] = False
            self.slot_req[slot] = req
            self.stats["prefills"] += 1
            self._prefill_full(slot, req)
            admitted += 1
        return admitted

    def _prefill_full(self, slot: int, req: Request):
        """Monolithic prefill: run the prompt, move its K/V into the
        slot's pages, pick the first token on the device."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)
        logits, st = lm.prefill(self.params, prompt[None], self.cfg,
                                cache_len=self.ecfg.cache_len)
        self.state = self.kv.prefill_into_slot(
            self.state, slot, req.req_id, st["caches"], len(req.prompt))
        self.stats["prefill_tokens"] += len(req.prompt)
        self._finish_prefill(slot, req, self._first_token(logits))

    def _first_token(self, logits) -> int:
        """Select a finished prefill's first token ON DEVICE through the
        sampler and sync exactly one accounted scalar."""
        tok, = self._host_sync((lm.select_token(logits, self.sampler.sample),))
        return int(tok[0])

    def _finish_prefill(self, slot: int, req: Request, first_tok: int):
        total = len(req.prompt)
        self.state["lengths"][slot] = total
        self.state["positions"][slot] = total
        req.tokens_out.append(first_tok)
        # the prefill token can already satisfy the contract
        if (len(req.tokens_out) >= req.max_new_tokens
                or first_tok == self.ecfg.eos_token):
            self._complete(slot, req)
        else:
            self.running[slot] = True

    def _claim_reclaim(self, claim) -> bool:
        """Run a page-claiming thunk, dropping LRU prefix-cache blocks
        under page pressure when the backend grows (inert while the cache
        is empty)."""
        if claim():
            return True
        if self.kv.needs_growth:
            while self.prefix.evict_one():
                if claim():
                    return True
        return False

    def _append_reclaim(self, req_id: int, n_tok: int) -> bool:
        return self._claim_reclaim(lambda: self.kv.append(req_id, n_tok))

    def _reserve_reclaim(self, req_id: int, n_tok: int) -> bool:
        return self._claim_reclaim(
            lambda: self.kv.reserve_span(req_id, n_tok))

    def _append_or_free(self, req_id: int, n_tok: int,
                        for_class: Optional[int]) -> bool:
        """`_append_reclaim` plus the second pressure valve: VoQ eviction
        of a same-or-lower-priority victim."""
        if self._append_reclaim(req_id, n_tok):
            return True
        if self._evict_someone(exclude=req_id, for_class=for_class):
            return self._append_reclaim(req_id, n_tok)
        return False

    def _requeue(self, req: Request):
        if not self.sched.requeue(req):
            raise RuntimeError(
                f"scheduler queue full on requeue; request {req.req_id} "
                f"would be lost")

    # -- VoQ parking / eviction -------------------------------------------
    def _evict_someone(self, exclude: int,
                       for_class: Optional[int] = None) -> bool:
        """Park a running sequence from the lowest QoS class present
        (most recently admitted on ties), never from a class above
        `for_class`."""
        cands = [i for i in range(self.ecfg.slots)
                 if self.active[i] and self.running[i]
                 and self.slot_req[i] is not None
                 and self.slot_req[i].req_id != exclude]
        if for_class is not None:
            cands = [i for i in cands
                     if self.sched.class_of(self.slot_req[i]) >= for_class]
        if not cands:
            return False
        worst = max(self.sched.class_of(self.slot_req[i]) for i in cands)
        victim = max(
            (i for i in cands
             if self.sched.class_of(self.slot_req[i]) == worst),
            key=lambda i: self.slot_req[i].arrived_at)
        return self._park_slot(victim)

    def _park_slot(self, slot: int) -> bool:
        if not self.ecfg.host_offload:
            return False
        req = self.slot_req[slot]
        if req is None or not self.running[slot]:
            return False
        caches, meta = self.kv.park(self.state, slot, req.req_id)
        self.transport.begin(req.req_id, caches, meta)
        self.running[slot] = False
        self.stats["parked"] += 1
        return True

    def _try_unpark(self):
        for req_id in self.transport.ready():
            caches, meta = self.transport.peek(req_id)
            req = self.slot_req[meta.slot]
            if (req is None or req.req_id != req_id
                    or self.running[meta.slot]):
                continue
            ok, self.state = self.kv.unpark(
                self.state, meta.slot, req, caches, meta)
            while (not ok and self.kv.needs_growth
                   and self.prefix.evict_one()):
                ok, self.state = self.kv.unpark(
                    self.state, meta.slot, req, caches, meta)
            if not ok:
                continue                     # no pages yet; retry later
            self.running[meta.slot] = True
            self.transport.complete(req_id)
            self.stats["unparked"] += 1

    # -- capacity growth ---------------------------------------------------
    def _grow(self):
        """Alloc-on-append: claim a fresh page for every running slot whose
        next token crosses a page boundary. When the pool is dry and nobody
        is evictable the slot itself parks to the host tier, else stalls
        in place until pages free up, or — when stalling would freeze the
        whole batch — is preempted and requeued for a fresh prefill."""
        changed = False
        for i in range(self.ecfg.slots):
            req = self.slot_req[i]
            if req is None or not self.active[i]:
                continue
            if not self.running[i]:
                if req.req_id in self._stalled:
                    before = self.kv.held(req.req_id)
                    if self._append_reclaim(req.req_id,
                                            self._slot_pos(req) + 1):
                        self._stalled.discard(req.req_id)
                        self.running[i] = True
                        self.stats["page_allocs"] += (
                            self.kv.held(req.req_id) - before)
                        changed = True
                continue
            pos = self._slot_pos(req)        # host bookkeeping, no device read
            before = self.kv.held(req.req_id)
            if self._append_reclaim(req.req_id, pos + 1):
                grown = self.kv.held(req.req_id) - before
                if grown:
                    self.stats["page_allocs"] += grown
                    changed = True
                continue
            if (self._evict_someone(exclude=req.req_id,
                                    for_class=self.sched.class_of(req))
                    and self._append_reclaim(req.req_id, pos + 1)):
                self.stats["page_allocs"] += (
                    self.kv.held(req.req_id) - before)
                changed = True
                continue
            changed = True
            if self._park_slot(i):
                continue
            others_running = any(
                self.running[j] for j in range(self.ecfg.slots) if j != i)
            if others_running:
                self._stalled.add(req.req_id)      # freeze; resume later
                self.running[i] = False
            else:
                self._preempt_restart(i)           # avoid whole-batch stall
        if changed:
            self.kv.mark_dirty()

    def _preempt_restart(self, slot: int):
        """Release a slot's pages and requeue its request from scratch
        (recompute preemption), keeping its QoS class."""
        req = self.slot_req[slot]
        self.kv.release(req.req_id)
        self._stalled.discard(req.req_id)
        req.tokens_out.clear()
        self._release_slot(slot)
        self._requeue(req)
        self.stats["preempt_restarts"] += 1

    # -- decode spans ------------------------------------------------------
    @staticmethod
    def _slot_pos(req: Request) -> int:
        """A decoding slot's device position, from host bookkeeping alone:
        prefill leaves `positions = len(prompt)` with one emitted token,
        and every emission advances it by one."""
        return len(req.prompt) + len(req.tokens_out) - 1

    def _reserve_headroom(self, req_id: int, pos: int, want: int) -> int:
        """Claim pages covering up to `want` upcoming decode tokens for
        one slot; returns the granted count (>= 1). Never parks a live
        sequence to lengthen another's span."""
        if self._reserve_reclaim(req_id, pos + want):
            return want
        ps = self.ecfg.page_size
        avail = (self.kv.held(req_id) + self.pool.n_free) * ps - pos
        got = int(max(1, min(want, avail)))
        if got > 1:
            self.kv.reserve_span(req_id, pos + got)   # fits by construction
        self.stats["span_shrinks"] += 1
        return got

    def _reserve_decode_span(self, act: np.ndarray):
        """Per-slot span budgets (remaining max_new_tokens, cache_len
        distance and reservable pages folded into one counter) + the
        executed span, the pow2 bucket of the largest budget."""
        span = self.ecfg.decode_span
        L = self.ecfg.cache_len
        budgets = np.zeros(self.ecfg.slots, np.int32)
        grew = False
        for i in np.nonzero(act)[0]:
            req = self.slot_req[int(i)]
            pos = self._slot_pos(req)
            want = max(1, min(span, req.max_new_tokens - len(req.tokens_out),
                              L - pos))
            if want > 1 and self.kv.needs_growth:
                before = self.kv.held(req.req_id)
                want = self._reserve_headroom(req.req_id, pos, want)
                grown = self.kv.held(req.req_id) - before
                if grown:
                    self.stats["page_allocs"] += grown
                    grew = True
            budgets[i] = want
        if grew:
            self.kv.mark_dirty()             # headroom pages joined tables
        span_exec = live_table_width(int(budgets.max()), span)
        return budgets, span_exec

    # -- main loop ---------------------------------------------------------
    def step(self):
        try:
            self._step()
        finally:
            self.stats["pages_peak"] = self.pool.peak

    def _step(self):
        self._admit()
        self._try_unpark()
        if self.kv.needs_growth:
            self._grow()
        act = self.active & self.running
        if act.any():
            # reserve before sync: headroom pages must be in the tables
            budgets, span_exec = self._reserve_decode_span(act)
        self.state = self.kv.sync(
            self.state,
            [r.req_id if r is not None else None for r in self.slot_req])
        if not act.any():
            return                           # only parked slots
        tokens = np.zeros(self.ecfg.slots, np.int32)
        for i, req in enumerate(self.slot_req):
            if req is not None and req.tokens_out:
                tokens[i] = req.tokens_out[-1]
        dev = self.device
        toks, emit, self.state = lm.decode_span(
            self.params, torch.as_tensor(tokens, device=dev), self.state,
            self.cfg, torch.as_tensor(act, device=dev),
            torch.as_tensor(budgets, device=dev), span=span_exec,
            eos_token=self.ecfg.eos_token, cache_len=self.ecfg.cache_len,
            sample_fn=self.sampler.sample)
        self.stats["decode_steps"] += span_exec
        self.stats["decode_spans"] += 1
        # ONE blocking device->host sync per span: the stacked emissions
        # and their mask; positions come from host bookkeeping
        toks, emit = self._host_sync((toks, emit))
        for i in range(self.ecfg.slots):
            req = self.slot_req[i]
            if req is None or not act[i]:
                continue
            new = [int(t) for t in toks[emit[:, i], i]]
            req.tokens_out.extend(new)
            self.stats["decode_tokens"] += len(new)
            done = (len(req.tokens_out) >= req.max_new_tokens
                    or (len(new) and int(new[-1]) == self.ecfg.eos_token)
                    or self._slot_pos(req) >= self.ecfg.cache_len)
            if done:
                self._complete(i, req)

    def run_until_done(self, max_steps: int = 10_000):
        """Drive the engine until every submitted request completes;
        raise, naming the stranded requests, if `max_steps` runs out."""
        for _ in range(max_steps):
            if (not self.active.any() and self.sched.pending == 0
                    and self.transport.in_flight == 0):
                self.stats["pages_peak"] = self.pool.peak
                return self.completed
            self.step()
        if (not self.active.any() and self.sched.pending == 0
                and self.transport.in_flight == 0):
            return self.completed
        stranded = sorted({r.req_id for r in self.slot_req if r is not None})
        self.stats["incomplete"] = stranded
        raise RuntimeError(
            f"run_until_done exhausted max_steps={max_steps} with "
            f"{len(stranded)} request(s) still on slots "
            f"(req_ids {stranded}), {self.sched.pending} more queued and "
            f"{self.transport.in_flight} parked")
