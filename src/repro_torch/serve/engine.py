"""Continuous-batching serving engine of the port: a thin driver over the
pluggable subsystems of serve/api.py.

The loop is the JAX engine's (``repro.serve.engine``): admit from the
scheduler, restore due unparks, stream one budget of page-aligned chunks
of the prompts still prefilling, run the backend's alloc-on-append pass,
reserve page headroom for the coming decode span, sync page tables, then
decode up to ``decode_span`` tokens on the device with the active mask
freezing finished and parked slots. Stop conditions (EOS, max_new_tokens,
cache_len, span budget) are evaluated on the device, and the host reads
the emitted tokens once per span. Prefill is monolithic, or with
``prefill_chunk > 0`` streamed in chunks between decode spans, so a long
prompt never holds running sequences back. Prompts that share a
page-aligned prefix with an earlier one share its blocks through the
prefix cache (page references on ``paged``, copied rows on ``dense``)
and compute only their tail. Parked slots' state (KV pages, or a
recurrent carry) really moves to host tensors and back. The loop never
branches on the layout: the backend's capability flags decide chunking
and prefix sharing, and `needs_growth` admission charges, growth, span
reservation and prefix-cache eviction.

Every read the serving loop makes off the device goes through
``_host_sync``, so ``host_syncs == prefills + decode_spans``: a prefill
chunk reads nothing back, only a finished prefill's first token (and its
logprob) does (a prefill preempted before its last chunk reads nothing
at all). Tokens are selected on the device by the sampler, with keys
derived there from ``(seed, req_id, emitted index)``; every token a
request receives passes through ``_emit``, which feeds ``tokens_out``,
``logprobs_out`` and the streaming hook from values the host already
holds, so streaming adds no sync.

Crash recovery: `snapshot` captures every field `_SNAPSHOT_FIELDS` marks
"captured" as host tensors and JSON-able scalars (the slot bookkeeping,
the scheduler's queues, the backend's pool and device state, the prefix
cache, the parked payloads, the stats and each request's key anchors),
and `restore` loads one onto a freshly built engine, writing the device
state back into the engine's own tensors; `save_snapshot` and
`load_snapshot` take the same dict through the Checkpointer's files.
Snapshots read the device with `.cpu()` copies, not `_host_sync`: they
are not a read of the serving loop, so the sync invariant holds across a
crash, counted over the restored stats.
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
                                   Sampler, Scheduler, StateBackend,
                                   make_sampler, make_scheduler,
                                   make_state_backend, request_from_state,
                                   request_to_state)
from repro_torch.serve.parking import HostParkingTransport
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.sharding.policy import NULL_POLICY, Policy


def _wrap_i32(v: int) -> np.int32:
    """An arbitrary Python int wrapped into int32 (two's complement)."""
    return np.uint32(int(v) & 0xFFFFFFFF).astype(np.int32)


SNAPSHOT_VERSION = 1


class ServingEngine:
    # Snapshot manifest, enforced by jzlint rule JZ006: every attribute
    # `__init__` assigns is declared with its recovery treatment:
    # "captured" (serialized by snapshot()), "rebuilt" (reconstructed
    # from the config at construction) or "config" (a construction
    # input that never changes).
    _SNAPSHOT_FIELDS = {
        "cfg": "config", "params": "config", "ecfg": "config",
        "device": "config", "policy": "config", "sampler": "config",
        "clock": "captured", "kv": "captured", "state": "captured",
        "sched": "captured", "transport": "captured",
        "active": "captured", "running": "captured",
        "prefilling": "captured", "prefill_pos": "captured",
        "_prefill_rr": "captured", "slot_req": "captured",
        "prefix": "captured", "_stalled": "captured",
        "completed": "captured", "stats": "captured",
        "_needs_rng": "rebuilt", "_chunked_ok": "rebuilt",
    }

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device=None, policy: Policy = NULL_POLICY,
                 scheduler: Optional[Scheduler] = None,
                 kv_backend: Optional[StateBackend] = None,
                 transport: Optional[ParkingTransport] = None,
                 sampler: Optional[Sampler] = None):
        if ecfg.prefill_chunk and ecfg.prefill_chunk % ecfg.page_size:
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} must be a page_size "
                f"({ecfg.page_size}) multiple so chunk boundaries stay "
                f"page-aligned")
        if ecfg.decode_span < 1:
            raise ValueError(
                f"decode_span must be >= 1, got {ecfg.decode_span}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(device)
        # the sharding policy every model call takes; serving runs one
        # rank
        policy.require_supported("ServingEngine", cfg)
        self.policy = policy
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
        self._needs_rng = bool(self.sampler.needs_rng)
        self.active = np.zeros(B, bool)          # slot has a sequence
        self.running = np.zeros(B, bool)         # decoding (not parked,
        #                                          not mid-prefill)
        self.prefilling = np.zeros(B, bool)      # streaming its prompt in
        self.prefill_pos = np.zeros(B, np.int64)  # prompt tokens ingested
        self._prefill_rr = 0                     # chunk-budget round-robin
        self.slot_req: List[Optional[Request]] = [None] * B
        # capability routing: the backend says whether its slot state
        # extends a chunk at a time and whether per-token blocks can back
        # the prefix cache; other layouts prefill monolithically, with
        # the cache held at capacity 0 (inert)
        self._chunked_ok = bool(self.kv.supports_chunked_prefill)
        self.prefix = PrefixCache(
            ecfg.prefix_cache_entries
            if self._chunked_ok and self.kv.supports_prefix_share else 0,
            block=ecfg.page_size,
            retain=self.kv.cache_retain, release=self.kv.cache_release)
        self._stalled: set = set()               # req_ids frozen in place
        self.completed: List[Request] = []
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "decode_spans": 0, "host_syncs": 0, "span_shrinks": 0,
                      "prefills": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "parked": 0, "unparked": 0,
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "page_allocs": 0, "pages_peak": 0,
                      "preempt_restarts": 0}

    @property
    def pool(self):
        """The StateBackend's PagePool (MTT accounting)."""
        return self.kv.pool

    def _streaming(self) -> bool:
        return bool(self.ecfg.prefill_chunk) and self._chunked_ok

    def _host_sync(self, tensors):
        """THE accounted blocking device->host transfer: one per decode
        span, one per prefill first token. Returns numpy arrays."""
        self.stats["host_syncs"] += 1
        return tuple(t.cpu().numpy() for t in tensors)

    # -- sampler inputs ----------------------------------------------------
    def _sampler_params(self, reqs: List[Optional[Request]]):
        """Per-request sampling parameters stacked into per-slot tensors
        on the device (a tuple of [len(reqs)] tensors; () for samplers
        without parameters)."""
        per = [self.sampler.slot_params(r) for r in reqs]
        if not per[0]:
            return ()
        return tuple(torch.as_tensor(np.asarray([p[j] for p in per]),
                                     device=self.device)
                     for j in range(len(per[0])))

    def _sampler_rng(self, reqs: List[Optional[Request]]):
        """(seeds, req_ids, counters) for `derive_keys`, or None for
        samplers without keys. The counter is the request's emitted-token
        count from host bookkeeping, so a parked, unparked or
        preempt-restarted request resumes its key stream exactly where
        an undisturbed run would be."""
        if not self._needs_rng:
            return None
        n = len(reqs)
        seeds = np.zeros(n, np.int32)
        rids = np.zeros(n, np.int32)
        ctrs = np.zeros(n, np.int32)
        for i, r in enumerate(reqs):
            if r is not None:
                # seeds and req_ids fold into the key modulo 2^32
                seeds[i] = _wrap_i32(r.sampling.seed)
                rids[i] = _wrap_i32(r.req_id)
                ctrs[i] = len(r.tokens_out)
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (seeds, rids, ctrs))

    # ------------------------------------------------------------------
    def try_submit(self, req: Request) -> bool:
        """Validate + enqueue; False means scheduler-queue backpressure.
        Impossible requests raise."""
        if len(req.prompt) + 1 > self.ecfg.cache_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} does not fit "
                f"cache_len {self.ecfg.cache_len} (need len+1 <= cache_len)")
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
        self.prefilling[slot] = False
        self.prefill_pos[slot] = 0
        self.slot_req[slot] = None

    def _complete(self, slot: int, req: Request):
        req.finished_at = self.clock()
        self.completed.append(req)
        self.kv.release(req.req_id)
        self._release_slot(slot)
        if req.on_done is not None:
            req.on_done(req)

    def _emit(self, req: Request, toks: List[int],
              lps: Optional[List[float]] = None):
        """The one funnel of every token a request receives (prefill
        first tokens, monolithic or chunked, and decode spans), from
        values the host holds after its one accounted sync: `on_tokens`
        sees exactly what `tokens_out` received, in order."""
        req.tokens_out.extend(toks)
        if lps is not None and req.sampling.logprobs:
            req.logprobs_out.extend(lps)
        if req.on_tokens is not None and toks:
            req.on_tokens(req, toks)

    def _admit(self) -> int:
        admitted = 0
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            req: Optional[Request] = self.sched.next()
            if req is None:
                break
            prompt = np.asarray(req.prompt, np.int32)
            matched, payloads = self.prefix.match(prompt)
            streaming = self._streaming()
            if self.kv.needs_growth:
                # charge only what this step writes: the shared prefix
                # joins by reference, the first chunk (or the whole tail
                # when not streaming) takes new pages
                first = len(prompt) - matched
                if streaming:
                    first = min(self.ecfg.prefill_chunk, first)
                n_tok = matched + first
                if n_tok == len(prompt):
                    n_tok += 1                   # first decode token
            else:
                n_tok = self.kv.footprint(req)   # reserved up front
            if matched:
                self.state = self.kv.share_prefix(
                    self.state, slot, req.req_id, payloads, matched)
            if not self._append_or_free(req.req_id, n_tok,
                                        self.sched.class_of(req)):
                self.kv.release(req.req_id)      # drop shared-prefix refs
                self.prefix.unrecord(matched)    # a retry re-matches
                self._requeue(req)               # requeue; others proceed
                break
            self.active[slot] = True
            self.running[slot] = False
            self.prefilling[slot] = True
            self.prefill_pos[slot] = matched
            self.slot_req[slot] = req
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += matched
            self.stats["prefills"] += 1
            if not streaming:
                if matched:
                    # the cached prefix is installed: compute the tail
                    # only, as one chunk
                    self._process_chunk(slot, len(prompt) - matched)
                else:
                    self._prefill_full(slot, req)
            admitted += 1
        return admitted

    def _prefill_full(self, slot: int, req: Request):
        """Monolithic prefill: run the prompt, move its K/V into the
        slot's pages, pick the first token on the device."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)
        logits, st = lm.prefill(self.params, prompt[None], self.cfg,
                                cache_len=self.ecfg.cache_len,
                                policy=self.policy)
        self.state = self.kv.prefill_into_slot(
            self.state, slot, req.req_id, st["caches"], len(req.prompt))
        self.stats["prefill_tokens"] += len(req.prompt)
        self._finish_prefill(slot, req, *self._first_token(req, logits))

    def _first_token(self, req: Request, logits):
        """Select a finished prefill's first token ON DEVICE through the
        sampler (index 0 of the request's key stream) and sync exactly
        one accounted (token, logprob) pair."""
        tok, lp = self._host_sync(lm.select_token(
            logits, self.sampler.sample, self._sampler_params([req]),
            self._sampler_rng([req])))
        return int(tok[0]), float(lp[0])

    # -- chunked prefill -------------------------------------------------
    def _prefill_step(self):
        """Stream page-aligned chunks of the prefilling slots' prompts,
        bounded by the per-step token budget, so long prompts interleave
        with decode spans. The budget is spent in whole chunks, at least
        one a step, and rotates round-robin over the slots so concurrent
        prefills share it."""
        if not self._streaming():
            return
        chunk = self.ecfg.prefill_chunk
        budget = self.ecfg.prefill_budget or chunk
        quota = max(1, budget // chunk)          # whole chunks this step
        n = self.ecfg.slots
        for k in range(n):
            i = (self._prefill_rr + k) % n
            if quota <= 0:
                break
            if not (self.active[i] and self.prefilling[i]):
                continue
            if self._process_chunk(i, chunk):
                quota -= 1
                self._prefill_rr = (i + 1) % n

    def _process_chunk(self, slot: int, width: int) -> int:
        """Ingest up to ``width`` prompt tokens of one prefilling slot.
        Returns the number of tokens processed (0 if out of pages). The
        chunk reads nothing back; the last one syncs its first token."""
        req = self.slot_req[slot]
        pos = int(self.prefill_pos[slot])
        total = len(req.prompt)
        n_valid = min(width, total - pos)
        last = pos + n_valid == total
        need = pos + n_valid + (1 if last else 0)
        if self.kv.needs_growth and not self._append_or_free(
                req.req_id, need, self.sched.class_of(req)):
            # no pages for this chunk: wait in place (decodes go on). If
            # nothing decodes and someone else waits on pages too (a
            # lower prefilling slot or a stalled decode), back off with a
            # preempt-restart so that the other side can progress
            if (not self.running.any()
                    and (self._stalled
                         or any(self.prefilling[j] and self.active[j]
                                for j in range(slot)))):
                self._preempt_restart(slot)
            return 0
        chunk = np.zeros(width, np.int32)
        chunk[:n_valid] = np.asarray(req.prompt[pos:pos + n_valid], np.int32)
        caches = self.kv.slot_caches(self.state, slot, req.req_id)
        logits, caches = lm.prefill_chunk(
            self.params, torch.as_tensor(chunk[None], device=self.device),
            caches, pos, n_valid, self.cfg, policy=self.policy)
        self.state = self.kv.store_chunk(
            self.state, slot, req.req_id, caches, pos, n_valid)
        self.prefill_pos[slot] = pos + n_valid
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += n_valid
        if last:
            self._finish_prefill(slot, req, *self._first_token(req, logits))
        return n_valid

    def _finish_prefill(self, slot: int, req: Request, first_tok: int,
                        first_lp: float):
        total = len(req.prompt)
        self.state["lengths"][slot] = total
        self.state["positions"][slot] = total
        self.prefilling[slot] = False
        self.prefill_pos[slot] = total
        self._donate_prefix(slot, req)
        self._emit(req, [first_tok], [first_lp])
        # the prefill token can already satisfy the contract
        if (len(req.tokens_out) >= req.max_new_tokens
                or first_tok == self.ecfg.eos_token):
            self._complete(slot, req)
        else:
            self.running[slot] = True

    def _donate_prefix(self, slot: int, req: Request):
        """Offer the prompt's full page-aligned blocks to the prefix
        cache (paged: page ids pinned by refcount; dense: copies of the
        blocks' rows)."""
        n_blocks = len(req.prompt) // self.ecfg.page_size
        if n_blocks <= 0 or self.prefix.capacity <= 0:
            return
        self.prefix.insert(
            np.asarray(req.prompt, np.int32), n_blocks,
            lambda b: self.kv.block_payload(self.state, slot, req.req_id, b))

    def _claim_reclaim(self, claim) -> bool:
        """Run a page-claiming thunk, dropping LRU prefix-cache blocks
        under page pressure when the backend grows: cached pages are the
        cheapest to free (a later request merely prefills its prefix
        again)."""
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
            if req is None or not self.active[i] or self.prefilling[i]:
                continue                     # chunks manage their own pages
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
        req.logprobs_out.clear()
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
        self._prefill_step()
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
            return                           # only prefilling/parked slots
        tokens = np.zeros(self.ecfg.slots, np.int32)
        for i, req in enumerate(self.slot_req):
            if req is not None and req.tokens_out:
                tokens[i] = req.tokens_out[-1]
        want_lp = any(r is not None and r.sampling.logprobs
                      for r in self.slot_req)
        dev = self.device
        out = lm.decode_span(
            self.params, torch.as_tensor(tokens, device=dev), self.state,
            self.cfg, torch.as_tensor(act, device=dev),
            torch.as_tensor(budgets, device=dev), span=span_exec,
            eos_token=self.ecfg.eos_token, cache_len=self.ecfg.cache_len,
            sample_fn=self.sampler.sample,
            sampler_params=self._sampler_params(self.slot_req),
            rng=self._sampler_rng(self.slot_req), want_logprobs=want_lp,
            policy=self.policy)
        self.state = out[-1]
        self.stats["decode_steps"] += span_exec
        self.stats["decode_spans"] += 1
        # ONE blocking device->host sync per span: the stacked emissions,
        # their mask and (when asked for) logprobs; positions come from
        # host bookkeeping
        got = self._host_sync(out[:-1])
        toks, emit = got[0], got[1]
        lps = got[2] if want_lp else None
        for i in range(self.ecfg.slots):
            req = self.slot_req[i]
            if req is None or not act[i]:
                continue
            new = [int(t) for t in toks[emit[:, i], i]]
            self._emit(req, new, None if lps is None
                       else [float(x) for x in lps[emit[:, i], i]])
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

    # -- crash recovery ----------------------------------------------------
    def _snapshot_config(self) -> dict:
        """The geometry a snapshot is only valid against — restore
        refuses a mismatch instead of silently scattering into wrongly
        shaped state."""
        e = self.ecfg
        return {"slots": int(e.slots), "cache_len": int(e.cache_len),
                "page_size": int(e.page_size), "n_pages": int(e.n_pages),
                "kv_layout": str(e.kv_layout), "scheduler": str(e.scheduler),
                "sampler": str(e.sampler), "decode_span": int(e.decode_span),
                "prefill_chunk": int(e.prefill_chunk),
                "eos_token": int(e.eos_token),
                "qos_classes": int(e.qos_classes)}

    def snapshot(self) -> dict:
        """Capture the COMPLETE engine state as host tensors and JSON-able
        scalars, every field `_SNAPSHOT_FIELDS` marks "captured": slot
        bookkeeping, scheduler queues, the device state with the page
        tables and refcounts, prefix-cache chains, parked host-tier
        payloads, stats, and the key anchors (per-request seeds and
        emitted counts travel inside the serialized Requests). Reads
        nothing through `_host_sync`: a snapshot is not a read of the
        serving loop, so it must not move the `host_syncs == prefills +
        decode_spans` invariant it is later checked against."""
        queues, aux = self.sched.export()
        return {
            "version": SNAPSHOT_VERSION,
            "config": self._snapshot_config(),
            "clock_t": float(self.clock()),
            "active": [bool(x) for x in self.active],
            "running": [bool(x) for x in self.running],
            "prefilling": [bool(x) for x in self.prefilling],
            "prefill_pos": [int(x) for x in self.prefill_pos],
            "prefill_rr": int(self._prefill_rr),
            "slot_req": [None if r is None else request_to_state(r)
                         for r in self.slot_req],
            "stalled": sorted(int(x) for x in self._stalled),
            "sched": {"queues": [[request_to_state(r) for r in q]
                                 for q in queues],
                      "aux": dict(aux)},
            "completed": [request_to_state(r) for r in self.completed],
            "stats": {k: (list(v) if isinstance(v, list) else int(v))
                      for k, v in self.stats.items()},
            "kv": self.kv.export_state(self.state),
            "transport": self.transport.export_state(),
            "prefix": self.prefix.export_state(self.kv.snapshot_payload),
        }

    def restore(self, snap: dict) -> None:
        """Load a `snapshot()` onto this (freshly constructed) engine.

        After restore the engine is step-for-step identical to the
        snapshotted one: same slot/queue/pool/prefix state, same device
        state bits (written into this engine's own tensors, on its
        device), same key anchors, so the continued token streams are
        byte-identical to a run that never crashed."""
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {snap.get('version')!r} != engine "
                f"version {SNAPSHOT_VERSION}")
        want = self._snapshot_config()
        have = {k: snap["config"].get(k) for k in want}
        if have != want:
            diff = {k: (have[k], want[k]) for k in want
                    if have[k] != want[k]}
            raise ValueError(
                f"snapshot config mismatch (snapshot vs engine): {diff}")
        self.state = self.kv.import_state(snap["kv"], self.state)
        self.transport.import_state(snap["transport"])
        self.prefix.import_state(snap["prefix"], self.kv.restore_payload)
        self.sched.import_(
            [[request_from_state(d) for d in q]
             for q in snap["sched"]["queues"]],
            dict(snap["sched"]["aux"]))
        self.active = np.asarray(snap["active"], bool)
        self.running = np.asarray(snap["running"], bool)
        self.prefilling = np.asarray(snap["prefilling"], bool)
        self.prefill_pos = np.asarray(snap["prefill_pos"], np.int64)
        self._prefill_rr = int(snap["prefill_rr"])
        self.slot_req = [None if d is None else request_from_state(d)
                         for d in snap["slot_req"]]
        self._stalled = set(int(x) for x in snap["stalled"])
        self.completed = [request_from_state(d) for d in snap["completed"]]
        self.stats = {k: (list(v) if isinstance(v, list) else int(v))
                      for k, v in snap["stats"].items()}
        # never rewind the injected clock: in-process recovery keeps time
        # monotonic, while a fresh process fast-forwards to the snapshot
        # time so parked-payload bus deadlines stay reachable
        if hasattr(self.clock, "t"):
            self.clock.t = max(float(self.clock()), float(snap["clock_t"]))

    def live_requests(self) -> dict:
        """req_id -> Request for every request the engine still owns
        (on a slot or queued) — what a frontend reattaches its streaming
        handles to after a restore."""
        out = {r.req_id: r for r in self.slot_req if r is not None}
        queues, _ = self.sched.export()
        for q in queues:
            for r in q:
                out[r.req_id] = r
        return out

    def replay_from_zero(self, slot: int) -> None:
        """The recompute recovery policy for one slot: drop its restored
        state and any parked host copy, requeue the request for a
        from-scratch prefill. Streams stay byte-identical because the
        front end's handle dedupes by emitted index and the sampler's
        keys replay from `len(tokens_out)`."""
        req = self.slot_req[slot]
        if req is None:
            return
        try:
            self.transport.complete(req.req_id)
        except KeyError:
            pass
        self._preempt_restart(slot)

    def save_snapshot(self, ckpt, step: int, blocking: bool = True) -> None:
        """Persist `snapshot()` through the Checkpointer's manifest format
        (checkpoint/checkpointer.py): tensor leaves go to the npz shard,
        the JSON-able skeleton rides in the manifest's `extra`."""
        from repro_torch.checkpoint.checkpointer import pack_tree
        leaves, meta = pack_tree(self.snapshot())
        ckpt.save(step, leaves, extra={"engine_snapshot": meta},
                  blocking=blocking)

    def load_snapshot(self, ckpt, step: Optional[int] = None) -> dict:
        """Restore this engine from the latest (or given) persisted
        snapshot; returns the decoded snapshot dict."""
        from repro_torch.checkpoint.checkpointer import unpack_tree
        meta, leaves = ckpt.load(step)
        snap = unpack_tree(meta["extra"]["engine_snapshot"], leaves)
        self.restore(snap)
        return snap
