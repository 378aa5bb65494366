"""The fault-tolerant trainer (``repro.ft.manager``): the Transport
Subsystem at step scale.

A data-parallel worker can fail while computing its microbatch of a step
(drawn with ``FTConfig.failure_rate`` from ``random.Random(seed)``, the
reference's draws in the reference's order). Recovery (paper §4.4):

  GBN ("go-back-N"): restore the last checkpoint and replay every step
      since.
  SR  ("selective repeat"): the data pipeline regenerates any (step,
      rank) microbatch, so only the lost microbatch is recomputed and
      added to the gradient sum last.

Stragglers (a worker slower than ``straggler_factor`` x the median) are
counted as reassigned to a backup. Workers are microbatch slices of one
process, as in the reference. Times come from ``core/timing.py``.

``grad_fn(params, tokens)`` returns (grads, metrics) and ``update_fn(
grads, opt_state, params)`` (params, opt_state, metrics); tokens reach
``grad_fn`` as int32 tensors on ``device``. The port's AdamW updates
params and state in place, so a caller that runs twice from the same
params hands each run its own copy.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.device import resolve_device
from repro_torch.core.timing import Timer
from repro_torch.core.transport import gbn_recovery_plan, sr_recovery_plan
from repro_torch.core.tree import map_tree


@dataclass
class FTConfig:
    policy: str = "sr"              # sr | gbn
    failure_rate: float = 0.0       # per-microbatch
    checkpoint_every: int = 50
    straggler_factor: float = 3.0
    seed: int = 0


@dataclass
class FTStats:
    steps: int = 0
    failures: int = 0
    microbatches_recomputed: int = 0
    steps_replayed: int = 0
    checkpoints_restored: int = 0
    stragglers_reassigned: int = 0
    wall_s: float = 0.0


class FaultTolerantTrainer:
    """Wraps grad_fn and update_fn with failure injection and recovery."""

    def __init__(self, grad_fn: Callable, update_fn: Callable,
                 dataset, checkpointer: Checkpointer, cfg: FTConfig,
                 n_workers: int = 4, device=None):
        self.grad_fn = grad_fn
        self.update_fn = update_fn
        self.data = dataset
        self.ckpt = checkpointer
        self.cfg = cfg
        self.n_workers = n_workers
        self.device = resolve_device(device)
        self.rng = random.Random(cfg.seed)
        self.stats = FTStats()
        self._worker_times: List[List[float]] = [[] for _ in range(n_workers)]

    def _maybe_fail(self) -> bool:
        return self.rng.random() < self.cfg.failure_rate

    def _worker_grads(self, params, tokens_mb: np.ndarray, worker: int):
        t = Timer()
        g, m = self.grad_fn(params, torch.as_tensor(tokens_mb,
                                                    device=self.device))
        dt = t.elapsed()
        self._worker_times[worker].append(dt)
        return g, m, dt

    @staticmethod
    def _add(acc, g):
        return g if acc is None else map_tree(torch.add, acc, g)

    def step(self, params, opt_state, step_idx: int):
        """One step; (None, None, {"failed_step"}) when GBN abandons it."""
        tokens, _ = self.data.batch_at(step_idx)
        mbs = np.array_split(tokens, self.n_workers)
        grads_acc = None
        metrics: Dict[str, Any] = {}
        failed: List[int] = []
        times: List[float] = []
        for w, mb in enumerate(mbs):
            if self._maybe_fail():
                failed.append(w)
                self.stats.failures += 1
                continue
            g, metrics, dt = self._worker_grads(params, mb, w)
            times.append(dt)
            grads_acc = self._add(grads_acc, g)

        if failed:
            if self.cfg.policy != "sr":
                return None, None, {"failed_step": step_idx}
            plan = sr_recovery_plan(failed)
            self.stats.microbatches_recomputed += plan.microbatches_recomputed
            for w in failed:
                g, metrics, _ = self._worker_grads(params, mbs[w], w)
                grads_acc = self._add(grads_acc, g)

        if times:
            med = float(np.median(times))
            self.stats.stragglers_reassigned += sum(
                t > self.cfg.straggler_factor * med for t in times)

        grads = map_tree(lambda g: g / self.n_workers, grads_acc)
        params, opt_state, opt_metrics = self.update_fn(
            grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    def run(self, params, opt_state, n_steps: int
            ) -> Tuple[Any, Any, FTStats]:
        """Train ``n_steps`` steps; GBN restores the last checkpoint (the
        caller saves step 0 first) and replays."""
        wall = Timer()
        step_idx = 0
        last_ckpt = 0
        while step_idx < n_steps:
            out = self.step(params, opt_state, step_idx)
            if out[0] is None:
                plan = gbn_recovery_plan(step_idx, last_ckpt)
                self.stats.checkpoints_restored += plan.checkpoints_restored
                self.stats.steps_replayed += plan.steps_replayed
                (params, opt_state), _ = self.ckpt.restore(
                    (params, opt_state))
                self.data.load_state_dict({"step": last_ckpt})
                step_idx = last_ckpt
                continue
            params, opt_state, _ = out
            step_idx += 1
            self.stats.steps += 1
            if step_idx % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step_idx, (params, opt_state), blocking=False)
                last_ckpt = step_idx
        self.ckpt.wait()
        self.stats.wall_s = wall.elapsed()
        return params, opt_state, self.stats
