"""PPU / Stage / Pipeline, the paper's dataflow model (Fig. 4)
(``repro.core.pipeline``).

A PPU (Protocol Processing Unit) is a named function over a payload.
PPUs chain into a Stage; heterogeneous Stages form a Pipeline. The model
blocks follow this structure implicitly (norm -> mixer -> residual ->
mlp); this module makes it explicit, and gives each PPU cost hooks so a
pipeline's throughput is its slowest stage, the paper's §6.1 analysis:
``bound_stage`` prices each stage on one NVIDIA H100 80GB HBM3 at its
700 W power limit, ``HBM_BYTES_PER_S`` and ``BF16_FLOPS_PER_S`` being
NVIDIA's data-sheet peaks for the SXM part (3.35 TB/s of HBM, 989
TFLOP/s dense bf16), as ``kernels/work.py`` holds them. ``measure_ppu``
times one PPU: CUDA events on the card, the port's clock on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core.timing import Timer
from repro_torch.kernels.work import HBM_BYTES_PER_S, PEAK_FLOPS

BF16_FLOPS_PER_S = PEAK_FLOPS["bfloat16"]


@dataclass(frozen=True)
class PPU:
    """A named function payload -> payload."""
    name: str
    fn: Callable[..., Any]
    # analytic per-call cost hooks for the throughput model (optional)
    bytes_per_call: Callable[[Any], float] = lambda _: 0.0
    flops_per_call: Callable[[Any], float] = lambda _: 0.0
    replicas: int = 1   # paper §3.2.2: replicate PPUs in a stage

    def __call__(self, payload, **kw):
        return self.fn(payload, **kw)


@dataclass
class Stage:
    """One or more PPUs applied in sequence; one pipeline step."""
    name: str
    ppus: List[PPU]

    def __call__(self, payload, **kw):
        for ppu in self.ppus:
            payload = ppu(payload, **kw)
        return payload


@dataclass
class Pipeline:
    """Chained stages. ``jit()`` returns a callable that runs them.

    Throughput model (paper §6.1): a pipeline is bound by its slowest
    stage; ``bound_stage(payload)`` evaluates the cost hooks to name it.
    """
    name: str
    stages: List[Stage] = field(default_factory=list)

    def add(self, stage: Stage) -> "Pipeline":
        self.stages.append(stage)
        return self

    def __call__(self, payload, **kw):
        for st in self.stages:
            payload = st(payload, **kw)
        return payload

    def jit(self) -> Callable:
        """The stages as one callable (eager: each PPU runs as written)."""
        return self.__call__

    def bound_stage(self, payload) -> Tuple[str, float]:
        """(name, seconds) of the slowest stage: each PPU at the larger
        of its bytes over the H100's HBM rate and its operations over its
        dense bf16 rate, divided by its replicas."""
        worst, t_worst = "", -1.0
        for st in self.stages:
            t = 0.0
            for ppu in st.ppus:
                t += max(ppu.bytes_per_call(payload) / HBM_BYTES_PER_S,
                         ppu.flops_per_call(payload) / BF16_FLOPS_PER_S
                         ) / max(ppu.replicas, 1)
            if t > t_worst:
                worst, t_worst = st.name, t
        return worst, t_worst


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def measure_ppu(fn: Callable, *args, iters: int = 20, warmup: int = 3,
                **kw) -> float:
    """µs a call of ``fn(*args, **kw)`` after ``warmup`` calls: CUDA
    events around ``iters`` calls when a tensor argument is on the card,
    else the port's clock."""
    if _on_cuda(args):
        for _ in range(warmup):
            fn(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    for _ in range(warmup):
        fn(*args, **kw)
    t = Timer()
    for _ in range(iters):
        fn(*args, **kw)
    return t.elapsed() / iters * 1e6
