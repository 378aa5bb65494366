"""Load generator of the port: timed arrival traces for the serving front
end, as ``repro.serve.loadgen``.

Produces `(arrival_time, Request)` events for `Frontend.run` — the
client side of a live-traffic evaluation. Two arrival processes:

- ``poisson``: memoryless open-loop arrivals at `rate` requests per
  clock unit (exponential inter-arrival gaps) — the line-rate steady
  state.
- ``bursty``: clumped arrivals — clump sizes are geometric with mean
  `burst`, clump gaps exponential with mean `burst / rate`, tokens
  inside a clump nearly simultaneous. Mean rate stays `rate`; the
  instantaneous rate spikes, which is what stresses bounded admission
  queues and SLO budgets.

Prompt and output lengths draw from configurable *mixtures* — weighted
`(weight, lo, hi)` uniform components — so a ShareGPT-like skew (many
short chats, a heavy tail of long contexts) is two components, not a
dataset dependency. Everything is driven by one numpy Generator seed:
the same spec replays the identical trace, which the virtual-clock
benchmarks and tests rely on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from repro_torch.serve.api import Request, SamplingParams

# a length mixture: ((weight, lo, hi), ...) — uniform ints in [lo, hi]
# per component, components chosen by normalized weight
Mixture = Tuple[Tuple[float, int, int], ...]


@dataclass
class TraceSpec:
    arrival: str = "poisson"            # "poisson" | "bursty"
    rate: float = 1.0                   # mean requests per clock unit
    burst: float = 8.0                  # bursty: mean clump size
    burst_spread: float = 1e-3          # bursty: intra-clump spacing
    prompt_lens: Mixture = ((1.0, 8, 32),)
    output_lens: Mixture = ((1.0, 4, 16),)
    qos_weights: Tuple[float, ...] = (1.0,)   # arrival mix over classes
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seed: int = 0


def _draw_len(rng: np.random.Generator, mix: Mixture) -> int:
    w = np.asarray([m[0] for m in mix], float)
    k = int(rng.choice(len(mix), p=w / w.sum()))
    _, lo, hi = mix[k]
    return int(rng.integers(lo, hi + 1))


def _arrival_times(rng: np.random.Generator, spec: TraceSpec,
                   n: int, t0: float) -> np.ndarray:
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / spec.rate, size=n)
        return t0 + np.cumsum(gaps)
    if spec.arrival == "bursty":
        times = []
        t = t0
        while len(times) < n:
            t += rng.exponential(spec.burst / spec.rate)   # clump gap
            size = int(rng.geometric(1.0 / max(spec.burst, 1.0)))
            for k in range(min(size, n - len(times))):
                times.append(t + k * spec.burst_spread)
            t = times[-1]
        return np.asarray(times[:n])
    raise ValueError(f"unknown arrival process {spec.arrival!r}; "
                     f"use 'poisson' or 'bursty'")


def make_trace(spec: TraceSpec, n_requests: int, vocab_size: int,
               t0: float = 0.0, start_id: int = 0
               ) -> List[Tuple[float, Request]]:
    """A deterministic timed trace: `n_requests` events sorted by
    arrival time, request ids `start_id..start_id + n - 1` in arrival
    order (prompt tokens in [1, vocab_size))."""
    rng = np.random.default_rng(spec.seed)
    times = _arrival_times(rng, spec, n_requests, t0)
    qw = np.asarray(spec.qos_weights, float)
    events: List[Tuple[float, Request]] = []
    for i, t in enumerate(times):
        qos = int(rng.choice(len(qw), p=qw / qw.sum()))
        prompt = rng.integers(
            1, vocab_size, size=_draw_len(rng, spec.prompt_lens)
        ).astype(np.int32)
        events.append((float(t), Request(
            start_id + i, prompt,
            max_new_tokens=_draw_len(rng, spec.output_lens),
            qos=qos, sampling=spec.sampling)))
    return events
