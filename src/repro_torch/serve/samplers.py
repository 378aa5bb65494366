"""Built-in Samplers of the port: greedy and stochastic.

Token selection runs on the device inside the decode span and the
prefill first-token selector, so it never adds a host sync. `stochastic`
is temperature -> top-k -> top-p -> categorical (kernels/sampling.py),
whose `temperature <= 0` rows are exact greedy, so mixed batches take
one code path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import sampling as ks
from repro_torch.serve.api import Request, SamplingParams, register_sampler

_DEFAULTS = SamplingParams()


@register_sampler("greedy")
class GreedySampler:
    """argmax of the raw logits — no RNG, no per-request parameters."""

    needs_rng = False

    def slot_params(self, req: Optional[Request]) -> Tuple:
        return ()

    def sample(self, logits, keys, params):
        return torch.argmax(logits, dim=-1).to(torch.int32)


@register_sampler("stochastic")
class StochasticSampler:
    """Per-slot temperature / top-k / top-p sampling with replayable
    `(seed, req_id, token_index)` keys (kernels/sampling.derive_keys)."""

    needs_rng = True

    def slot_params(self, req: Optional[Request]) -> Tuple:
        sp = req.sampling if req is not None else _DEFAULTS
        return (np.float32(sp.temperature), np.int32(sp.top_k),
                np.float32(sp.top_p))

    def sample(self, logits, keys, params):
        temperature, top_k, top_p = params
        return ks.sample_logits(logits, keys, temperature, top_k, top_p)
