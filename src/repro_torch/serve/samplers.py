"""Built-in Sampler of the port: greedy.

Token selection runs on the device inside the decode span and the
prefill first-token selector, so it never adds a host sync. The
stochastic sampler waits for ROADMAP item A5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.serve.api import Request, register_sampler


@register_sampler("greedy")
class GreedySampler:
    """argmax of the raw logits — no RNG, no per-request parameters."""

    needs_rng = False

    def slot_params(self, req: Optional[Request]) -> Tuple:
        return ()

    def sample(self, logits, keys, params):
        return torch.argmax(logits, dim=-1).to(torch.int32)
