"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the configs the port serves so far are listed: qwen3-8b (dense
attention), rwkv6-1.6b (RWKV-6), moonshot-v1-16b-a3b (attention with
64-expert MoE MLPs) and jamba-v0.1-52b (Mamba + attention + MoE hybrid).
Later slices add the rest of ``repro.configs.registry``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (jamba_v0_1_52b, moonshot_v1_16b_a3b,
                                 qwen3_8b, rwkv6_1_6b)
from repro_torch.configs.base import ModelConfig

_MODULES = (qwen3_8b, rwkv6_1_6b, moonshot_v1_16b_a3b,
            jamba_v0_1_52b)

CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}
ARCH_NAMES: Tuple[str, ...] = tuple(CONFIGS)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]
