"""Architecture registry of the port: ``--arch <id>`` resolution.

Every config of ``repro.configs.registry`` the port serves, in the
reference's order: the dense family (qwen1.5-4b, nemotron-4-15b,
qwen3-8b, h2o-danube-3-4b, and the token-stream backbones chameleon-34b
and musicgen-large), moonshot-v1-16b-a3b (attention with 64-expert MoE
MLPs), deepseek-v2-lite-16b (MLA attention with 64-expert MoE MLPs),
rwkv6-1.6b (RWKV-6) and jamba-v0.1-52b (Mamba + attention + MoE
hybrid): all ten.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite_16b,
                                 h2o_danube_3_4b, jamba_v0_1_52b,
                                 moonshot_v1_16b_a3b, musicgen_large,
                                 nemotron_4_15b, qwen1_5_4b, qwen3_8b,
                                 rwkv6_1_6b)
from repro_torch.configs.base import ModelConfig

_MODULES = (qwen1_5_4b, nemotron_4_15b, qwen3_8b, h2o_danube_3_4b,
            moonshot_v1_16b_a3b, deepseek_v2_lite_16b, chameleon_34b,
            rwkv6_1_6b, musicgen_large, jamba_v0_1_52b)

CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}
ARCH_NAMES: Tuple[str, ...] = tuple(CONFIGS)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]
