"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer pattern per Jamba paper: period 8 with one attention layer (index 4),
MoE applied every other layer (period 2).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, n_shared=0,
                  moe_layer_period=2, first_dense=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    rope_theta=10_000.0,
    source="[arXiv:2403.19887; hf]",
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=256, n_shared=0,
                  moe_layer_period=2, first_dense=1),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
)
