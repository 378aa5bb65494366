"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64e top-6, GQA kv=16.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Follows the assigned pool line verbatim (48L, d_ff=1408, 64e top-6). Note:
the analytic total from these numbers is ~28B, not 16B as the model name
suggests (the released Moonlight uses 27 layers); we implement the assigned
cell, not the HF checkpoint. See DESIGN.md §6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=1),
    rope_theta=50_000.0,
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=96, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                  first_dense=1),
)
