"""DeepSeek-V2-Lite (16B) — MLA kv_lora=512, MoE 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]

The reference's config line reads "2 shared+160 routed top-6"; 160 routed
is V2-full, and the 64 experts here match V2-Lite, as in the reference.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,     # MLA: latent-shared KV; kept for bookkeeping only
    head_dim=128,
    d_ff=10944,        # dense first layer FFN
    vocab_size=102400,
    act="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=1),
    rope_theta=10_000.0,
    source="[arXiv:2405.04434; hf]",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=384, vocab_size=512,
    mla=MLAConfig(kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=32,
                  qk_rope_dim=16, v_head_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1, first_dense=1),
)
