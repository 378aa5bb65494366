"""Qwen1.5-4B — dense, MHA (kv=heads=20), QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    rope_theta=5_000_000.0,
    source="[hf:Qwen/Qwen1.5-4B; hf]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      head_dim=32, d_ff=352, vocab_size=512)
