"""Nemotron-4-15B — dense, GQA kv=8, squared-ReLU MLP, 256k vocab.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    act="sq_relu",
    rope_theta=10_000.0,
    source="[arXiv:2402.16819; unverified]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=512, vocab_size=512)
