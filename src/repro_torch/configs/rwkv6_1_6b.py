"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # d_model / rwkv.head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,         # channel-mix hidden
    vocab_size=65536,
    attn_free=True,
    rwkv=RWKVConfig(head_dim=64),
    source="[arXiv:2404.05892; unverified]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=512,
                      rwkv=RWKVConfig(head_dim=32))
