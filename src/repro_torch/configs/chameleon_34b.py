"""Chameleon-34B — early-fusion VLM over VQ image tokens, GQA kv=8, qk-norm.
[arXiv:2405.09818; unverified]

The VQ-GAN image tokenizer is the modality frontend and is STUBBED: the
backbone is fed precomputed discrete tokens (text + image share the
65536-entry early-fusion vocabulary), exactly as it consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,      # chameleon stabilizes early fusion with qk-norm
    act="swiglu",
    rope_theta=10_000.0,
    source="[arXiv:2405.09818; unverified]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=352, vocab_size=512)
