"""MusicGen-large — decoder-only over EnCodec tokens, MHA kv=32.
[arXiv:2306.05284; hf]

The EnCodec audio codec is the modality frontend and is STUBBED: the
backbone is fed precomputed codec tokens (vocab 2048). The assigned
backbone is the plain decoder; codebook-interleaving (delay pattern) lives in
the frontend. RoPE substituted for sinusoidal PE (DESIGN.md §2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    rope_theta=10_000.0,
    source="[arXiv:2306.05284; hf]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      head_dim=32, d_ff=512, vocab_size=256)
