"""H2O-Danube3-4B — dense llama/mistral mix, GQA kv=8, sliding-window attn.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,      # d_model / n_heads
    d_ff=10240,
    vocab_size=32000,
    act="swiglu",
    swa_window=4096,   # mistral-style sliding window => sub-quadratic decode
    rope_theta=10_000.0,
    source="[arXiv:2401.16818; unverified]",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=320, vocab_size=512, swa_window=64)
