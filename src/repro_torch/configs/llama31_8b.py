"""Llama 3.1-8B — the paper's small evaluation model (Table 1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="paper Table 1",
)

SMOKE_CONFIG = ModelConfig(
    name="llama31-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
