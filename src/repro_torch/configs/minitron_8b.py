"""minitron-8b — pruned nemotron, dense GQA kv=8 (32L d=4096 32H d_ff=16384).

[arXiv:2407.14679; hf] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    rope_theta=10_000.0,
    source="arXiv:2407.14679; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="minitron-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
)
