"""chatglm3-6b — dense, RoPE 2d, GQA kv=2 (28L d=4096 32H d_ff=13696).

[arXiv:2406.12793; hf] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    rope_theta=10_000.0,
    source="arXiv:2406.12793; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
