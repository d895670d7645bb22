"""granite-3-8b — dense GQA kv=8 (40L d=4096 32H d_ff=12800 vocab=49155).

[hf:ibm-granite/granite-3.0-2b-base; hf] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
)
