"""gemma3-12b — dense, 5:1 local:global attention, 128k context.

48L d=3840 16H GQA kv=8 d_ff=15360 vocab=262144; head_dim=256 (public
gemma-3 configs use 256); sliding window 1024 for local layers.
[hf:google/gemma-3-1b-pt; unverified] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_ratio=5,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=6,  # one full 5:1 local:global period
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=16,
    local_global_ratio=5,
    tie_embeddings=True,
)
