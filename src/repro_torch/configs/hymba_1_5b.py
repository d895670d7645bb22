"""hymba-1.5b — hybrid: parallel attention + mamba heads in each layer.

32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16; sliding
window attention (3 global layers in the real model; we use window=2048
for local layers with 1 global per 10 as a faithful small-state hybrid).
[arXiv:2411.13676; hf] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=2048,
    local_global_ratio=15,  # 2 global layers of 32
    hybrid_attn_ssm=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2411.13676; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    sliding_window=16,
    local_global_ratio=1,
    hybrid_attn_ssm=True,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=16),
    tie_embeddings=True,
)
