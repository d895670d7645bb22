"""mamba2-780m — attention-free SSM, SSD (state-space duality).

48L d=1536 (d_inner=3072, 48 heads of dim 64), ssm_state=128, vocab=50280.
[arXiv:2405.21060; unverified] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=16),
    tie_embeddings=True,
)
