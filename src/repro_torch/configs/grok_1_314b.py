"""grok-1-314b — MoE 8 experts top-2 (64L d=6144 48H GQA kv=8 d_ff=32768).

[hf:xai-org/grok-1; unverified] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    rope_theta=10_000.0,
    attn_logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2, ep_mode="local"),
    source="hf:xai-org/grok-1; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="grok-1-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    attn_logit_softcap=30.0,
    moe=MoEConfig(num_experts=4, top_k=2, ep_mode="local", dropless=True),
)
