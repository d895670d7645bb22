"""kimi-k2-1t-a32b — trillion-param MoE (61L d=7168 64H GQA kv=8, 384e top-8).

[arXiv:2501.kimi2; unverified] — per the assignment table. head_dim=112
(d_model/n_heads); experts use d_ff=2048 each (fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, ep_mode="alltoall"),
    source="arXiv:2501.kimi2; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, ep_mode="alltoall", dropless=True),
)
