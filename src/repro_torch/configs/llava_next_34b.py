"""llava-next-34b — VLM backbone (60L d=7168 56H GQA kv=8 d_ff=20480).

Anyres-tiling vision frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, S, d_model). Backbone is a decoder-only
transformer with an LM head over vocab 64000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    inputs_are_embeddings=True,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="llava-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    inputs_are_embeddings=True,
)
