"""whisper-large-v3 — enc-dec with conv frontend STUB.

32L d=1280 20H (kv=20, i.e. MHA) d_ff=5120 vocab=51866. The conv/audio
frontend is a stub: ``input_specs()`` provides precomputed frame
embeddings (B, 1500, d). Assigned shapes apply to the DECODER; decoder
self-attention carries the KV cache, cross-attention attends to the
fixed 1500-frame encoder output.
[arXiv:2212.04356; unverified] — per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    enc_dec=True,
    n_encoder_layers=32,
    encoder_len=1500,
    inputs_are_embeddings=True,
    tie_embeddings=True,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions; we use rope=off
    source="arXiv:2212.04356; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    enc_dec=True,
    n_encoder_layers=2,
    encoder_len=16,
    inputs_are_embeddings=True,
    rope_theta=0.0,
)
