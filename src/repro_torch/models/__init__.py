from repro_torch.models.model import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    prep_cross_attention,
    shard_decode_state,
)

__all__ = [
    "decode_step", "forward", "init_decode_state", "init_params",
    "loss_fn", "prep_cross_attention", "shard_decode_state",
]
