"""Sharding in one process (the counterpart of ``repro.distributed``):
the mesh, its shard groups and collectives, the distribution context,
the sharding rules and shardings, the sequence-sharded decode attention
and the page-sharded serving attention with their exact log-sum-exp
merge, and the expert-parallel MoE."""
from repro_torch.distributed.context import (CollectiveLog, DistContext,
                                             Mesh, ShardedTensor, ShardGroup,
                                             current, flag,
                                             make_serving_devices, place,
                                             use_dist)
from repro_torch.distributed.flash_decode import (lse_merge,
                                                  sharded_decode_attention,
                                                  sharded_msa_fused,
                                                  sharded_pool_ops)
from repro_torch.distributed.moe_ep import moe_ffn_alltoall
from repro_torch.distributed.sharding import (WEIGHT_AXES, batch_shardings,
                                              decode_state_shardings,
                                              dist_flags, effective_config,
                                              make_context, opt_shardings,
                                              param_axes, param_shardings,
                                              serving_param_shardings,
                                              shard_params, sharding_rules)

__all__ = ["CollectiveLog", "DistContext", "Mesh", "ShardGroup",
           "ShardedTensor", "WEIGHT_AXES", "batch_shardings", "current",
           "decode_state_shardings", "dist_flags", "effective_config",
           "flag", "lse_merge", "make_context", "make_serving_devices",
           "moe_ffn_alltoall", "opt_shardings", "param_axes",
           "param_shardings", "place", "serving_param_shardings",
           "shard_params", "sharded_decode_attention", "sharded_msa_fused",
           "sharded_pool_ops", "sharding_rules", "use_dist"]
