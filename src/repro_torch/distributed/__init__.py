"""Sharded serving in one process (the counterpart of
``repro.distributed``'s serving parts): the shard group and its
collectives, the weight split, and the page-sharded attention with its
exact log-sum-exp merge."""
from repro_torch.distributed.context import ShardGroup, make_serving_devices
from repro_torch.distributed.flash_decode import (lse_merge,
                                                  sharded_msa_fused,
                                                  sharded_pool_ops)
from repro_torch.distributed.sharding import (WEIGHT_AXES, param_axes,
                                              serving_param_shardings,
                                              shard_params, sharding_rules)

__all__ = ["ShardGroup", "WEIGHT_AXES", "lse_merge", "make_serving_devices",
           "param_axes", "serving_param_shardings", "shard_params",
           "sharded_msa_fused", "sharded_pool_ops", "sharding_rules"]
