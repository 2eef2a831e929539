"""Logical-axis sharding rules of the port (``repro_torch.sharding.rules``)."""
from repro_torch.sharding.rules import (AxisRules, NamedSharding, P,
                                        PartitionSpec, current_mesh,
                                        current_rules, local_config,
                                        local_slice, logical_constraint,
                                        logical_sharding, model_copy,
                                        model_gather, model_sum, param_sharding_tree,
                                        shape_aware_sharding_tree,
                                        shard_start, tensor_parallel,
                                        tp_rules, use_mesh)

__all__ = ["AxisRules", "NamedSharding", "P", "PartitionSpec", "current_mesh",
           "current_rules", "local_config", "local_slice",
           "logical_constraint", "logical_sharding", "model_copy",
           "model_gather", "model_sum", "param_sharding_tree", "shape_aware_sharding_tree",
           "shard_start", "tensor_parallel", "tp_rules", "use_mesh"]
