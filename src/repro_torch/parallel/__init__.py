"""Sharding of the port's trees over ``torch.distributed`` meshes.

Importing this package starts no process group and touches no device.
"""
from repro_torch.parallel.sharding import (
    STRATEGIES, Spec, batch_specs, distribute_tree, logical_rules, param_specs, placements,
    state_specs, tree_shardings,
)

__all__ = ["STRATEGIES", "Spec", "batch_specs", "distribute_tree", "logical_rules",
           "param_specs", "placements", "state_specs", "tree_shardings"]
