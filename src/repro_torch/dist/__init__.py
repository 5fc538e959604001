"""repro_torch.dist: distributed execution (port of ``repro.dist``):
logical-axis sharding rules resolved to DTensor placements (``sharding``),
the int8 error-feedback gradient all-reduce (``compress``) and preemption /
straggler handling (``fault``).

The reference's ``compat`` (a jax<0.5 mesh-API shim) has no counterpart:
torch's ``DeviceMesh`` needs none.
"""
from repro_torch.dist import compress, fault, sharding
from repro_torch.dist.sharding import (RULES, current_mesh, distribute_tree,
                                       named_sharding, override_rules,
                                       placements_for, shard, spec_for,
                                       tree_shardings, use_mesh)

__all__ = [
    "RULES", "compress", "current_mesh", "distribute_tree", "fault",
    "named_sharding", "override_rules", "placements_for", "shard",
    "sharding", "spec_for", "tree_shardings", "use_mesh",
]
