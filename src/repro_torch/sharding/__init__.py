from repro_torch.sharding.annotations import (
    axis_rules,
    current_mesh,
    shard,
    logical_to_spec,
    spec_to_placements,
)
from repro_torch.sharding import rules

__all__ = ["axis_rules", "current_mesh", "shard", "logical_to_spec",
           "spec_to_placements", "rules"]
