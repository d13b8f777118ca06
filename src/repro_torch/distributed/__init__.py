"""Distribution layer: mesh axes, logical sharding rules, the sharded
step's collectives, and gradient compression."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES,
    logical_to_mesh_spec,
    shard_constraint,
    set_rules,
    get_rules,
)
