from .mesh import (
    ACTIVE,
    Mesh,
    batch_sharding,
    get_active_mesh,
    init_distributed,
    make_mesh,
    set_active_mesh,
    shard_batch,
)
from .warp_shard import warp_proj_sharded

__all__ = [
    "ACTIVE",
    "Mesh",
    "batch_sharding",
    "get_active_mesh",
    "init_distributed",
    "make_mesh",
    "set_active_mesh",
    "shard_batch",
    "warp_proj_sharded",
]
