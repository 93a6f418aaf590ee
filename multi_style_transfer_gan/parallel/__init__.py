"""Mesh / sharding utilities: the distributed layer of the framework.

The reference has no distributed code at all (single `.to(device)`,
SURVEY.md §5.8); data parallelism over the devices of a host is a
first-class addition here.
"""

from .mesh import (
    make_mesh, make_mesh_for_batch, data_sharding, replicated, shard_batch, replicate_tree,
    local_batch_size,
)
from .spatial import spatial_mesh, spatial_apply

__all__ = [
    "make_mesh", "make_mesh_for_batch", "data_sharding", "replicated", "shard_batch",
    "replicate_tree", "local_batch_size", "spatial_mesh", "spatial_apply",
]
