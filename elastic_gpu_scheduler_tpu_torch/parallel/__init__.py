"""Parallelism: the 6-axis mesh from the scheduler's allocation, process
groups, collectives, sharding rules and ring attention."""

from .mesh import AXES, MeshSpec, make_mesh, mesh_from_allocation
from .ring import ring_attention, ring_attention_sharded

__all__ = [
    "AXES", "MeshSpec", "make_mesh", "mesh_from_allocation",
    "ring_attention", "ring_attention_sharded",
]
