"""The device mesh: sharded pipeline stages over shard slots bound to
devices (port of the in-core part of sage2_tpu/parallel)."""

from sage2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from sage2_tpu_torch.parallel.sharded import (
    gather_cyclic_shards,
    gather_edge_shards,
    partition_edges_by_src,
    partition_vertex_range,
    sharded_contract_unitigs,
    sharded_correct_reads,
    sharded_count_kmers,
    sharded_find_overlaps,
    sharded_transitive_reduction,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "gather_cyclic_shards",
    "gather_edge_shards",
    "partition_edges_by_src",
    "partition_vertex_range",
    "sharded_contract_unitigs",
    "sharded_correct_reads",
    "sharded_count_kmers",
    "sharded_find_overlaps",
    "sharded_transitive_reduction",
]
