"""The device mesh: sharded pipeline stages over shard slots bound to
devices, in core and streamed (port of sage2_tpu/parallel)."""

from sage2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from sage2_tpu_torch.parallel.sharded import (
    gather_cyclic_shards,
    gather_edge_shards,
    gather_edge_shards_spill,
    partition_edges_by_src,
    partition_vertex_range,
    sharded_contract_unitigs,
    sharded_correct_reads,
    sharded_count_kmers,
    sharded_find_overlaps,
    sharded_transitive_reduction,
)
from sage2_tpu_torch.parallel.sharded_stream import (
    sharded_correct_reads_chunked,
    sharded_count_kmers_chunked,
    sharded_find_overlaps_chunked,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "gather_cyclic_shards",
    "gather_edge_shards",
    "gather_edge_shards_spill",
    "partition_edges_by_src",
    "partition_vertex_range",
    "sharded_contract_unitigs",
    "sharded_correct_reads",
    "sharded_correct_reads_chunked",
    "sharded_count_kmers",
    "sharded_count_kmers_chunked",
    "sharded_find_overlaps",
    "sharded_find_overlaps_chunked",
    "sharded_transitive_reduction",
]
