"""GoFS: the graph containers, generators, partitioners, the slice-file
store and its versioned edge deltas (numpy, host side) — the port's own
copies of the JAX package's ``gofs`` modules."""
from repro_torch.gofs.formats import (Graph, PartitionedGraph,
                                      dedupe_edges_min, ell_from_csr,
                                      partition_graph,
                                      partitioned_graph_from_fields)
from repro_torch.gofs.generators import (powerlaw_social, random_graph,
                                         road_grid, trace_star)
from repro_torch.gofs.partition import (bfs_grow_partition, hash_partition,
                                        subgraph_balanced_partition)
from repro_torch.gofs.store import GoFSStore
from repro_torch.gofs.temporal import (DeltaResult, DeltaValidationError,
                                       EdgeDelta, TemporalStore, apply_delta,
                                       validate_delta)

__all__ = [
    "Graph", "PartitionedGraph", "ell_from_csr", "dedupe_edges_min",
    "partition_graph", "partitioned_graph_from_fields",
    "road_grid", "powerlaw_social", "trace_star", "random_graph",
    "hash_partition", "bfs_grow_partition", "subgraph_balanced_partition",
    "GoFSStore", "TemporalStore", "EdgeDelta", "DeltaResult", "apply_delta",
    "DeltaValidationError", "validate_delta",
]
