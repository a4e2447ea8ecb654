"""Paper §5 algorithms on the fused-superstep route, and their incremental
re-convergence after an edge delta."""
from repro_torch.algorithms.bfs import bfs
from repro_torch.algorithms.connected_components import connected_components
from repro_torch.algorithms.incremental import (
    incremental_bfs, incremental_connected_components, incremental_sssp,
    incremental_sssp_batched)
from repro_torch.algorithms.max_vertex import max_vertex
from repro_torch.algorithms.pagerank import blockrank, pagerank
from repro_torch.algorithms.sssp import sssp

__all__ = ["connected_components", "sssp", "pagerank", "blockrank", "bfs",
           "max_vertex", "incremental_sssp", "incremental_bfs",
           "incremental_connected_components", "incremental_sssp_batched"]
