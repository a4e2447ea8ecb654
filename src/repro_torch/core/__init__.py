"""Gopher: the sub-graph centric BSP engine (the paper's core contribution)."""
from repro_torch.core.blocks import (device_block, graph_block,
                                     host_graph_block, patch_host_block,
                                     verify_host_block)
from repro_torch.core.engine import GopherEngine, Telemetry, resolve_device
from repro_torch.core.programs import (PageRankProgram, SemiringProgram,
                                       init_max_vertex, make_bfs_init,
                                       make_sssp_init)
from repro_torch.core.subgraph import (meta_diameter, meta_graph,
                                       subgraph_sizes, vertex_diameter)
from repro_torch.core.tiers import (PhasedTierPlan, TierPlan, TierSchedule,
                                    announce_frontier, expected_horizon,
                                    update_changed_profile,
                                    update_phase_profile, update_profile)

__all__ = [
    "GopherEngine", "Telemetry", "resolve_device", "graph_block",
    "host_graph_block", "device_block", "patch_host_block",
    "verify_host_block",
    "SemiringProgram", "PageRankProgram",
    "init_max_vertex", "make_sssp_init", "make_bfs_init",
    "meta_graph", "meta_diameter", "vertex_diameter", "subgraph_sizes",
    "TierPlan", "PhasedTierPlan", "TierSchedule", "announce_frontier",
    "expected_horizon", "update_profile", "update_changed_profile",
    "update_phase_profile",
]
