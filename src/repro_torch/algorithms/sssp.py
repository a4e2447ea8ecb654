"""Single-Source Shortest Path (paper §5.2, Algorithm 3).

The paper runs Dijkstra inside each sub-graph per superstep; here the
min-plus relaxation runs to local fixpoint — identical per-superstep
semantics (all intra-sub-graph shortest paths settle before messages go
out) and an identical, meta-graph-diameter-bounded superstep count.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, SemiringProgram, make_sssp_init
from repro_torch.gofs.formats import PartitionedGraph


def sssp(pg: PartitionedGraph, source_global: int, mode: str = "subgraph",
         backend: str = "local", mesh=None,
         spmv_backend: Optional[str] = None,
         max_local_iters: Optional[int] = None, device="cuda"):
    """Returns (distances (P, v_max) float32, inf = unreachable, Telemetry)."""
    check_options(spmv_backend)
    prog = SemiringProgram(
        semiring="min_plus",
        init_fn=make_sssp_init(int(pg.part_of[source_global]),
                               int(pg.local_of[source_global])),
        max_local_iters=(max_local_iters if mode == "subgraph" else 1))
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, device=device)
    state, tele = eng.run()
    dist = state["x"]
    dist[~pg.vmask] = np.inf
    return dist, tele
