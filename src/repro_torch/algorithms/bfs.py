"""BFS levels = SSSP over unit weights (paper §5.4 traversal class)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, SemiringProgram, make_bfs_init
from repro_torch.gofs.formats import PartitionedGraph


def bfs(pg: PartitionedGraph, source_global: int, mode: str = "subgraph",
        backend: str = "local", mesh=None,
        spmv_backend: Optional[str] = None,
        max_local_iters: Optional[int] = None, device="cuda"):
    """Returns (levels (P, v_max) float32 — hop counts, inf unreachable,
    Telemetry). Requires the graph to have been built with unit weights.
    mode='vertex' runs one sweep per superstep; ``max_local_iters`` bounds
    the sub-graph mode's local fixpoint."""
    check_options(spmv_backend)
    prog = SemiringProgram(
        semiring="min_plus",
        init_fn=make_bfs_init(int(pg.part_of[source_global]),
                              int(pg.local_of[source_global])),
        max_local_iters=(max_local_iters if mode == "subgraph" else 1))
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, device=device)
    state, tele = eng.run()
    lvl = state["x"]
    lvl[~pg.vmask] = np.inf
    return lvl, tele
