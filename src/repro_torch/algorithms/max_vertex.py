"""Max Vertex (paper Algorithm 2) — the didactic example of the abstraction."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, SemiringProgram, init_max_vertex
from repro_torch.gofs.formats import PartitionedGraph


def max_vertex(pg: PartitionedGraph, mode: str = "subgraph",
               backend: str = "local", mesh=None,
               spmv_backend: Optional[str] = None,
               max_local_iters: Optional[int] = None, device="cuda"):
    """Returns (per-vertex max-reachable-value (P, v_max), Telemetry).
    mode='subgraph' -> Gopher (local fixpoint, bounded by
    ``max_local_iters``); mode='vertex' -> Giraph-like (one sweep per
    superstep)."""
    check_options(spmv_backend)
    prog = SemiringProgram(
        semiring="max_first", init_fn=init_max_vertex,
        max_local_iters=(max_local_iters if mode == "subgraph" else 1))
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, device=device)
    state, tele = eng.run()
    x = state["x"]
    x[~pg.vmask] = -np.inf
    return x, tele
