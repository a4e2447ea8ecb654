"""PageRank (classic, paper §5.3).

Classic PageRank maps to the engine with one Jacobi iteration per superstep —
as the paper notes, the sub-graph abstraction gives no superstep reduction
here, so the interesting comparison is per-superstep cost. Still to come
(ROADMAP A1): the tolerance-halted schedule and BlockRank, which run the
staged dense route in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, PageRankProgram
from repro_torch.gofs.formats import PartitionedGraph

_NOT_YET = ("the tolerance-halted schedule runs the staged dense route, "
            "which is not ported yet: ROADMAP A1 (the staged dense route)")


def pagerank(pg: PartitionedGraph, num_iters: int = 30, damping: float = 0.85,
             tol: Optional[float] = None, backend: str = "local", mesh=None,
             spmv_backend: Optional[str] = None,
             init_r: Optional[np.ndarray] = None, device="cuda"):
    """Returns (ranks (P, v_max) float32, Telemetry)."""
    check_options(spmv_backend=spmv_backend)
    if tol is not None:
        raise NotImplementedError(f"pagerank(tol=...): {_NOT_YET}")
    init_fn = None
    if init_r is not None:
        r0 = np.asarray(init_r, np.float32)

        def init_fn(gb):  # noqa: E306
            return torch.from_numpy(r0).to(gb["vmask"].device)[
                gb["part_index"].long()]

    prog = PageRankProgram(n_global=pg.n_global, num_iters=num_iters,
                           damping=damping, init_fn=init_fn)
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh,
                       max_supersteps=max(num_iters + 1, 64), device=device)
    state, tele = eng.run()
    r = state["r"]
    r[~pg.vmask] = 0.0
    return r, tele


def blockrank(pg: PartitionedGraph, damping: float = 0.85, tol: float = 1e-7,
              max_iters: int = 30, local_iters: int = 20,
              backend: str = "local", mesh=None,
              spmv_backend: Optional[str] = None, device="cuda"):
    raise NotImplementedError(f"blockrank: {_NOT_YET}")
