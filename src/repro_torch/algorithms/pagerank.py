"""PageRank (classic) and BlockRank (paper §5.3).

Classic PageRank maps to the engine with one Jacobi iteration per superstep —
as the paper notes, the sub-graph abstraction gives no superstep reduction
here, so the interesting comparison is per-superstep cost. A fixed number of
iterations runs the fused route; with ``tol`` it halts on the global L1
delta and runs the staged dense route.

BlockRank exploits the sub-graph structure the way the paper prescribes:
  phase 1  per-sub-graph LOCAL PageRank (zero messages: one kernel K1 pull
           over the flat adjacency per iteration, all partitions at once);
  phase 2  rank the blocks themselves (meta-graph PageRank, host-side);
  phase 3  seed classic PageRank with blockrank-weighted local ranks and run
           WITH a convergence tolerance -> far fewer global supersteps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, PageRankProgram, meta_graph
from repro_torch.gofs.formats import PAD, PartitionedGraph
from repro_torch.kernels import flat, ops


def _seeded(init_r: np.ndarray):
    """A PageRank init_fn that starts from the (P, v_max) ranks ``init_r``."""
    r0 = np.asarray(init_r, np.float32)

    def init_fn(gb):
        return torch.from_numpy(r0).to(gb["vmask"].device)[
            gb["part_index"].long()]
    return init_fn


def _ranks(eng: GopherEngine):
    """Run a PageRank engine; (ranks (P, v_max) float32, pad slots 0,
    Telemetry)."""
    state, tele = eng.run()
    r = state["r"]
    r[~eng.pg.vmask] = 0.0
    return r, tele


def pagerank(pg: PartitionedGraph, num_iters: int = 30, damping: float = 0.85,
             tol: Optional[float] = None, backend: str = "local", mesh=None,
             spmv_backend: Optional[str] = None,
             init_r: Optional[np.ndarray] = None, device="cuda"):
    """Returns (ranks (P, v_max) float32, Telemetry)."""
    check_options(spmv_backend)
    prog = PageRankProgram(n_global=pg.n_global, num_iters=num_iters,
                           damping=damping, tol=tol,
                           init_fn=None if init_r is None else _seeded(init_r))
    return _ranks(GopherEngine(pg, prog, backend=backend, mesh=mesh,
                               max_supersteps=max(num_iters + 1, 64),
                               device=device))


def _local_pagerank(gb: dict, num_iters: int = 30,
                    damping: float = 0.85) -> np.ndarray:
    """Phase 1: PageRank of each sub-graph in isolation (local edges only,
    per-sub-graph normalization). Pure local fixpoint — zero messages.
    ``gb`` is a staged engine's block: the pull reads its flat adjacency
    ``gb["adj"]``, the one phase 3 sweeps. Returns the block's (P, v_max)
    tensor (a mesh rank's rows on ``shard_map``)."""
    nbr, ones = gb["adj"]["nbr"], flat.unit_weights(gb["adj"])
    vmask = gb["vmask"]
    P, v_max = vmask.shape
    dev = vmask.device
    sg = gb["sg_id"].long()

    # per-vertex LOCAL out-degree = how many local in-lists reference it
    outdeg = torch.bincount(nbr[nbr != PAD].long(),
                            minlength=P * v_max).float()
    # per-sub-graph vertex counts -> per-vertex n_b (pad slots read the
    # count at the clipped id, as the JAX package's do)
    idx = torch.where(vmask, sg, v_max)
    off = torch.arange(P, device=dev)[:, None] * (v_max + 1)
    cnt = torch.bincount((off + idx).reshape(-1),
                         minlength=P * (v_max + 1)).reshape(P, v_max + 1)
    n_b = torch.gather(cnt.float(), 1, sg.clamp(0, v_max - 1))
    n_b = torch.clamp(n_b, min=1.0).reshape(-1)
    vm = vmask.reshape(-1)

    r = torch.where(vm, n_b.new_tensor(1.0) / n_b, 0.0)
    for _ in range(num_iters):
        contrib = torch.where(outdeg > 0, r / torch.clamp(outdeg, min=1.0),
                              0.0)
        pull = ops.semiring_spmv(contrib, nbr, ones, "plus_times")
        r = torch.where(vm, n_b.new_tensor(1.0 - damping) / n_b
                        + damping * pull, 0.0)
    return r.reshape(P, v_max)


def blockrank(pg: PartitionedGraph, damping: float = 0.85, tol: float = 1e-7,
              max_iters: int = 30, local_iters: int = 20,
              backend: str = "local", mesh=None,
              spmv_backend: Optional[str] = None, device="cuda"):
    """Returns (ranks, Telemetry-of-phase-3, info dict)."""
    check_options(spmv_backend)
    # phase 3's engine, built first: phase 1 reads its block and adjacency
    prog = PageRankProgram(n_global=pg.n_global, num_iters=max_iters,
                           damping=damping, tol=tol)
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh,
                       max_supersteps=max(max_iters + 1, 64), device=device)
    # phase 1: local per-block PageRank (each mesh rank its own rows, then
    # every rank all of them)
    local_r = eng._ranks.gather(_local_pagerank(
        eng._gb_for_staged(), num_iters=local_iters,
        damping=damping)).cpu().numpy()
    # phase 2: meta-graph PageRank (host-side; the meta graph is tiny)
    num_meta, meta_adj, meta_of = meta_graph(pg)
    br = np.full(num_meta, 1.0 / max(num_meta, 1))
    deg = np.asarray(meta_adj.sum(1)).ravel()
    a = meta_adj.T.astype(np.float64)
    for _ in range(50):
        contrib = np.where(deg > 0, br / np.maximum(deg, 1), 0.0)
        br = (1 - damping) / max(num_meta, 1) + damping * (a @ contrib)
    # phase 3: seed classic PageRank with blockrank-weighted local ranks
    valid = pg.sg_id != PAD
    seed = np.zeros((pg.num_parts, pg.v_max), np.float32)
    seed[valid] = (local_r[valid] * br[meta_of[valid]]).astype(np.float32)
    s = seed[pg.vmask].sum()
    seed = seed / max(s, 1e-12)  # normalize to a distribution
    # the same engine, block and adjacency; only the program's seed is new
    eng.program = dataclasses.replace(prog, init_fn=_seeded(seed))
    r, tele = _ranks(eng)
    return r, tele, dict(num_meta=num_meta, blockrank=br)
