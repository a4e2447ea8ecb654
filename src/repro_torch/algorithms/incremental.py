"""Incremental re-convergence for the monotone semiring algorithms.

After a ``gofs.temporal.apply_delta``, CC/BFS/SSSP do NOT restart from
scratch: the previous fixpoint is already correct almost everywhere, and the
idempotent-monotone semirings make partial restarts exact. The port's copy
of the JAX package's ``algorithms/incremental.py``, with the same seeds and
resets, so both give the same bits and telemetry.

Insertions (values can only IMPROVE — min distances shrink, max labels grow):
    resume from the previous fixpoint with the frontier seeded at the
    inserted edges' source endpoints. The masked sweeps re-relax exactly the
    affected region; every other partition enters its superstep with an
    empty frontier and runs zero sweeps. The result is bitwise identical to
    a cold run on the new graph: the fixpoint of an idempotent ⊕ is the
    ⊕-reduction over all path values, which is schedule-independent.

    Seeding the inserted SOURCES (not destinations) is what makes this
    correct: sources re-announce their converged values at superstep 0
    (``changed_v`` is the seed frontier there), so a new remote edge
    delivers its first message, and a new local edge's destination row
    re-relaxes because its in-neighbor is in the frontier.

Deletions (values may be stale-OPTIMISTIC — monotone resume can't fix them):
    recompute only the AFFECTED SUB-GRAPHS: every sub-graph (partition-local
    WCC, the paper's meta-vertex) reachable in the new meta-graph from a
    deleted edge's destination sub-graph is reset to its cold-start values,
    and the frontier is seeded with the reset vertices plus the *boundary*
    sources — live remote edges entering the reset region, whose converged
    upstream values re-flow in at superstep 0. Unaffected sub-graphs never
    sweep.

Each entry point runs on ``device`` (the card unless the caller asks for
the CPU) and takes ``gb=``, a device block of the new version — e.g.
``core.blocks.device_block(DeltaResult.block, device)``, the zero-repack
patched block — so the restart skips the per-version re-pack.
``incremental_sssp_batched`` resumes Q sources in one query-batched run
(``serving.batched``), with the same seeds and each lane's own resets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.algorithms._common import check_options
from repro_torch.core import GopherEngine, SemiringProgram, meta_graph
from repro_torch.gofs.formats import PAD, PartitionedGraph
from repro_torch.gofs.temporal import DeltaResult


def _meta_reachable(pg: PartitionedGraph, seed_vertices: np.ndarray
                    ) -> np.ndarray:
    """(P, v_max) bool: vertices of every sub-graph reachable (along remote
    edge direction) from the sub-graphs containing ``seed_vertices``."""
    num_meta, _, meta_of = meta_graph(pg)
    if num_meta == 0:
        return np.zeros_like(pg.vmask)
    src_m, dst_m = [], []
    for p in range(pg.num_parts):
        m = pg.re_src[p] != PAD
        if not m.any():
            continue
        src_m.append(meta_of[p, pg.re_src[p][m]])
        dst_m.append(meta_of[pg.re_dst_part[p][m], pg.re_dst_local[p][m]])
    if src_m:
        src_m, dst_m = np.concatenate(src_m), np.concatenate(dst_m)
    else:
        src_m = dst_m = np.zeros(0, np.int64)
    adj = sp.csr_matrix((np.ones(src_m.size, np.int8), (src_m, dst_m)),
                        shape=(num_meta, num_meta))
    reach = np.zeros(num_meta, bool)
    seeds = meta_of[seed_vertices & pg.vmask]
    reach[seeds[seeds >= 0]] = True
    frontier = reach.copy()
    while frontier.any():                       # meta-graph BFS (tiny graph)
        nxt = (adj.T @ frontier) > 0
        nxt &= ~reach
        reach |= nxt
        frontier = nxt
    return reach[np.clip(meta_of, 0, num_meta - 1)] & (meta_of >= 0) & pg.vmask


def _boundary_sources(pg: PartitionedGraph, reset: np.ndarray) -> np.ndarray:
    """(P, v_max) bool: sources of live remote edges entering ``reset`` from
    outside it — they must re-announce their converged values."""
    out = np.zeros_like(reset)
    for p in range(pg.num_parts):
        m = pg.re_src[p] != PAD
        if not m.any():
            continue
        srcs = pg.re_src[p][m]
        into_reset = reset[pg.re_dst_part[p][m], pg.re_dst_local[p][m]]
        from_outside = ~reset[p, srcs]
        out[p, srcs[into_reset & from_outside]] = True
    return out


def _incremental_run(pg: PartitionedGraph, semiring: str, prev_x: np.ndarray,
                     delta: DeltaResult, init_values: np.ndarray,
                     backend: str = "local", mesh=None,
                     max_local_iters: Optional[int] = None,
                     gb: Optional[dict] = None, exchange: str = "auto",
                     tier_plan=None, device="cuda"):
    x0 = np.array(prev_x, np.float32, copy=True)
    frontier = np.asarray(delta.dirty_insert, bool).copy()
    if delta.dirty_remove.any():
        reset = _meta_reachable(pg, np.asarray(delta.dirty_remove, bool))
        x0[reset] = init_values[reset]
        frontier |= reset | _boundary_sources(pg, reset)
    frontier &= pg.vmask
    prog = SemiringProgram(semiring=semiring, resume=True,
                           max_local_iters=max_local_iters)
    # exchange/tier_plan: callers holding a taught profile can route the
    # restart over a tiered/phased wire, or the resident mode
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, gb=gb,
                       exchange=exchange, tier_plan=tier_plan, device=device)
    return eng.run(extra={"x0": x0, "frontier0": frontier})


def incremental_sssp(pg: PartitionedGraph, source_global: int,
                     prev_dist: np.ndarray, delta: DeltaResult,
                     backend: str = "local", mesh=None,
                     spmv_backend: Optional[str] = None,
                     gb: Optional[dict] = None, exchange: str = "auto",
                     tier_plan=None, device="cuda"):
    """SSSP on graph version k+1 from version k's distances. Returns
    (distances (P, v_max), Telemetry) — bit-identical to a cold sssp()."""
    check_options(spmv_backend)
    init = np.full((pg.num_parts, pg.v_max), np.inf, np.float32)
    init[int(pg.part_of[source_global]),
         int(pg.local_of[source_global])] = 0.0
    prev_x = np.where(pg.vmask, np.asarray(prev_dist, np.float32), np.inf)
    state, tele = _incremental_run(pg, "min_plus", prev_x, delta, init,
                                   backend=backend, mesh=mesh, gb=gb,
                                   exchange=exchange, tier_plan=tier_plan,
                                   device=device)
    dist = np.array(state["x"])
    dist[~pg.vmask] = np.inf
    return dist, tele


def incremental_bfs(pg: PartitionedGraph, source_global: int,
                    prev_levels: np.ndarray, delta: DeltaResult,
                    backend: str = "local", mesh=None,
                    spmv_backend: Optional[str] = None,
                    gb: Optional[dict] = None, exchange: str = "auto",
                    tier_plan=None, device="cuda"):
    """BFS = SSSP over unit weights (graph must carry unit weights)."""
    return incremental_sssp(pg, source_global, prev_levels, delta,
                            backend=backend, mesh=mesh,
                            spmv_backend=spmv_backend, gb=gb,
                            exchange=exchange, tier_plan=tier_plan,
                            device=device)


def incremental_sssp_batched(pg: PartitionedGraph, sources_global,
                             prev_dist: np.ndarray, delta: DeltaResult,
                             backend: str = "local", mesh=None,
                             gb: Optional[dict] = None,
                             exchange: str = "auto", tier_plan=None,
                             device="cuda"):
    """Q-source incremental SSSP: resume ALL query lanes from their previous
    fixpoints in ONE query-batched run (the landmark refresh of
    ``serving.LandmarkCache``). ``prev_dist`` is (Q, n_global) in global
    vertex order; returns (dist (Q, n_global), Telemetry), bit-identical to
    a cold batched run on the new graph.

    The dirty seed is shared across lanes (an inserted edge can improve any
    lane; extra frontier on a converged lane re-relaxes to the same values,
    a no-op for idempotent ⊕), while removals reset each lane's
    meta-reachable region to its OWN cold init before the restart. ``gb``
    is a device block of the new version with the binned adjacency
    (``core.blocks.device_block(DeltaResult.block, device, binned=True)``,
    the service's shared one); ``exchange``/``tier_plan`` route the
    restart."""
    from repro_torch.serving.batched import (BatchedSemiringProgram,
                                             gather_query_results,
                                             sssp_query_init)
    sources_global = np.asarray(sources_global, np.int64).reshape(-1)
    L = int(sources_global.shape[0])
    P, v_max = pg.num_parts, pg.v_max
    prev = np.asarray(prev_dist, np.float32)
    x0 = np.full((P, v_max, L), np.inf, np.float32)
    for p in range(P):
        m = pg.vmask[p]
        x0[p][m] = prev[:, pg.global_id[p][m]].T
    frontier = np.asarray(delta.dirty_insert, bool).copy()
    if delta.dirty_remove.any():
        reset = _meta_reachable(pg, np.asarray(delta.dirty_remove, bool))
        init = sssp_query_init(pg, sources_global)      # (P, v_max, L)
        x0[reset] = init[reset]
        frontier |= reset | _boundary_sources(pg, reset)
    frontier &= pg.vmask
    qf = np.broadcast_to(frontier[..., None], x0.shape)
    prog = BatchedSemiringProgram(semiring="min_plus", num_queries=L,
                                  resume=True)
    eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, gb=gb,
                       exchange=exchange, tier_plan=tier_plan, device=device)
    state, tele = eng.run_queries(extra={"qx0": x0, "qfrontier0": qf})
    return gather_query_results(pg, state["x"]), tele


def incremental_connected_components(
        pg: PartitionedGraph, prev_labels: np.ndarray, delta: DeltaResult,
        backend: str = "local", mesh=None,
        spmv_backend: Optional[str] = None,
        gb: Optional[dict] = None, exchange: str = "auto",
        tier_plan=None, device="cuda") -> Tuple[np.ndarray, int, object]:
    """HCC labels on graph version k+1 from version k's labels. Returns
    (labels, num_components, Telemetry) — bit-identical to a cold run."""
    check_options(spmv_backend)
    gid = pg.global_id.astype(np.float32)
    init = np.where(pg.vmask, gid, -np.inf).astype(np.float32)
    prev_x = np.where(pg.vmask, np.asarray(prev_labels, np.float32), -np.inf)
    state, tele = _incremental_run(pg, "max_first", prev_x, delta, init,
                                   backend=backend, mesh=mesh, gb=gb,
                                   exchange=exchange, tier_plan=tier_plan,
                                   device=device)
    x = np.asarray(state["x"])
    labels = np.where(pg.vmask, x, -1).astype(np.int64)
    ncc = len(np.unique(labels[pg.vmask]))
    return labels, ncc, tele
