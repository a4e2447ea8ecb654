"""Sub-graph (meta-graph) structure utilities: numpy and scipy, a copy of
the JAX package's ``core/subgraph.py`` with the same arithmetic.

The paper's central object: treat each partition-local weakly-connected
component as a *meta-vertex*; remote edges connect meta-vertices across
partitions. Traversal algorithms then take O(meta-graph diameter) supersteps
instead of O(vertex diameter) — these helpers compute both quantities so the
tests and benchmarks can verify that claim (paper §3.3, Fig 4c).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from repro_torch.gofs.formats import PAD, Graph, PartitionedGraph


def meta_graph(pg: PartitionedGraph):
    """Build the sub-graph meta-graph: nodes = (partition, sg_id), edges from
    remote edges. Returns (num_meta, csr_adjacency, meta_of[p, v] -> meta id).
    """
    offsets = np.zeros(pg.num_parts + 1, np.int64)
    np.cumsum(pg.num_subgraphs, out=offsets[1:])
    num_meta = int(offsets[-1])
    meta_of = np.full((pg.num_parts, pg.v_max), -1, np.int64)
    valid = pg.sg_id != PAD
    meta_of[valid] = pg.sg_id[valid] + offsets[:-1, None].repeat(pg.v_max, 1)[valid]

    src_m, dst_m = [], []
    for p in range(pg.num_parts):
        m = pg.re_src[p] != PAD
        if not m.any():
            continue
        s = meta_of[p, pg.re_src[p][m]]
        d = meta_of[pg.re_dst_part[p][m], pg.re_dst_local[p][m]]
        src_m.append(s)
        dst_m.append(d)
    if src_m:
        src_m = np.concatenate(src_m)
        dst_m = np.concatenate(dst_m)
    else:
        src_m = np.zeros(0, np.int64)
        dst_m = np.zeros(0, np.int64)
    a = sp.csr_matrix((np.ones(src_m.size, np.int8), (src_m, dst_m)),
                      shape=(num_meta, num_meta))
    a = ((a + a.T) > 0).astype(np.int8)
    return num_meta, a.tocsr(), meta_of


def graph_diameter(adj: sp.csr_matrix, sample: int = 64, seed: int = 0) -> int:
    """(Approximate for big graphs) diameter: max finite BFS eccentricity over
    a vertex sample; exact when n <= sample. Disconnected pairs are ignored,
    matching the paper's per-component diameter usage."""
    n = adj.shape[0]
    if n == 0:
        return 0
    rng = np.random.default_rng(seed)
    sources = np.arange(n) if n <= sample else rng.choice(n, sample, replace=False)
    d = csgraph.shortest_path(adj, method="D", unweighted=True, indices=sources)
    d[~np.isfinite(d)] = -1
    return int(d.max())


def meta_diameter(pg: PartitionedGraph, sample: int = 64) -> int:
    _, a, _ = meta_graph(pg)
    return graph_diameter(a, sample=sample)


def vertex_diameter(g: Graph, sample: int = 64) -> int:
    return graph_diameter(g.undirected_csr(), sample=sample)


def subgraph_sizes(pg: PartitionedGraph) -> list:
    """Per-partition list of sub-graph vertex counts — straggler telemetry
    (paper Fig 5: LJ has one mega sub-graph per partition)."""
    out = []
    for p in range(pg.num_parts):
        ids = pg.sg_id[p][pg.sg_id[p] != PAD]
        out.append(np.bincount(ids, minlength=int(pg.num_subgraphs[p])))
    return out
