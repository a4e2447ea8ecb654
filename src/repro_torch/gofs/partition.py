"""Graph partitioners (the port's own copy of the JAX package's
``gofs/partition.py``; the same seed gives the same assignment).

The paper uses METIS (balance vertices, minimize edge cut). METIS is not
available offline, so we implement:

- ``hash_partition``         — random hashing (what Giraph/HDFS does; baseline)
- ``bfs_grow_partition``     — multi-seed BFS region growing with vertex-count
                               balancing; a METIS-like heuristic that keeps
                               connected regions together (low edge cut, few
                               sub-graphs per partition)
- ``subgraph_balanced_partition`` — the paper's §7 "future work": balance the
                               NUMBER and SIZE of sub-graphs per partition to
                               kill stragglers. We pack whole WCCs with a
                               greedy longest-processing-time bin packer and
                               split WCCs larger than a partition via BFS.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from repro_torch.gofs.formats import Graph


def hash_partition(g: Graph, num_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_parts, g.n).astype(np.int32)


def _bfs_grow(adj: sp.csr_matrix, num_parts: int, seed: int) -> np.ndarray:
    """Round-robin multi-seed BFS growth; each partition claims <= ceil(n/P)."""
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    cap = -(-n // num_parts)
    assign = np.full(n, -1, np.int32)
    sizes = np.zeros(num_parts, np.int64)
    frontiers = [list() for _ in range(num_parts)]
    unvisited = np.ones(n, bool)

    def new_seed(p):
        cand = np.flatnonzero(unvisited)
        if cand.size == 0:
            return False
        v = int(cand[rng.integers(0, cand.size)])
        frontiers[p].append(v)
        return True

    for p in range(num_parts):
        new_seed(p)
    active = True
    indptr, indices = adj.indptr, adj.indices
    while active:
        active = False
        for p in range(num_parts):
            if sizes[p] >= cap:
                continue
            if not frontiers[p] and not new_seed(p):
                continue
            nxt = []
            budget = cap - sizes[p]
            for v in frontiers[p]:
                if budget <= 0:
                    nxt.append(v)
                    continue
                if not unvisited[v]:
                    continue
                unvisited[v] = False
                assign[v] = p
                sizes[p] += 1
                budget -= 1
                nxt.extend(int(u) for u in indices[indptr[v]:indptr[v + 1]] if unvisited[u])
            frontiers[p] = nxt
            active = active or bool(nxt) or unvisited.any()
        if unvisited.any() and not any(frontiers):
            for p in range(num_parts):
                if sizes[p] < cap and new_seed(p):
                    active = True
                    break
            else:
                break
    # leftovers (cap-saturated partitions): spill to least-loaded
    left = np.flatnonzero(assign < 0)
    for v in left:
        p = int(np.argmin(sizes))
        assign[v] = p
        sizes[p] += 1
    return assign


def bfs_grow_partition(g: Graph, num_parts: int, seed: int = 0) -> np.ndarray:
    return _bfs_grow(g.undirected_csr(), num_parts, seed)


def subgraph_balanced_partition(g: Graph, num_parts: int, seed: int = 0) -> np.ndarray:
    """Balance WCC count AND size per partition (paper §7 proposal).

    Whole components are LPT-packed into partitions; any component bigger than
    the per-partition capacity is BFS-split first. This is the straggler fix
    the paper calls for after the PageRank-on-LJ result (Fig 5b).
    """
    adj = g.undirected_csr()
    ncc, lab = csgraph.connected_components(adj, directed=False)
    comp_sizes = np.bincount(lab, minlength=ncc)
    cap = -(-g.n // num_parts)
    assign = np.full(g.n, -1, np.int32)

    # split oversized components with BFS growing into ceil(size/cap) pieces
    pieces = []  # list of vertex-index arrays
    for c in np.argsort(comp_sizes)[::-1]:
        verts = np.flatnonzero(lab == c)
        if comp_sizes[c] <= cap:
            pieces.append(verts)
            continue
        k = -(-int(comp_sizes[c]) // cap)
        sub = adj[verts][:, verts]
        sub_assign = _bfs_grow(sub.tocsr(), k, seed)
        for p in range(k):
            pieces.append(verts[sub_assign == p])

    # LPT bin packing of pieces into partitions
    order = np.argsort([-p.size for p in pieces])
    sizes = np.zeros(num_parts, np.int64)
    npieces = np.zeros(num_parts, np.int64)
    for i in order:
        # least loaded by (size, piece-count) — balances both axes the paper names
        p = int(np.lexsort((npieces, sizes))[0])
        assign[pieces[i]] = p
        sizes[p] += pieces[i].size
        npieces[p] += 1
    return assign

