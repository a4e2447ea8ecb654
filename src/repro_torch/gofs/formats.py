"""Graph containers and ELL adjacency formats (numpy, host side).

The port's own copy of the JAX package's ``gofs/formats.py``: the same
functions with the same arithmetic, so the same inputs build the same
arrays. The global graph is a host-side CSR (scipy). Per-partition adjacency
is ELL-packed (``nbr[V_pad, D_max]`` int32, -1 padded): one row per vertex,
which the kernels walk one thread per row.

``partitioned_graph_from_fields`` rebuilds a ``PartitionedGraph`` from the
plain numpy fields of another one (``dataclasses.asdict``), so two packages
can run on exactly the same data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

PAD = -1  # sentinel neighbor index
# the lane padding of every padded axis: the ELL rows, the mailbox cap, the
# block's bins, and the growth of each under a delta
LANE_PAD = 8


def dedupe_edges_min(n: int, src: np.ndarray, dst: np.ndarray,
                     wgt: np.ndarray):
    """Collapse parallel (src, dst) edges to ONE edge keeping the MIN weight.

    This is the repo-wide duplicate-edge policy: under distance semantics
    (SSSP/BFS/reachability — the dominant workloads) the cheapest parallel
    edge dominates every shortest path, so min is the only lossless choice;
    summing (what a raw CSR constructor does) corrupts distances, and
    keep-first is input-order dependent. Returns (src, dst, wgt) deduped,
    in key-sorted order (deterministic regardless of input order).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    wgt = np.asarray(wgt, np.float32)
    if src.size == 0:
        return src, dst, wgt
    key = src * n + dst
    order = np.lexsort((wgt, key))          # by key, then min weight first
    key_s = key[order]
    first = np.r_[True, key_s[1:] != key_s[:-1]]
    keep = order[first]
    return src[keep], dst[keep], wgt[keep]


def grow_last_axis(arr: np.ndarray, extra: int, fill) -> np.ndarray:
    """Pad the last axis by ``extra`` entries of ``fill`` — the lane-padded
    growth step shared by ELL rows, mailbox slot maps, and feed lists."""
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, extra)]
    return np.pad(arr, pad, constant_values=fill)


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Position of each element within its key group (keys need not be sorted)."""
    if keys.size == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    grp = np.repeat(np.arange(starts.size), np.diff(np.r_[starts, sk.size]))
    pos_sorted = np.arange(sk.size) - starts[grp]
    pos = np.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


@dataclasses.dataclass
class Graph:
    """A host-side graph: CSR adjacency (in-edges for pull sweeps) + attributes.

    ``indptr/indices/weights`` describe, for each vertex v, its in-neighbors —
    a pull formulation works uniformly for CC/SSSP/PR sweeps. ``out_degree`` is
    kept separately (PageRank normalization). For undirected graphs in == out.
    """
    n: int
    indptr: np.ndarray        # (n+1,) int64 — in-edge CSR
    indices: np.ndarray       # (nnz,) int32 — in-neighbor ids
    weights: np.ndarray       # (nnz,) float32
    out_degree: np.ndarray    # (n,) int32
    directed: bool = False
    attrs: dict = dataclasses.field(default_factory=dict)  # name -> (n,) array

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weights: Optional[np.ndarray] = None,
                   directed: bool = False) -> "Graph":
        """Duplicate-edge policy: parallel (src, dst) pairs collapse to one
        edge with the MIN weight (``dedupe_edges_min``), identically on the
        directed and undirected paths. The directed path previously let the
        CSR constructor SUM duplicate weights (corrupting SSSP) while the
        undirected path kept an arbitrary first occurrence."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if weights is None:
            weights = np.ones(src.shape[0], np.float32)
        weights = np.asarray(weights, np.float32)
        if not directed:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            weights = np.concatenate([weights, weights])
        src, dst, weights = dedupe_edges_min(n, src, dst, weights)
        adj = sp.csr_matrix((weights, (dst, src)), shape=(n, n))  # row v = in-nbrs of v
        out_deg = np.bincount(src, minlength=n).astype(np.int32)
        return Graph(n=n, indptr=adj.indptr.astype(np.int64),
                     indices=adj.indices.astype(np.int32),
                     weights=adj.data.astype(np.float32),
                     out_degree=out_deg, directed=directed)

    def csr(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.weights, self.indices, self.indptr), shape=(self.n, self.n))

    def undirected_csr(self) -> sp.csr_matrix:
        """Symmetrized structure for weakly-connected-component discovery."""
        a = self.csr()
        return (a + a.T).tocsr()


def ell_from_csr(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
                 n_rows: int, d_max: Optional[int] = None,
                 lane_pad: int = LANE_PAD):
    """Pack CSR rows into ELL: (nbr, wgt) of shape (n_rows, D) with PAD fill.

    D is padded to a multiple of ``lane_pad``. Vectorized — no per-row
    Python loop.
    """
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    d = int(deg.max()) if (d_max is None and deg.size) else int(d_max or 0)
    d = max(d, 1)
    d = ((d + lane_pad - 1) // lane_pad) * lane_pad
    if deg.size and int(deg.max()) > d:
        raise ValueError(f"max degree {int(deg.max())} exceeds d_max {d}")
    nbr = np.full((n_rows, d), PAD, np.int32)
    wgt = np.zeros((n_rows, d), np.float32)
    if indices.size:
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
        pos = np.arange(indices.size, dtype=np.int64) - np.repeat(indptr[:-1], deg)
        nbr[rows, pos] = indices
        wgt[rows, pos] = weights
    return nbr, wgt


@dataclasses.dataclass
class PartitionedGraph:
    """The device-ready partitioned graph: uniform-padded per-partition arrays.

    All arrays carry a leading partition axis P; the local backend runs all
    P partitions as one batch on one device.
    """
    n_global: int
    num_parts: int
    v_max: int                     # padded local vertex count
    # topology (pull ELL over LOCAL in-edges only)
    nbr: np.ndarray                # (P, v_max, d_max) int32, local idx, PAD fill
    wgt: np.ndarray                # (P, v_max, d_max) float32
    vmask: np.ndarray              # (P, v_max) bool — valid vertex slots
    out_degree: np.ndarray         # (P, v_max) int32 — GLOBAL out degree
    # identity maps
    global_id: np.ndarray          # (P, v_max) int64 — local slot -> global vertex id
    part_of: np.ndarray            # (n_global,) int32 — global id -> partition
    local_of: np.ndarray           # (n_global,) int32 — global id -> local slot
    # sub-graph structure (paper §3.2: weakly connected components per partition)
    sg_id: np.ndarray              # (P, v_max) int32 — local sub-graph id, PAD for pad slots
    num_subgraphs: np.ndarray      # (P,) int32
    # remote (cut) edges, stored source-side: u local -> (dst_part, dst_local)
    re_src: np.ndarray             # (P, r_max) int32 local src slot, PAD fill
    re_wgt: np.ndarray             # (P, r_max) float32
    re_dst_part: np.ndarray        # (P, r_max) int32
    re_dst_local: np.ndarray       # (P, r_max) int32
    # mailbox routing plan: remote edge -> slot within its (src,dst) pair row
    re_slot: np.ndarray            # (P, r_max) int32
    mailbox_cap: int               # max messages any (src,dst) partition pair carries
    attrs: dict = dataclasses.field(default_factory=dict)  # name -> (P, v_max)
    # temporal lineage: 0 = the base GoFS build; each applied EdgeDelta batch
    # bumps it (gofs.temporal). Serving caches key results on (graph, version)
    # so stale answers die with the version they were computed at.
    version: int = 0

    @property
    def d_max(self) -> int:
        return int(self.nbr.shape[2])

    @property
    def r_max(self) -> int:
        return int(self.re_src.shape[1])

    def edge_cut(self) -> int:
        return int((self.re_src != PAD).sum())

    def stats(self) -> dict:
        local_edges = int((self.nbr != PAD).sum())
        return dict(
            n=self.n_global, parts=self.num_parts, v_max=self.v_max,
            d_max=self.d_max, r_max=self.r_max, cap=self.mailbox_cap,
            local_edges=local_edges, cut_edges=self.edge_cut(),
            subgraphs=self.num_subgraphs.tolist(),
        )


def partition_graph(g: Graph, assign: np.ndarray, num_parts: int,
                    lane_pad: int = LANE_PAD) -> PartitionedGraph:
    """Materialize a PartitionedGraph from a global graph + vertex->part map.

    This is the GoFS build step: local ELL slices, sub-graph discovery (scipy
    connected components on the symmetrized local adjacency), remote-edge
    extraction, and the mailbox routing plan (fixed per-pair capacity — the
    analogue of the paper's per-host message aggregation). Fully vectorized
    host-side numpy.
    """
    import scipy.sparse.csgraph as csgraph

    assign = np.asarray(assign, np.int32)
    P = num_parts
    part_of = assign
    counts = np.bincount(assign, minlength=P).astype(np.int64)
    v_max = max(int(counts.max()), 1)

    order = np.argsort(assign, kind="stable")
    offs = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    local_of = np.zeros(g.n, np.int32)
    local_of[order] = (np.arange(g.n, dtype=np.int64) -
                       np.repeat(offs[:-1], counts)).astype(np.int32)

    global_id = np.full((P, v_max), -1, np.int64)
    vmask = np.zeros((P, v_max), bool)
    out_degree = np.zeros((P, v_max), np.int32)
    prow = np.repeat(np.arange(P, dtype=np.int64), counts)
    lrow = local_of[order].astype(np.int64)
    global_id[prow, lrow] = order
    vmask[prow, lrow] = True
    out_degree[prow, lrow] = g.out_degree[order]

    # flatten all in-edges: (dst_global, src_global, w)
    deg_in = np.diff(g.indptr)
    dst_g = np.repeat(np.arange(g.n, dtype=np.int64), deg_in)
    src_g = g.indices.astype(np.int64)
    w_all = g.weights
    e_dst_part = part_of[dst_g]
    e_src_part = part_of[src_g]
    is_local = e_src_part == e_dst_part

    # ---- local in-ELL, packed per (partition, local row) ----
    l_part = e_dst_part[is_local].astype(np.int64)
    l_row = local_of[dst_g[is_local]].astype(np.int64)
    l_src = local_of[src_g[is_local]].astype(np.int32)
    l_w = w_all[is_local]
    rowkey = l_part * v_max + l_row
    pos = _cumcount(rowkey)
    d_max = int(pos.max()) + 1 if pos.size else 1
    d_pad = ((max(d_max, 1) + lane_pad - 1) // lane_pad) * lane_pad
    nbr = np.full((P, v_max, d_pad), PAD, np.int32)
    wgt = np.zeros((P, v_max, d_pad), np.float32)
    nbr[l_part, l_row, pos] = l_src
    wgt[l_part, l_row, pos] = l_w

    # ---- remote edges, stored at SOURCE partition ----
    r_sel = ~is_local
    r_src_part = e_src_part[r_sel].astype(np.int64)
    r_src_loc = local_of[src_g[r_sel]].astype(np.int32)
    r_dst_part = e_dst_part[r_sel].astype(np.int32)
    r_dst_loc = local_of[dst_g[r_sel]].astype(np.int32)
    r_wgt = w_all[r_sel]
    fillpos = _cumcount(r_src_part)
    r_max = int(fillpos.max()) + 1 if fillpos.size else 1
    re_src = np.full((P, r_max), PAD, np.int32)
    re_wgt = np.zeros((P, r_max), np.float32)
    re_dp = np.zeros((P, r_max), np.int32)
    re_dl = np.zeros((P, r_max), np.int32)
    re_slot = np.zeros((P, r_max), np.int32)
    re_src[r_src_part, fillpos] = r_src_loc
    re_wgt[r_src_part, fillpos] = r_wgt
    re_dp[r_src_part, fillpos] = r_dst_part
    re_dl[r_src_part, fillpos] = r_dst_loc
    pairkey = r_src_part * P + r_dst_part
    slot = _cumcount(pairkey)
    re_slot[r_src_part, fillpos] = slot.astype(np.int32)
    cap = int(slot.max()) + 1 if slot.size else 1

    # ---- sub-graph discovery: weakly connected components of LOCAL adjacency ----
    sg_id = np.full((P, v_max), PAD, np.int32)
    num_sg = np.zeros(P, np.int32)
    # one global sparse matrix in "partition-block" coordinates: since local
    # edges never cross partitions, components of the block-diagonal matrix
    # are exactly the per-partition components.
    gr = (l_part * v_max + l_row)
    gc = (l_part * v_max + l_src)
    size = P * v_max
    a = sp.csr_matrix((np.ones(gr.size, np.int8), (gr, gc)), shape=(size, size))
    ncc, lab = csgraph.connected_components(a + a.T, directed=False)
    lab = lab.reshape(P, v_max)
    for p in range(P):
        m = vmask[p]
        if not m.any():
            continue
        labs = lab[p][m]
        uniq, dense = np.unique(labs, return_inverse=True)
        sg_id[p, m] = dense.astype(np.int32)
        num_sg[p] = len(uniq)

    attrs = {}
    for name, arr in g.attrs.items():
        a2 = np.zeros((P, v_max), arr.dtype)
        a2[prow, lrow] = arr[order]
        attrs[name] = a2

    return PartitionedGraph(
        n_global=g.n, num_parts=P, v_max=v_max,
        nbr=nbr, wgt=wgt, vmask=vmask, out_degree=out_degree,
        global_id=global_id, part_of=part_of, local_of=local_of,
        sg_id=sg_id, num_subgraphs=num_sg,
        re_src=re_src, re_wgt=re_wgt, re_dst_part=re_dp, re_dst_local=re_dl,
        re_slot=re_slot, mailbox_cap=cap, attrs=attrs,
    )


def partitioned_graph_from_fields(fields: dict) -> PartitionedGraph:
    """Build a ``PartitionedGraph`` from plain fields — e.g.
    ``dataclasses.asdict`` of another package's ``PartitionedGraph``. Array
    fields are copied to numpy with the dtypes ``partition_graph`` gives
    them; unknown fields raise (a silently dropped field would be data the
    two packages no longer share)."""
    names = {f.name for f in dataclasses.fields(PartitionedGraph)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown PartitionedGraph fields: {sorted(unknown)}")
    dtypes = {"nbr": np.int32, "wgt": np.float32, "vmask": bool,
              "out_degree": np.int32, "global_id": np.int64,
              "part_of": np.int32, "local_of": np.int32, "sg_id": np.int32,
              "num_subgraphs": np.int32, "re_src": np.int32,
              "re_wgt": np.float32, "re_dst_part": np.int32,
              "re_dst_local": np.int32, "re_slot": np.int32}
    kw = {}
    for name, value in fields.items():
        if name in dtypes:
            kw[name] = np.array(value, dtypes[name])
        elif name == "attrs":
            kw[name] = {k: np.array(v) for k, v in value.items()}
        else:
            kw[name] = int(value)
    return PartitionedGraph(**kw)
