"""Temporal GoFS: versioned edge-delta batches + incremental graph update.

The port's own copy of the JAX package's ``gofs/temporal.py``: the same
delta rules, the same event log and the same arithmetic, so one delta on
one graph gives equal arrays in both packages.

The paper co-designed GoFS for *time-series* graphs — a new snapshot per
time step — but a full GoFS build per snapshot throws away the fact that
consecutive snapshots share almost all structure. This module makes the
partitioned graph a versioned object:

    EdgeDelta       one batch of edge insertions/removals (global vertex ids)
    apply_delta     PartitionedGraph @ version k  ->  version k+1, IN PLACE
                    of the GoFS layout (ELL rows patched, remote-edge slots
                    reused, sub-graphs rediscovered only in touched
                    partitions) — no global rebuild — plus the per-partition
                    *dirty-vertex* seed sets the incremental algorithms
                    (algorithms.incremental) restart from
    TemporalStore   GoFSStore + an append-only chain of delta slices
                    (<graph>/delta_<v>.npz); materialize() replays the chain
                    to any version

Delta semantics (documented policy, same as ``Graph.from_edges``):
  - removals apply BEFORE insertions within one batch;
  - inserting an edge that already exists updates its weight to the MIN of
    old and new (the repo-wide duplicate policy — distance semantics);
  - removing an edge that doesn't exist is counted (``stats['remove_missed']``)
    and otherwise ignored;
  - on undirected graphs each delta edge is applied in both directions.

Vertex sets are fixed across versions (edge deltas only), so every identity
map (global_id / part_of / local_of) and all attribute slices are shared
between versions untouched.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from repro_torch.gofs.formats import (LANE_PAD, PAD, PartitionedGraph,
                                      dedupe_edges_min, grow_last_axis)
from repro_torch.gofs.store import GoFSStore


class DeltaValidationError(ValueError):
    """A malformed EdgeDelta batch. Raised BEFORE any state is touched, so
    rejection is atomic — the alternative (out-of-range ids indexing part_of,
    NaN weights poisoning min-reductions, an edge both inserted and removed
    racing the removals-first rule) silently corrupts the versioned layout."""


def validate_delta(pg, delta: "EdgeDelta", directed: bool = False,
                   weight_domain: str = "nonneg") -> None:
    """Input hardening for :func:`apply_delta`.

    Rejects (typed :class:`DeltaValidationError`):
      - vertex ids outside ``[0, pg.n_global)`` — they would index the
        part_of/local_of maps out of bounds or wrap negatively;
      - NaN insert weights — NaN is absorbing under min/⊕ and would poison
        every reduction it reaches;
      - negative insert weights under ``weight_domain='nonneg'`` (the
        repo-wide distance semantics: min_plus shortest paths assume
        nonnegative edges); semirings that allow them pass
        ``weight_domain='any'``;
      - an edge both inserted and removed in ONE batch (canonicalized for
        undirected graphs) — under the removals-first rule that nets to an
        insert, but callers that meant the opposite order get silent
        corruption, so contradictory batches must be split or netted by the
        caller.
    """
    n = pg.n_global
    for nm, arr in (("insert_src", delta.insert_src),
                    ("insert_dst", delta.insert_dst),
                    ("remove_src", delta.remove_src),
                    ("remove_dst", delta.remove_dst)):
        a = np.asarray(arr)
        if a.size and ((a < 0).any() or (a >= n).any()):
            bad = a[(a < 0) | (a >= n)]
            raise DeltaValidationError(
                f"{nm} vertex ids out of range [0, {n}): "
                f"{bad[:5].tolist()}")
    w = np.asarray(delta.insert_wgt)
    if w.size and np.isnan(w).any():
        raise DeltaValidationError("insert_wgt contains NaN")
    if weight_domain not in ("nonneg", "any"):
        raise DeltaValidationError(
            f"unknown weight_domain {weight_domain!r} "
            "(expected 'nonneg' or 'any')")
    if weight_domain == "nonneg" and w.size and (w < 0).any():
        raise DeltaValidationError(
            f"negative insert_wgt {w[w < 0][:5].tolist()} under the "
            "'nonneg' weight domain; pass weight_domain='any' for "
            "semirings that permit negative weights")
    if delta.insert_src.size and delta.remove_src.size:
        def keys(s, d):
            s = np.asarray(s, np.int64)
            d = np.asarray(d, np.int64)
            if not directed:
                s, d = np.minimum(s, d), np.maximum(s, d)
            return s * n + d
        both = np.intersect1d(keys(delta.insert_src, delta.insert_dst),
                              keys(delta.remove_src, delta.remove_dst))
        if both.size:
            pairs = [(int(k // n), int(k % n)) for k in both[:5]]
            raise DeltaValidationError(
                f"contradictory batch: edges both inserted and removed "
                f"in one delta: {pairs}")


@dataclasses.dataclass
class EdgeDelta:
    """One batch of edge mutations in GLOBAL vertex ids."""
    insert_src: np.ndarray          # (Ni,) int64
    insert_dst: np.ndarray          # (Ni,) int64
    insert_wgt: np.ndarray          # (Ni,) float32
    remove_src: np.ndarray          # (Nr,) int64
    remove_dst: np.ndarray          # (Nr,) int64

    @staticmethod
    def of(insert_src=(), insert_dst=(), insert_wgt=None,
           remove_src=(), remove_dst=()) -> "EdgeDelta":
        isrc = np.asarray(insert_src, np.int64).reshape(-1)
        idst = np.asarray(insert_dst, np.int64).reshape(-1)
        iwgt = (np.ones(isrc.shape[0], np.float32) if insert_wgt is None
                else np.asarray(insert_wgt, np.float32).reshape(-1))
        return EdgeDelta(
            insert_src=isrc, insert_dst=idst, insert_wgt=iwgt,
            remove_src=np.asarray(remove_src, np.int64).reshape(-1),
            remove_dst=np.asarray(remove_dst, np.int64).reshape(-1))

    @staticmethod
    def inserts(src, dst, wgt=None) -> "EdgeDelta":
        return EdgeDelta.of(insert_src=src, insert_dst=dst, insert_wgt=wgt)

    @staticmethod
    def removes(src, dst) -> "EdgeDelta":
        return EdgeDelta.of(remove_src=src, remove_dst=dst)

    @property
    def num_inserts(self) -> int:
        return int(self.insert_src.shape[0])

    @property
    def num_removes(self) -> int:
        return int(self.remove_src.shape[0])


@dataclasses.dataclass
class DeltaResult:
    """apply_delta's output: the next-version graph + incremental seeds."""
    pg: PartitionedGraph
    # (P, v_max) bool — SOURCE endpoints of inserted edges. Seeding these as
    # the frontier makes masked sweeps re-relax their out-rows and makes
    # their (possibly unchanged) values re-announce over new remote edges.
    dirty_insert: np.ndarray
    # (P, v_max) bool — DST endpoints of removed edges (their in-list
    # shrank, so their values may be stale-optimistic). The incremental
    # layer expands these to affected sub-graphs via the meta-graph.
    dirty_remove: np.ndarray
    stats: dict
    # zero-repack graph block (core.blocks.patch_host_block output): present
    # when the caller passed the previous version's HOST block — the derived
    # arrays (binned ELL, mailbox inverse maps) patched in O(|delta|)
    # instead of re-packed from scratch.
    block: Optional[dict] = None
    # the patch-event log (touched_rows, rdel, radd): replay it with
    # core.blocks.patch_host_block to patch FURTHER replicas of the previous
    # version's block (a fleet holding per-mesh copies patches each in
    # O(|delta|) from one apply_delta).
    events: Optional[tuple] = None


def _mirror(src, dst, wgt=None):
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    if wgt is None:
        return s, d
    return s, d, np.concatenate([wgt, wgt])


def _local_subgraphs(nbr: np.ndarray, vmask: np.ndarray, parts):
    """Rediscover weakly-connected components (sub-graphs) of the given
    partitions in ONE scipy call: local edges never cross partitions, so the
    block-diagonal matrix over the touched partitions decomposes exactly
    into per-partition components (same trick as partition_graph).
    Yields (p, sg_id_p, num_sg_p)."""
    parts = list(parts)
    if not parts:
        return
    v_max = nbr.shape[1]
    sub = nbr[parts]
    valid = sub != PAD
    blk, rows, _ = np.nonzero(valid)
    cols = sub[valid]
    size = len(parts) * v_max
    a = sp.csr_matrix((np.ones(blk.size, np.int8),
                       (blk * v_max + rows, blk * v_max + cols)),
                      shape=(size, size))
    _, lab = csgraph.connected_components(a + a.T, directed=False)
    lab = lab.reshape(len(parts), v_max)
    for i, p in enumerate(parts):
        sg = np.full(v_max, PAD, np.int32)
        m = vmask[p]
        if m.any():
            uniq, dense = np.unique(lab[i][m], return_inverse=True)
            sg[m] = dense.astype(np.int32)
            yield p, sg, len(uniq)
        else:
            yield p, sg, 0


# fill of a grown remote-edge entry: re_src, re_wgt, re_dst_part,
# re_dst_local, re_slot
_RE_FILL = (PAD, 0.0, 0, 0, 0)


def _ell_insert(nbr, wgt, p, v, u, w):
    """Put the local in-edge u -> v of weight w into the first PAD lane of
    partition p's ELL row v; when that row is full every row grows by
    ``LANE_PAD`` lanes. Returns the (possibly grown) ``(nbr, wgt)``."""
    free = np.flatnonzero(nbr[p, v] == PAD)
    if free.size == 0:
        nbr = grow_last_axis(nbr, LANE_PAD, PAD)
        wgt = grow_last_axis(wgt, LANE_PAD, 0.0)
        free = np.flatnonzero(nbr[p, v] == PAD)
    nbr[p, v, free[0]] = u
    wgt[p, v, free[0]] = w
    return nbr, wgt


def _recycled_slot(remote, p, pv):
    """The smallest mailbox slot unused by the live remote edges of the
    (p, pv) pair: freed slots are recycled so the mailbox doesn't creep
    wider. ``remote`` is [re_src, re_wgt, re_dst_part, re_dst_local,
    re_slot]."""
    re_src, _, re_dp, _, re_slot = remote
    pair = (re_src[p] != PAD) & (re_dp[p] == pv)
    used = np.zeros(int(pair.sum()) + 1, bool)
    in_range = re_slot[p][pair]
    used[in_range[in_range < used.size]] = True
    return int(np.flatnonzero(~used)[0])


def _add_remote_edge(remote, p, u, pv, lv, w):
    """Store the remote edge (p, u) -> (pv, lv) of weight w in the first free
    entry of partition p's remote-edge list, on its pair's recycled slot.
    ``remote`` is the list [re_src, re_wgt, re_dst_part, re_dst_local,
    re_slot]; when p has no free entry all five grow by ``LANE_PAD`` entries
    and are replaced in the list. Returns ``(slot, entry)``."""
    holes = np.flatnonzero(remote[0][p] == PAD)
    if holes.size == 0:
        remote[:] = [grow_last_axis(a, LANE_PAD, f)
                     for a, f in zip(remote, _RE_FILL)]
        holes = np.flatnonzero(remote[0][p] == PAD)
    e = int(holes[0])
    slot = _recycled_slot(remote, p, pv)
    for a, x in zip(remote, (u, w, pv, lv, slot)):
        a[p, e] = x
    return slot, e


def _mailbox_cap(re_src, re_slot, block, num_parts):
    """A patched version's mailbox capacity: an exact fit over the live
    remote edges; STICKY when patching a block (flat slot positions must
    stay valid — growth is lane-padded so one overflowing pair doesn't
    recompile every version)."""
    live = re_src != PAD
    cap = int(re_slot[live].max()) + 1 if live.any() else 1
    if block is not None:
        cap_block = block["ob_inv"].shape[1] // num_parts
        if cap > cap_block:
            cap = ((cap + LANE_PAD - 1) // LANE_PAD) * LANE_PAD
        cap = max(cap, cap_block)
    return cap


def apply_delta(pg: PartitionedGraph, delta: EdgeDelta,
                directed: bool = False, block: Optional[dict] = None,
                weight_domain: str = "nonneg") -> DeltaResult:
    """Produce the next graph version WITHOUT re-running the GoFS build.

    Host-side O(|delta|) patching of the device layout: local inserts fill
    PAD holes in the destination's ELL row (rows grow by ``LANE_PAD`` lanes
    only when full), remote inserts reuse freed mailbox slots of their
    partition pair before widening the capacity, and sub-graph ids are
    rediscovered only in partitions whose local topology changed.

    ``block``: the previous version's HOST graph block
    (core.blocks.host_graph_block). When given, the derived engine arrays
    (binned ELL adjacency, mailbox inverse maps, outbox slot map) are
    patched in O(|delta|) too and returned as ``DeltaResult.block`` — the
    zero-repack versioned-block path. The mailbox cap then becomes STICKY
    (grows lane-padded on overflow, never shrinks) so the patched block's
    flat slot positions survive the version bump. The block's per-pair
    traffic profile (``wire_ewma``) is carried across the version and
    raised to the dirty frontier's expected per-pair slot counts
    (core.tiers.announce_frontier), so tier plans rebuilt from the patched
    block give freshly woken pairs enough width.
    """
    validate_delta(pg, delta, directed=directed, weight_domain=weight_domain)
    n = pg.n_global
    P, v_max = pg.num_parts, pg.v_max
    part_of, local_of = pg.part_of, pg.local_of

    rsrc, rdst = delta.remove_src, delta.remove_dst
    isrc, idst, iwgt = delta.insert_src, delta.insert_dst, delta.insert_wgt
    if not directed:
        if rsrc.size:
            rsrc, rdst = _mirror(rsrc, rdst)
        if isrc.size:
            isrc, idst, iwgt = _mirror(isrc, idst, iwgt)
    if isrc.size:
        isrc, idst, iwgt = dedupe_edges_min(n, isrc, idst, iwgt)
    if rsrc.size:
        _, uniq = np.unique(rsrc * n + rdst, return_index=True)
        rsrc, rdst = rsrc[uniq], rdst[uniq]

    nbr = pg.nbr.copy()
    wgt = pg.wgt.copy()
    re_src = pg.re_src.copy()
    re_wgt = pg.re_wgt.copy()
    re_dp = pg.re_dst_part.copy()
    re_dl = pg.re_dst_local.copy()
    re_slot = pg.re_slot.copy()
    remote = [re_src, re_wgt, re_dp, re_dl, re_slot]
    out_degree = pg.out_degree.copy()
    sg_id = pg.sg_id.copy()
    num_sg = pg.num_subgraphs.copy()

    dirty_ins = np.zeros((P, v_max), bool)
    dirty_rem = np.zeros((P, v_max), bool)
    touched_local = set()
    # zero-repack event log (consumed by core.blocks.patch_host_block)
    touched_mask = np.zeros((P, v_max), bool)  # local rows whose nbr/wgt changed
    ev_rdel = []                # [(src_p, dst_p, dst_v, slot)]
    ev_radd = []                # [(src_p, dst_p, dst_v, slot, edge_idx)]
    stats = dict(inserted=0, weight_updated=0, removed=0, remove_missed=0)

    # ---- removals first (an insert re-adding a removed edge nets to insert)
    for u, v in zip(rsrc, rdst):
        pu, lu = int(part_of[u]), int(local_of[u])
        pv, lv = int(part_of[v]), int(local_of[v])
        if pu == pv:
            j = np.flatnonzero(nbr[pv, lv] == lu)
            if j.size == 0:
                stats["remove_missed"] += 1
                continue
            nbr[pv, lv, j[0]] = PAD
            wgt[pv, lv, j[0]] = 0.0
            touched_local.add(pv)
            touched_mask[pv, lv] = True
        else:
            m = np.flatnonzero((re_src[pu] == lu) & (re_dp[pu] == pv)
                               & (re_dl[pu] == lv))
            if m.size == 0:
                stats["remove_missed"] += 1
                continue
            # free the slot; its (pair, slot) id becomes reusable by inserts
            ev_rdel.append((pu, pv, lv, int(re_slot[pu, m[0]])))
            re_src[pu, m[0]] = PAD
            re_wgt[pu, m[0]] = 0.0
        out_degree[pu, lu] -= 1
        dirty_rem[pv, lv] = True
        stats["removed"] += 1

    # ---- insertions
    for u, v, w in zip(isrc, idst, iwgt):
        pu, lu = int(part_of[u]), int(local_of[u])
        pv, lv = int(part_of[v]), int(local_of[v])
        dirty_ins[pu, lu] = True
        if pu == pv:
            j = np.flatnonzero(nbr[pv, lv] == lu)
            if j.size:                          # duplicate insert: min policy
                wgt[pv, lv, j[0]] = min(float(wgt[pv, lv, j[0]]), float(w))
                stats["weight_updated"] += 1
                touched_mask[pv, lv] = True
                continue
            nbr, wgt = _ell_insert(nbr, wgt, pv, lv, lu, w)
            touched_local.add(pv)
            touched_mask[pv, lv] = True
        else:
            m = np.flatnonzero((re_src[pu] == lu) & (re_dp[pu] == pv)
                               & (re_dl[pu] == lv))
            if m.size:
                re_wgt[pu, m[0]] = min(float(re_wgt[pu, m[0]]), float(w))
                stats["weight_updated"] += 1
                continue
            slot, e = _add_remote_edge(remote, pu, lu, pv, lv, w)
            re_src, re_wgt, re_dp, re_dl, re_slot = remote
            ev_radd.append((pu, pv, lv, slot, e))
        out_degree[pu, lu] += 1
        stats["inserted"] += 1

    cap = _mailbox_cap(re_src, re_slot, block, P)

    # ---- sub-graph rediscovery, touched partitions only (one scipy call)
    for p, sg_p, n_p in _local_subgraphs(nbr, pg.vmask, sorted(touched_local)):
        sg_id[p], num_sg[p] = sg_p, n_p

    new_pg = PartitionedGraph(
        n_global=n, num_parts=P, v_max=v_max,
        nbr=nbr, wgt=wgt, vmask=pg.vmask, out_degree=out_degree,
        global_id=pg.global_id, part_of=part_of, local_of=local_of,
        sg_id=sg_id, num_subgraphs=num_sg,
        re_src=re_src, re_wgt=re_wgt, re_dst_part=re_dp, re_dst_local=re_dl,
        re_slot=re_slot, mailbox_cap=cap, attrs=pg.attrs,
        version=pg.version + 1,
    )
    stats["version"] = new_pg.version
    stats["touched_partitions"] = len(touched_local)
    touched_rows = np.argwhere(touched_mask)       # sorted (p, v) pairs
    new_block = None
    if block is not None:
        from repro_torch.core.blocks import patch_host_block
        from repro_torch.core.tiers import announce_frontier
        new_block = patch_host_block(block, new_pg, touched_rows,
                                     ev_rdel, ev_radd)
        # patch the per-pair traffic profile through the
        # version bump — the dirty frontier IS the next run's prime-round
        # traffic, so the pairs this delta just woke are raised to at least
        # their expected slot counts before any tier plan is rebuilt
        announce_frontier(new_block, new_pg, dirty_ins | dirty_rem)
    return DeltaResult(pg=new_pg, dirty_insert=dirty_ins,
                       dirty_remove=dirty_rem, stats=stats, block=new_block,
                       events=(touched_rows, ev_rdel, ev_radd))


class TemporalStore(GoFSStore):
    """GoFSStore + an append-only chain of edge-delta slices per graph.

    Version 0 is the base GoFS build (``build``/``write``); each
    ``append_delta`` adds ``<graph>/delta_<v>.npz``. Readers reassemble any
    version with ``materialize`` — a base load plus O(sum |delta|) patching,
    never a re-partition.
    """

    def append_delta(self, name: str, delta: EdgeDelta,
                     directed: bool = False) -> int:
        v = self.latest_version(name) + 1
        path = os.path.join(self.root, name, f"delta_{v}.npz")
        np.savez(path, insert_src=delta.insert_src,
                 insert_dst=delta.insert_dst, insert_wgt=delta.insert_wgt,
                 remove_src=delta.remove_src, remove_dst=delta.remove_dst,
                 directed=np.bool_(directed))
        return v

    def latest_version(self, name: str) -> int:
        pat = os.path.join(self.root, name, "delta_*.npz")
        vs = [int(m.group(1)) for f in glob.glob(pat)
              if (m := re.search(r"delta_(\d+)\.npz$", f))]
        return max(vs, default=0)

    def load_delta(self, name: str, version: int):
        """Returns (EdgeDelta, directed)."""
        path = os.path.join(self.root, name, f"delta_{version}.npz")
        with np.load(path) as z:
            d = EdgeDelta(insert_src=z["insert_src"],
                          insert_dst=z["insert_dst"],
                          insert_wgt=z["insert_wgt"],
                          remove_src=z["remove_src"],
                          remove_dst=z["remove_dst"])
            return d, bool(z["directed"])

    def materialize(self, name: str, version: Optional[int] = None,
                    attrs: Optional[Sequence[str]] = None) -> PartitionedGraph:
        """Replay deltas 1..version over the base build. ``version=None``
        means latest. The returned graph's ``.version`` is the replay depth."""
        if version is None:
            version = self.latest_version(name)
        pg = self.load_partitioned(name, attrs=attrs)
        for v in range(1, version + 1):
            delta, directed = self.load_delta(name, v)
            pg = apply_delta(pg, delta, directed=directed).pg
        return pg
