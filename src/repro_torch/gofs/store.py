"""GoFS slice-file store: write-once / read-many partitioned graph storage.

The port's own copy of the JAX package's ``gofs/store.py``, with the same
on-disk layout, so each package reads what the other wrote. One
slice-bundle per partition, topology and attributes in SEPARATE slices so
an algorithm loads only what it touches:

    <root>/<graph>/meta.json                     graph + partition metadata
    <root>/<graph>/global_maps.npz               part_of, local_of
    <root>/<graph>/part_<i>/topology.npz         compact CSR + remote edges
                                                 + sub-graph ids
    <root>/<graph>/part_<i>/attr_<name>.npz      one slice per attribute

``load_partitioned`` reassembles the (P, ...) batch, optionally loading
only a subset of attributes (the paper's "load only the edge-weight slice"
optimization).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.gofs.formats import (Graph, PartitionedGraph, ell_from_csr,
                                      partition_graph)

_TOPO_FIELDS = ["nbr", "wgt", "vmask", "out_degree", "global_id", "sg_id",
                "re_src", "re_wgt", "re_dst_part", "re_dst_local", "re_slot"]
# ELL is the DEVICE layout; on DISK the adjacency is compact CSR (the paper's
# slices don't pad either) — hub-padded ELL would bloat powerlaw slices
# ~20x. ELL is rebuilt vectorized at load.
_DENSE_FIELDS = [f for f in _TOPO_FIELDS if f not in ("nbr", "wgt")]


class GoFSStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ---------------- write path (the GoFS "build") ----------------
    def build(self, name: str, g: Graph, assign: np.ndarray,
              num_parts: int) -> PartitionedGraph:
        pg = partition_graph(g, assign, num_parts)
        self.write(name, pg)
        return pg

    def write(self, name: str, pg: PartitionedGraph) -> None:
        gdir = os.path.join(self.root, name)
        os.makedirs(gdir, exist_ok=True)
        meta = dict(
            n_global=pg.n_global, num_parts=pg.num_parts, v_max=pg.v_max,
            d_max=pg.d_max, r_max=pg.r_max, mailbox_cap=pg.mailbox_cap,
            num_subgraphs=pg.num_subgraphs.tolist(),
            attrs=sorted(pg.attrs.keys()), version=pg.version,
        )
        with open(os.path.join(gdir, "meta.json"), "w") as f:
            json.dump(meta, f)
        np.savez(os.path.join(gdir, "global_maps.npz"),
                 part_of=pg.part_of, local_of=pg.local_of)
        for p in range(pg.num_parts):
            pdir = os.path.join(gdir, f"part_{p}")
            os.makedirs(pdir, exist_ok=True)
            nbr, wgt = pg.nbr[p], pg.wgt[p]
            valid = nbr != -1
            counts = valid.sum(1)
            indptr = np.zeros(pg.v_max + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            np.savez(os.path.join(pdir, "topology.npz"),
                     csr_indptr=indptr, csr_indices=nbr[valid],
                     csr_weights=wgt[valid], d_pad=np.int64(pg.d_max),
                     **{k: getattr(pg, k)[p] for k in _DENSE_FIELDS})
            for aname, arr in pg.attrs.items():
                np.savez(os.path.join(pdir, f"attr_{aname}.npz"), value=arr[p])

    # ---------------- read path ----------------
    def meta(self, name: str) -> dict:
        with open(os.path.join(self.root, name, "meta.json")) as f:
            return json.load(f)

    def load_partition(self, name: str, p: int,
                       attrs: Optional[Sequence[str]] = None) -> dict:
        """Load ONE partition's slices — what a single worker reads at start.
        Rebuilds the ELL layout from the compact CSR slice."""
        pdir = os.path.join(self.root, name, f"part_{p}")
        with np.load(os.path.join(pdir, "topology.npz")) as z:
            out = {k: z[k] for k in z.files
                   if not k.startswith("csr_") and k != "d_pad"}
            n_rows = out["vmask"].shape[0]
            nbr, wgt = ell_from_csr(z["csr_indptr"], z["csr_indices"],
                                    z["csr_weights"], n_rows,
                                    d_max=int(z["d_pad"]), lane_pad=1)
            out["nbr"], out["wgt"] = nbr, wgt
        for aname in (attrs or []):
            with np.load(os.path.join(pdir, f"attr_{aname}.npz")) as z:
                out[f"attr_{aname}"] = z["value"]
        return out

    def load_partitioned(self, name: str,
                         attrs: Optional[Sequence[str]] = None) -> PartitionedGraph:
        m = self.meta(name)
        P = m["num_parts"]
        parts = [self.load_partition(name, p, attrs) for p in range(P)]
        with np.load(os.path.join(self.root, name, "global_maps.npz")) as z:
            part_of, local_of = z["part_of"], z["local_of"]
        batch = {k: np.stack([pt[k] for pt in parts]) for k in _TOPO_FIELDS}
        a = {an: np.stack([pt[f"attr_{an}"] for pt in parts]) for an in (attrs or [])}
        return PartitionedGraph(
            n_global=m["n_global"], num_parts=P, v_max=m["v_max"],
            part_of=part_of, local_of=local_of,
            num_subgraphs=np.asarray(m["num_subgraphs"], np.int32),
            mailbox_cap=m["mailbox_cap"], attrs=a,
            version=m.get("version", 0), **batch)
