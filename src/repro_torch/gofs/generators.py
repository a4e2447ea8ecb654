"""Synthetic graph generators matching the paper's dataset shapes (Table 1).

The port's own copy of the JAX package's ``gofs/generators.py``: the same
RNG calls in the same order, so the same seed gives the same graph.

RN  (California road network): high diameter (849), tiny degrees, 2,638 WCCs
    -> ``road_grid``: 2-D grid with random edge deletions (creates many
       components and a long diameter).
TR  (Internet traceroute):     powerlaw, diameter 25, ONE giant WCC with a
    few huge hubs (ISPs + a timeout vertex)
    -> ``trace_star``: preferential-attachment forest re-rooted at a handful
       of mega-hubs, plus one "timeout" hub wired broadly.
LJ  (LiveJournal social):      dense powerlaw, diameter ~16, 1,877 WCCs
    -> ``powerlaw_social``: Barabási–Albert-style preferential attachment
       with m>=5 plus a dust of small isolated components.

All generators are numpy-native (no networkx) so benchmark-scale graphs
(10^5..10^6 vertices) build in seconds on one CPU.
"""
from __future__ import annotations

import numpy as np

from repro_torch.gofs.formats import Graph


def road_grid(rows: int, cols: int, drop_frac: float = 0.03,
              seed: int = 0, weighted: bool = False) -> Graph:
    """Grid graph with random deletions — RN analogue (long diameter, many WCCs)."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    v = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], 1)
    down = np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], 1)
    e = np.concatenate([right, down])
    keep = rng.random(e.shape[0]) >= drop_frac
    e = e[keep]
    w = rng.uniform(1.0, 10.0, e.shape[0]).astype(np.float32) if weighted else None
    return Graph.from_edges(n, e[:, 0], e[:, 1], weights=w, directed=False)


def powerlaw_social(n: int, m: int = 5, dust_frac: float = 0.02,
                    seed: int = 0) -> Graph:
    """Preferential-attachment graph + small isolated 'dust' — LJ analogue.

    Vectorized BA approximation: new vertex t attaches to m targets sampled
    from the current edge-endpoint multiset (degree-proportional).
    """
    rng = np.random.default_rng(seed)
    n_dust = int(n * dust_frac)
    n_core = n - n_dust
    m = min(m, n_core - 1)
    # seed clique of m+1 vertices
    seed_v = np.arange(m + 1)
    si, sj = np.triu_indices(m + 1, 1)
    targets = np.concatenate([seed_v[si], seed_v[sj]])  # endpoint multiset
    srcs = [seed_v[si]]
    dsts = [seed_v[sj]]
    # grow in chunks for speed; sampling from the endpoint multiset of the
    # PREVIOUS chunk is a standard fast BA approximation
    t = m + 1
    while t < n_core:
        chunk = min(max(1024, t), n_core - t)
        news = np.arange(t, t + chunk, dtype=np.int64)
        tgt = targets[rng.integers(0, targets.size, size=(chunk, m))]
        src = np.repeat(news, m)
        dst = tgt.ravel()
        srcs.append(src)
        dsts.append(dst)
        targets = np.concatenate([targets, src, dst])
        if targets.size > 4_000_000:  # bound memory; degree dist already set
            targets = targets[rng.integers(0, targets.size, size=2_000_000)]
        t += chunk
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    # dust: tiny 2-3 vertex components
    if n_dust >= 2:
        dv = np.arange(n_core, n, dtype=np.int64)
        src = np.concatenate([src, dv[:-1:2]])
        dst = np.concatenate([dst, dv[1::2][: dv[:-1:2].size]])
    sel = src != dst
    return Graph.from_edges(n, src[sel], dst[sel], directed=False)


def trace_star(n: int, n_hubs: int = 8, seed: int = 0) -> Graph:
    """Traceroute-like: giant single WCC, powerlaw, few mega-hubs — TR analogue."""
    rng = np.random.default_rng(seed)
    hubs = np.arange(n_hubs, dtype=np.int64)
    rest = np.arange(n_hubs, n, dtype=np.int64)
    # each non-hub attaches to a random earlier vertex (tree => diameter ~log n)
    parent = rng.integers(0, np.maximum(rest - 1, 1))
    src = [rest]
    dst = [parent.astype(np.int64)]
    # the "timeout vertex": hub 0 connects to a broad random sample (paper: one
    # vertex with O(millions) degree that punishes naive vertex-balanced loads)
    fan = rng.choice(rest, size=max(n // 20, 1), replace=False)
    src.append(np.full(fan.size, hubs[0], np.int64))
    dst.append(fan)
    # remaining hubs get moderate fans
    for h in hubs[1:]:
        f = rng.choice(rest, size=max(n // 200, 1), replace=False)
        src.append(np.full(f.size, h, np.int64))
        dst.append(f)
    # hub backbone
    src.append(hubs[:-1])
    dst.append(hubs[1:])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    sel = src != dst
    return Graph.from_edges(n, src[sel], dst[sel], directed=False)


def random_graph(n: int, avg_degree: float = 4.0, seed: int = 0,
                 weighted: bool = False) -> Graph:
    """Erdős–Rényi-ish random graph for property tests."""
    rng = np.random.default_rng(seed)
    ne = int(n * avg_degree / 2)
    src = rng.integers(0, n, ne)
    dst = rng.integers(0, n, ne)
    sel = src != dst
    w = rng.uniform(1.0, 5.0, sel.sum()).astype(np.float32) if weighted else None
    return Graph.from_edges(n, src[sel], dst[sel], weights=w, directed=False)
