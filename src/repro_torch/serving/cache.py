"""Result caches: exact memoization + landmark triangle-inequality bounds.

Two tiers sit in front of the engine:

  ResultCache      exact (Q-query results memoized by (graph, family,
                   sources)); an LRU over full (n,) result vectors. Repeat
                   queries — the common case for popular sources — cost a
                   dict lookup, zero supersteps.

  LandmarkCache    approximate SSSP WITHOUT touching the engine: precompute
                   exact distance vectors from L landmark vertices (one
                   batched SSSP run — the serving subsystem bootstraps its
                   own cache), then answer any source by the triangle
                   inequality  d(s,t) <= min_l d(s,l) + d(l,t)  (upper bound)
                   and  d(s,t) >= max_l |d(s,l) - d(l,t)|  (lower bound).
                   Exact when s or t IS a landmark. Assumes an undirected
                   graph (d(s,l) = d(l,s) is read off the landmark vector).

The port's copy of the JAX package's ``serving/cache.py``: the same numpy
arithmetic, with the landmark runs on the port's engine (the card unless
the caller passes ``device='cpu'``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from repro_torch.gofs.formats import PartitionedGraph


class ResultCache:
    """LRU memo of exact per-query results keyed by Query.cache_key()."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, key) -> Optional[np.ndarray]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def invalidate(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred``; returns the count.
        The service calls this on graph updates — version-tagged keys make
        stale hits impossible anyway, but eagerly dropping them returns the
        capacity to live entries instead of waiting for LRU churn."""
        dead = [k for k in self._d if pred(k)]
        for k in dead:
            del self._d[k]
        self.invalidations += len(dead)
        return len(dead)

    def __len__(self) -> int:
        return len(self._d)

    def hit_rate(self) -> float:
        """Hits / lookups over the cache's lifetime (0.0 before any get)."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    def stats(self) -> dict:
        return dict(entries=len(self._d), hits=self.hits, misses=self.misses,
                    invalidations=self.invalidations,
                    hit_rate=round(self.hit_rate(), 4))


def choose_landmarks(pg: PartitionedGraph, num: int,
                     strategy: str = "degree", seed: int = 0) -> np.ndarray:
    """Pick landmark vertex ids: highest global out-degree (good coverage on
    powerlaw graphs — hubs sit on many shortest paths) or uniform random."""
    if strategy == "degree":
        deg = np.zeros(pg.n_global, np.int64)
        for p in range(pg.num_parts):
            m = pg.vmask[p]
            deg[pg.global_id[p][m]] = pg.out_degree[p][m]
        return np.argsort(-deg, kind="stable")[:num].astype(np.int64)
    if strategy == "random":
        rng = np.random.default_rng(seed)
        return rng.choice(pg.n_global, size=num, replace=False).astype(np.int64)
    raise ValueError(f"unknown landmark strategy {strategy!r}")


# landmark drift: EWMA weight on the LATEST refresh's stale fraction, and
# the default re-bootstrap threshold (see LandmarkCache.drifted)
DRIFT_DECAY = 0.5
DRIFT_THRESHOLD = 0.6


@dataclasses.dataclass
class LandmarkCache:
    """L exact landmark distance vectors for one graph; answers approximate
    SSSP with O(L·n) numpy and no engine run. ``graph_version`` records the
    PartitionedGraph version the vectors were computed at. On a delta the
    service no longer flushes the tier: ``stale_landmarks`` proves which
    vectors a delta could have changed (O(L·|delta|) against the cached
    distances) and ``refresh`` recomputes ONLY those, resuming each from its
    previous fixpoint via the batched dirty-frontier restart.

    Re-selection drift: the degree-chosen landmarks can stop being hubs
    after many deltas, and the symptom is cheap to observe — the fraction of
    vectors each refresh proves stale. ``stale_frac_ewma`` tracks it across
    versions (EWMA, weight ``DRIFT_DECAY`` on the latest refresh);
    ``drifted()`` crossing ``DRIFT_THRESHOLD`` tells the service the
    maintenance path has degraded to near-full recomputes, at which point
    re-BOOTSTRAPPING (fresh landmark selection on the current degree
    distribution) is the better spend. The signal rides serving telemetry
    (GraphQueryService.landmark_telemetry)."""
    landmarks: np.ndarray          # (L,) global vertex ids
    dist: np.ndarray               # (L, n) exact distances from each landmark
    graph_version: int = 0
    queries_answered: int = 0
    refreshed_landmarks: int = 0   # vectors recomputed at the last refresh()
    strategy: str = "degree"       # selection strategy (re-bootstrap reuses it)
    stale_frac_ewma: float = 0.0   # EWMA of per-refresh stale fractions
    refreshes: int = 0             # maintenance refreshes since bootstrap

    @property
    def num_landmarks(self) -> int:
        return int(self.landmarks.shape[0])

    def drifted(self, threshold: float = DRIFT_THRESHOLD) -> bool:
        """True when the refresh path has degraded enough that fresh
        landmark selection beats maintaining the current set. Needs at
        least two refreshes of evidence — one removal-heavy delta marks
        everything stale without implying the LANDMARKS drifted."""
        return self.refreshes >= 2 and self.stale_frac_ewma > threshold

    @staticmethod
    def build(pg: PartitionedGraph, num_landmarks: int = 8,
              strategy: str = "degree", backend: str = "local", mesh=None,
              landmarks: Optional[Sequence[int]] = None, gb=None,
              device="cuda") -> "LandmarkCache":
        """One batched SSSP run with the landmarks as the query batch.
        ``gb``: a device block of ``pg`` with the binned adjacency to share
        (the service's); the engine uploads its own when None."""
        from repro_torch.core import GopherEngine
        from repro_torch.serving.batched import (BatchedSemiringProgram,
                                                 gather_query_results,
                                                 sssp_query_init)
        lm = (np.asarray(landmarks, np.int64) if landmarks is not None
              else choose_landmarks(pg, num_landmarks, strategy=strategy))
        prog = BatchedSemiringProgram(semiring="min_plus",
                                      num_queries=int(lm.shape[0]))
        eng = GopherEngine(pg, prog, backend=backend, mesh=mesh, gb=gb,
                           device=device)
        state, _ = eng.run_queries(extra={"qinit": sssp_query_init(pg, lm)})
        return LandmarkCache(landmarks=lm,
                             dist=gather_query_results(pg, state["x"]),
                             graph_version=pg.version, strategy=strategy)

    def stale_landmarks(self, delta, directed: bool = False,
                        removed: Optional[int] = None) -> np.ndarray:
        """(L,) bool: which landmark vectors ``delta`` may have changed.

        A landmark's SSSP fixpoint survives an insert-only delta iff no
        inserted edge relaxes under its CURRENT distances — the standard
        first-improved-vertex argument: if some distance strictly improved,
        the minimal improved endpoint's last path edge is an inserted edge
        whose tail kept its old distance, so that edge relaxes against the
        old vector. Checking every inserted edge against the cached vector
        is therefore exact (for non-negative weights), O(L·|delta|), and
        needs no engine run. An insert that only re-adds an edge at a
        higher weight can flag a false positive (the min duplicate policy
        keeps the old weight) — conservative, never wrong. Removals can
        lengthen paths in ways the cached vector cannot bound, so any
        REALIZED removal marks every landmark stale; ``removed`` (the
        applied count, ``DeltaResult.stats['removed']``) lets a delta whose
        removals all MISSED stay on the cheap insert-only test."""
        L = self.num_landmarks
        if (delta.num_removes if removed is None else removed) > 0:
            return np.ones(L, bool)
        if delta.num_inserts == 0:
            return np.zeros(L, bool)
        u = np.asarray(delta.insert_src, np.int64)
        v = np.asarray(delta.insert_dst, np.int64)
        w = np.asarray(delta.insert_wgt, np.float32)
        du, dv = self.dist[:, u], self.dist[:, v]          # (L, Ni)
        relax = du + w[None, :] < dv
        if not directed:
            relax |= dv + w[None, :] < du
        return np.any(relax, axis=1)

    def refresh(self, pg: PartitionedGraph, delta_result, delta,
                directed: bool = False, backend: str = "local", mesh=None,
                gb=None, exchange: str = "auto", tier_plan=None,
                profile_block=None, device="cuda") -> "LandmarkCache":
        """The post-delta maintenance path: keep every landmark vector the
        delta provably couldn't touch, and resume the stale ones from their
        previous fixpoints in one batched dirty-frontier restart
        (algorithms.incremental.incremental_sssp_batched) instead of
        re-running the full bootstrap SSSP. ``gb`` shares the serving
        fleet's (zero-repack-patched) device graph block, uploaded with
        its binned adjacency;
        ``exchange``/``tier_plan`` route the restart — the service passes
        its narrow-only single-phase plan here (Gopher Phases), since the
        refresh is exactly a narrow-frontier resume. ``profile_block``: the
        graph's HOST block — when given, the restart's wire observation is
        folded into its traffic + changed profiles, which also CONSUMES the
        pending announce record (the restart is the run it pre-announced;
        without the fold, announce records would max-accumulate across
        versions on a service that only ever refreshes landmarks)."""
        from repro_torch.algorithms.incremental import \
            incremental_sssp_batched
        from repro_torch.core import update_changed_profile, update_profile
        stale = self.stale_landmarks(
            delta, directed=directed,
            removed=delta_result.stats.get("removed"))
        dist = self.dist.copy()
        if stale.any():
            fresh, tele = incremental_sssp_batched(
                pg, self.landmarks[stale], self.dist[stale], delta_result,
                backend=backend, mesh=mesh, gb=gb, exchange=exchange,
                tier_plan=tier_plan, device=device)
            dist[stale] = fresh
            if profile_block is not None and tele.pair_slots is not None:
                update_profile(profile_block, tele.pair_slots,
                               tele.pair_rounds)
                update_changed_profile(profile_block, tele.count_hist)
        frac = float(stale.sum()) / max(self.num_landmarks, 1)
        ewma = ((1.0 - DRIFT_DECAY) * self.stale_frac_ewma
                + DRIFT_DECAY * frac)
        return LandmarkCache(landmarks=self.landmarks, dist=dist,
                             graph_version=pg.version,
                             queries_answered=self.queries_answered,
                             refreshed_landmarks=int(stale.sum()),
                             strategy=self.strategy,
                             stale_frac_ewma=ewma,
                             refreshes=self.refreshes + 1)

    def approx_sssp(self, source: int) -> np.ndarray:
        """(n,) UPPER bounds on d(source, ·): min over landmarks of the
        two-leg route through each landmark. inf where no landmark reaches
        both endpoints."""
        self.queries_answered += 1
        to_lm = self.dist[:, source]                   # (L,) d(source, l)
        return np.min(to_lm[:, None] + self.dist, axis=0)

    def lower_bound_sssp(self, source: int) -> np.ndarray:
        """(n,) LOWER bounds via |d(s,l) - d(l,t)| (finite legs only)."""
        to_lm = self.dist[:, source]
        diff = np.abs(to_lm[:, None] - self.dist)
        diff[~(np.isfinite(to_lm)[:, None] & np.isfinite(self.dist))] = 0.0
        return np.max(diff, axis=0)

    def bounds(self, s: int, t: int) -> tuple:
        """(lower, upper) on the single pair distance d(s, t)."""
        return (float(self.lower_bound_sssp(s)[t]),
                float(self.approx_sssp(s)[t]))
