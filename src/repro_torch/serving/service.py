"""Synchronous multi-tenant graph-query serving loop.

The port of the JAX package's ``serving/service.py``. Request lifecycle:

    submit()  ->  pending queue (ticket + arrival timestamp)
    drain()   ->  1. deadline admission, then the exact-cache pass
                     (ResultCache): hits never touch the engine, and
                     identical in-flight queries are deduplicated
                  2. planner: admit, group by (graph, family), pad to
                     power-of-two buckets
                  3. one batched BSP run per batch on a pooled engine —
                     engines are pooled per (graph, family, bucket) and all
                     engines of a graph share ONE device graph block (with
                     its binned adjacency), so steady state is: copy the
                     query arrays to the device, run supersteps, gather
                  4. per-query Response with latency + the query's OWN
                     convergence superstep (telemetry.query_supersteps)

Every batch run and every delta apply goes through a per-graph
``CircuitBreaker`` and a bounded exponential-backoff retry
(``resilience.degrade``). Aggregate telemetry (QPS, latency percentiles,
cache hit rate, bucket fill) accumulates in ServiceStats.

Gopher Shield's fault sites ``svc.apply_delta`` and ``svc.query``
(``resilience.faults``) fire on entry of every attempt; every batch's
telemetry feeds the graph's ``SkewTracker`` (``svc.skew``, the
``imbalance``/``skew`` keys of ``stats()``), which ``rebalance`` reads to
migrate sub-graphs off a straggler partition (Gopher Balance).

The service feeds the ``serving_*`` counters, histograms and gauges of
the JAX package's service into its metrics registry (``metrics=``, or the
process default); its pooled engines feed the default registry, as the
JAX package's do. Engines run on ``device`` (the card unless the caller
passes ``device='cpu'``).

On a mesh (``backend='shard_map', mesh=`` a one-axis ``('parts',)``
``DeviceMesh``, ``launch.mesh``) the service is SPMD, as the engine is:
every rank builds the same service and submits the same requests, and
each holds only its rows of each graph's shared device block
(``device_block(rows=)``). Pooled engines run the phased exchange on a
mesh of several ranks, with the graph's ``PhasedTierPlan`` built from the
host block's profiles and replaced by any escalation, and 'auto' on one
rank (see :meth:`GraphQueryService._exchange_mode`). What gates an engine
run agrees on every rank, or the ranks would part at a collective: the
deadline admission reads rank 0's ages of the requests, the breakers read
rank 0's clock, and a batch attempt that failed on any rank failed on
all (one all_reduce an attempt).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (GopherEngine, PhasedTierPlan, device_block,
                              host_graph_block, resolve_device,
                              update_changed_profile, update_phase_profile,
                              update_profile, verify_host_block)
from repro_torch.gofs.formats import PartitionedGraph
from repro_torch.gofs.temporal import DeltaValidationError
from repro_torch.launch.mesh import check_group
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.skew import SkewTracker
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.degrade import CircuitBreaker, backoff_delays
from repro_torch.resilience.faults import BlockCorruptionFault
from repro_torch.serving import planner as pl
from repro_torch.serving.batched import (BatchedPersonalizedPageRank,
                                         BatchedSemiringProgram,
                                         gather_query_results, ppr_query_seed,
                                         reachability_query_init)
from repro_torch.serving.cache import LandmarkCache, ResultCache


@dataclasses.dataclass
class Request:
    ticket: int
    query: pl.Query
    t_submit: float


@dataclasses.dataclass
class Response:
    ticket: int
    query: pl.Query
    result: Optional[np.ndarray]   # (n,) values in global vertex order
    cached: bool = False
    error: Optional[str] = None
    latency_s: float = 0.0
    supersteps: int = 0            # the query's own convergence superstep


@dataclasses.dataclass
class ServiceStats:
    served: int = 0
    cache_hits: int = 0
    rejected: int = 0
    batches: int = 0
    engine_supersteps: int = 0
    landmark_rebootstraps: int = 0   # drift-triggered full re-selections
    busy_seconds: float = 0.0
    # Gopher Shield degradation counters
    deadline_misses: int = 0         # queries answered (or dropped) past SLO
    query_retries: int = 0           # batch-run retry attempts
    delta_retries: int = 0           # delta-apply retry attempts
    delta_failures: int = 0          # delta batches given up on (stale mode)
    recoveries: int = 0              # retry/stale episodes that healed
    stale_served: int = 0            # responses served at version v while a
                                     # failed delta left v+1 pending
    breaker_opens: int = 0           # circuit-breaker open transitions
    degraded_batches: int = 0        # batches answered with a typed error
                                     # instead of a client-facing exception
    # Gopher Balance live-migration counters
    migrations: int = 0              # skew-healing migrations installed
    migration_rollbacks: int = 0     # patched blocks that failed the audit
                                     # (pre-migration version kept serving)
    # bounded windows: long-running services must not grow without limit
    lane_fill: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024))
    latencies_s: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=8192))
    delta_apply_s: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024))
    # back-reference set by GraphQueryService so ``svc.stats()`` can fold in
    # the per-graph skew, landmark and breaker state
    _service: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    def qps(self) -> float:
        return self.served / self.busy_seconds if self.busy_seconds > 0 else 0.0

    def latency_ms(self, pct: float = 50.0) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), pct) * 1e3)

    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.served if self.served > 0 else 0.0

    def summary(self) -> dict:
        return dict(served=self.served, cache_hits=self.cache_hits,
                    rejected=self.rejected, batches=self.batches,
                    qps=round(self.qps(), 1),
                    p50_ms=round(self.latency_ms(50), 2),
                    p99_ms=round(self.latency_ms(99), 2),
                    mean_fill=round(float(np.mean(self.lane_fill)), 2)
                    if self.lane_fill else 1.0)

    def __call__(self) -> dict:
        """The serving report — ``svc.stats()``: everything in
        :meth:`summary` plus the latency tail, cache hit rate, delta-apply
        latency, the degradation counters, per-graph partition imbalance
        (the live SkewTracker) and the landmark and breaker state."""
        out = self.summary()
        out.update(
            p95_ms=round(self.latency_ms(95), 2),
            cache_hit_rate=round(self.cache_hit_rate(), 4),
            engine_supersteps=self.engine_supersteps,
            landmark_rebootstraps=self.landmark_rebootstraps,
            delta_apply_p50_ms=round(
                float(np.percentile(np.asarray(self.delta_apply_s), 50) * 1e3),
                3) if self.delta_apply_s else 0.0,
            deadline_misses=self.deadline_misses,
            query_retries=self.query_retries,
            delta_retries=self.delta_retries,
            delta_failures=self.delta_failures,
            recoveries=self.recoveries,
            stale_served=self.stale_served,
            breaker_opens=self.breaker_opens,
            degraded_batches=self.degraded_batches,
            migrations=self.migrations,
            migration_rollbacks=self.migration_rollbacks)
        svc = self._service
        if svc is not None:
            out["imbalance"] = {g: t.imbalance()
                                for g, t in svc.skew.items()}
            out["skew"] = {g: t.report() for g, t in svc.skew.items()}
            out["result_cache"] = svc.cache.stats()
            lms = {g: svc.landmark_telemetry(g) for g in svc.landmark_caches}
            if lms:
                out["landmarks"] = lms
            if svc.breakers:
                out["breakers"] = {g: b.state
                                   for g, b in svc.breakers.items()}
            if svc._stale_graphs:
                out["stale_graphs"] = sorted(svc._stale_graphs)
        return out


class GraphQueryService:
    """Serves sssp / bfs / reach / ppr queries over registered graphs."""

    def __init__(self, graphs: Dict[str, PartitionedGraph],
                 backend: str = "local", mesh=None, max_batch: int = 64,
                 cache_capacity: int = 1024, ppr_iters: int = 30,
                 warm_start: bool = False, metrics=None,
                 deadline_s: Optional[float] = None, max_retries: int = 2,
                 retry_base_s: float = 0.05, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0, clock=time.monotonic,
                 device="cuda"):
        self.device = resolve_device(device)
        if backend not in ("local", "shard_map"):
            raise ValueError(f"unknown backend {backend!r}")
        if (backend == "shard_map") != (mesh is not None):
            raise ValueError("backend='shard_map' and a mesh go together")
        self._group = None
        if mesh is not None:
            if mesh.ndim != 1 or mesh.device_type != self.device.type:
                raise ValueError(f"the service runs on a one-axis "
                                 f"{self.device.type} mesh")
            self._group = mesh.get_group()
            check_group(self._group, self.device)
            own_clock = clock

            def clock():  # every rank's breakers read one clock: rank 0's
                return self._on_rank0([own_clock()])[0]
        self.graphs = dict(graphs)
        self.backend = backend
        self.mesh = mesh
        self.max_batch = max_batch
        self.ppr_iters = ppr_iters
        self.warm_start = warm_start
        # Gopher Shield degradation policy: per-query deadline (None = no
        # SLO), bounded exponential-backoff retry on batch runs and delta
        # applies, and a per-graph circuit breaker. The clock is injectable
        # so tests drive deadlines/cooldowns without sleeping.
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.clock = clock
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._stale_graphs: set = set()  # graphs whose last delta FAILED:
                                         # still serving version v while
                                         # v+1 is pending (stale-serving)
        self.cache = ResultCache(cache_capacity)
        self.stats = ServiceStats()
        self.stats._service = self
        self._metrics = metrics
        self.landmark_caches: Dict[str, LandmarkCache] = {}
        # per-graph live straggler picture, fed by every batch run
        self.skew: Dict[str, SkewTracker] = {}
        self._gb: Dict[str, dict] = {}       # device graph blocks
        self._host_gb: Dict[str, dict] = {}  # patchable host twins (temporal)
        self._tier_plans: Dict[str, PhasedTierPlan] = {}  # Gopher Phases plans
        self._engines: Dict[tuple, GopherEngine] = {}
        self._pending: List[Request] = []
        self._next_ticket = 0
        if warm_start:
            for name in self.graphs:
                self.warm(name)

    @property
    def metrics(self) -> obs_metrics.MetricsRegistry:
        return (self._metrics if self._metrics is not None
                else obs_metrics.default_registry())

    # ---------------- graph lifecycle (temporal serving) ----------------
    def _cache_key(self, q: pl.Query) -> tuple:
        """Exact-cache key = query key + the target graph's VERSION, so a
        result computed at version k can never answer a query at k+1 (an
        unknown graph keys at version -1 and flows to admission rejection)."""
        pg = self.graphs.get(q.graph)
        return (q.cache_key(), pg.version if pg is not None else -1)

    def update_graph(self, name: str, pg: PartitionedGraph) -> None:
        """Swap in a new version of a registered graph and invalidate every
        per-graph derived artifact: cached results, pooled engines + their
        shared device block (shapes may have changed), and the landmark
        cache. Invalidation is UNCONDITIONAL for the graph name — the new
        graph may carry the same version number as the old one, so version
        equality proves nothing. (``apply_delta`` is the cheaper path for
        version bumps that came from an edge delta: it patches blocks and
        landmark vectors instead of dropping them.)"""
        self.graphs[name] = pg
        self.cache.invalidate(lambda k: k[0][0] == name)
        self._gb.pop(name, None)
        self._host_gb.pop(name, None)
        self._tier_plans.pop(name, None)
        self._engines = {k: e for k, e in self._engines.items()
                         if k[0] != name}
        self.landmark_caches.pop(name, None)

    def apply_delta(self, name: str, delta, directed: bool = False,
                    rebuild_landmarks: bool = False):
        """Ingest an edge-delta batch for a registered graph
        (``gofs.temporal``): bumps the graph version and invalidates the
        exact-result cache, but — unlike ``update_graph`` — keeps the
        derived state warm:

          - the host block is ZERO-REPACK patched in O(|delta|)
            (``apply_delta(block=...)``), audited
            (``verify_host_block``) and uploaded as the graph's one shared
            device block;
          - with ``rebuild_landmarks=True`` the landmark tier is MAINTAINED,
            not rebuilt: vectors the delta provably could not change stay
            (``LandmarkCache.stale_landmarks``), the rest resume from their
            previous fixpoints in one batched restart
            (``incremental_sssp_batched``) on the shared block. When the
            cache's stale-refresh EWMA crosses the drift threshold
            (``LandmarkCache.drifted``) the tier is RE-BOOTSTRAPPED with a
            fresh landmark selection instead, and
            ``stats.landmark_rebootstraps`` counts it.

        Returns the DeltaResult so callers can chain incremental analytics
        off the dirty seeds.

        The apply is retried ``max_retries`` times with exponential
        backoff. A patched block that fails its audit raises
        :class:`BlockCorruptionFault` and drops the cached block twins, so
        the next attempt cold-rebuilds from the still-installed version v.
        A :class:`DeltaValidationError` is permanent — nothing was
        installed — and re-raises at once. When every retry is spent the
        graph enters STALE-SERVING: version v keeps answering queries while
        v+1 stays pending; the next successful apply counts a recovery."""
        t0 = time.perf_counter()
        delays = backoff_delays(self.retry_base_s, self.max_retries)
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                _faults.fire("svc.apply_delta", graph=name, attempt=attempt)
                res = self._apply_delta_once(name, delta, directed,
                                             rebuild_landmarks, t0)
            except DeltaValidationError:
                self.stats.delta_failures += 1
                self.metrics.counter(
                    "serving_delta_failures_total",
                    labels={"graph": name, "kind": "invalid"}).inc()
                raise
            except BlockCorruptionFault as e:
                last = e
                self.stats.delta_retries += 1
                self._host_gb.pop(name, None)
                self._gb.pop(name, None)
                self.metrics.counter("serving_delta_retries_total",
                                     labels={"graph": name}).inc()
            except Exception as e:  # serving-loop boundary: degrade, not leak
                last = e
                self.stats.delta_retries += 1
                self.metrics.counter("serving_delta_retries_total",
                                     labels={"graph": name}).inc()
            else:
                if attempt or name in self._stale_graphs:
                    self._stale_graphs.discard(name)
                    self.stats.recoveries += 1
                    self.metrics.counter(
                        "serving_recoveries_total",
                        labels={"graph": name, "site": "apply_delta"}).inc()
                return res
            if attempt < self.max_retries:
                time.sleep(delays[attempt])
        self._stale_graphs.add(name)
        self.stats.delta_failures += 1
        self.metrics.counter("serving_delta_failures_total",
                             labels={"graph": name, "kind": "exhausted"}).inc()
        raise last

    def _apply_delta_once(self, name: str, delta, directed: bool,
                          rebuild_landmarks: bool, t0: float):
        from repro_torch.gofs.temporal import apply_delta as _apply
        old_lc = self.landmark_caches.get(name)
        host_gb = self._host_gb.get(name)
        if host_gb is None:
            host_gb = host_graph_block(self.graphs[name])
        res = _apply(self.graphs[name], delta, directed=directed,
                     block=host_gb)
        # corrupted-block detection BEFORE install: a patched block that
        # fails the structural audit must never replace the serving twin
        problems = verify_host_block(res.block)
        if problems:
            raise BlockCorruptionFault(
                "blocks.patch", "corrupt_block", -1, {},
                {"problems": "; ".join(problems[:3])})
        self.update_graph(name, res.pg)
        self._host_gb[name] = res.block
        self._gb[name] = self._upload(name, res.block)
        if rebuild_landmarks and old_lc is not None:
            if old_lc.drifted():
                self.landmark_caches[name] = LandmarkCache.build(
                    res.pg, num_landmarks=old_lc.num_landmarks,
                    strategy=old_lc.strategy, backend=self.backend,
                    mesh=self.mesh, gb=self._gb[name], device=self.device)
                self.stats.landmark_rebootstraps += 1
                self.metrics.counter("serving_landmark_rebootstraps_total",
                                     labels={"graph": name}).inc()
            else:
                # on a phased service the refresh, a narrow-frontier
                # resume, rides the narrow-only single-phase plan
                exchange, plan = "auto", None
                if self._exchange_mode() == "phased":
                    exchange = "phased"
                    plan = PhasedTierPlan.narrow_resume(res.block)
                self.landmark_caches[name] = old_lc.refresh(
                    res.pg, res, delta, directed=directed,
                    backend=self.backend, mesh=self.mesh, gb=self._gb[name],
                    exchange=exchange, tier_plan=plan,
                    profile_block=res.block, device=self.device)
        if self.warm_start:
            self.warm(name)
        dt = time.perf_counter() - t0
        self.stats.delta_apply_s.append(dt)
        reg = self.metrics
        reg.counter("serving_deltas_applied_total",
                    labels={"graph": name}).inc()
        reg.histogram("serving_delta_apply_seconds").observe(dt)
        lc = self.landmark_caches.get(name)
        if lc is not None:
            reg.gauge("serving_landmark_stale_frac",
                      labels={"graph": name}).set(lc.stale_frac_ewma)
        return res

    def rebalance(self, name: str, policy=None):
        """Gopher Balance on the serving path: read the graph's live
        :class:`SkewTracker`, ask ``launch.elastic.rebalance_hint`` whether
        the partition layout is worth healing, and if so migrate sub-graphs
        off the straggler partition through the same synthetic-delta
        machinery ``apply_delta`` uses — ``patch_host_block`` on the host
        twin, O(moved cut), no re-partition.

        The move rides the STALE-SERVING discipline: version v keeps
        answering every query until the patched block passes its
        ``verify_host_block`` audit; a failed audit installs NOTHING
        (``stats.migration_rollbacks`` counts it, the graph's circuit
        breaker records the failure) and v serves on. On success the
        patched version installs exactly like a delta (update_graph +
        block twins) and ``stats.migrations`` ticks.

        Returns the ``MigrationResult`` when a migration installed, else
        None (balanced graph, nothing movable, or rolled back)."""
        from repro_torch.launch import elastic
        from repro_torch.resilience.balance import (BalancePolicy,
                                                    apply_migration,
                                                    plan_migration)

        pol = policy or BalancePolicy()
        tracker = self.skew.get(name)
        pg = self.graphs.get(name)
        if tracker is None or pg is None:
            return None
        rep = tracker.report()
        hint = elastic.rebalance_hint(rep, threshold=pol.threshold,
                                      floor=pol.floor)
        if hint is None:
            return None
        load = (tracker.seconds
                if tracker.seconds is not None
                and np.any(tracker.seconds > 0) else tracker.liters)
        plan = plan_migration(pg, src=int(hint["migrate_from"]),
                              budget=pol.max_verts_per_step, load=load)
        if plan is None:
            return None
        host_gb = self._host_gb.get(name)
        if host_gb is None:
            host_gb = host_graph_block(pg)
        try:
            res = apply_migration(pg, plan, host_gb=host_gb)
            problems = verify_host_block(res.block)
        except BlockCorruptionFault as e:
            problems = [str(e)]
            res = None
        if problems:
            # rollback is free: nothing was installed, version v serves on
            self.stats.migration_rollbacks += 1
            br = self.breakers.get(name)
            if br is None:
                br = self.breakers[name] = CircuitBreaker(
                    threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s, clock=self.clock)
            br.record_failure()
            self.metrics.counter("serving_migration_rollbacks_total",
                                 labels={"graph": name}).inc()
            return None
        self.update_graph(name, res.pg)
        self._host_gb[name] = res.block
        self._gb[name] = self._upload(name, res.block)
        # the accumulated load picture described the PRE-move layout; reset
        # so the next decision reads post-move telemetry, not stale skew
        self.skew[name] = SkewTracker(num_parts=pg.num_parts,
                                      decay=tracker.decay)
        self.stats.migrations += 1
        self.metrics.counter(
            "serving_migrations_total",
            labels={"graph": name, "signal": hint.get("signal", "")}).inc()
        if self.warm_start:
            self.warm(name)
        return res

    def landmark_telemetry(self, name: str) -> Optional[dict]:
        """The landmark tier's drift signal for one graph: per-version
        stale-refresh fraction EWMA, refresh count, and whether the next
        maintained delta would trigger a re-bootstrap."""
        lc = self.landmark_caches.get(name)
        if lc is None:
            return None
        return dict(num_landmarks=lc.num_landmarks,
                    graph_version=lc.graph_version,
                    refreshed_landmarks=lc.refreshed_landmarks,
                    refreshes=lc.refreshes,
                    stale_frac_ewma=round(lc.stale_frac_ewma, 4),
                    drifted=lc.drifted(),
                    rebootstraps=self.stats.landmark_rebootstraps)

    # ---------------- request intake ----------------
    def submit(self, kind: str, graph: str, sources) -> int:
        """Enqueue a query; returns its ticket."""
        t = self._next_ticket
        self._next_ticket += 1
        self._pending.append(Request(ticket=t,
                                     query=pl.Query.make(kind, graph, sources),
                                     t_submit=time.perf_counter()))
        return t

    def query(self, kind: str, graph: str, sources) -> Response:
        """Convenience: submit one query and drain immediately."""
        t = self.submit(kind, graph, sources)
        return self.drain()[t]

    # ---------------- scheduler loop ----------------
    def drain(self) -> Dict[int, Response]:
        """Serve every pending request; returns {ticket: Response}."""
        t0 = time.perf_counter()
        reqs, self._pending = self._pending, []
        responses: Dict[int, Response] = {}

        # 1. per-query deadline admission: a request that already overran
        # its SLO is answered with a typed error instead of occupying an
        # engine lane (on a mesh by rank 0's ages, so every rank admits
        # alike); then the exact-cache pass and the dedupe of identical
        # in-flight queries
        ages = ([] if self.deadline_s is None
                else self._on_rank0([t0 - r.t_submit for r in reqs]))
        by_key: Dict[tuple, List[Request]] = {}
        for i, r in enumerate(reqs):
            if ages and ages[i] > self.deadline_s:
                self.stats.deadline_misses += 1
                self.metrics.counter("serving_deadline_misses_total").inc()
                responses[r.ticket] = Response(
                    ticket=r.ticket, query=r.query, result=None,
                    error="deadline exceeded", latency_s=ages[i])
                continue
            key = self._cache_key(r.query)
            hit = self.cache.get(key)
            if hit is not None:
                self.stats.cache_hits += 1
                responses[r.ticket] = Response(
                    ticket=r.ticket, query=r.query, result=hit, cached=True,
                    latency_s=time.perf_counter() - r.t_submit)
            else:
                by_key.setdefault(key, []).append(r)

        # 2. plan over unique uncached queries
        sizes = {name: pg.n_global for name, pg in self.graphs.items()}
        unique = [rs[0].query for rs in by_key.values()]
        batches, rejected = pl.plan(unique, sizes, max_batch=self.max_batch)
        for q, reason in rejected:
            self.stats.rejected += len(by_key[self._cache_key(q)])
            for r in by_key[self._cache_key(q)]:
                responses[r.ticket] = Response(
                    ticket=r.ticket, query=r.query, result=None, error=reason,
                    latency_s=time.perf_counter() - r.t_submit)

        # 3. one engine run per batch — a batch whose retries are exhausted
        # (or whose graph's breaker is open) DEGRADES to typed error
        # responses; the exception never reaches the client
        for batch in batches:
            try:
                results, qsteps = self._run_batch(batch)
            except Exception as e:
                self.stats.degraded_batches += 1
                self.metrics.counter("serving_degraded_batches_total",
                                     labels={"graph": batch.graph}).inc()
                err = f"degraded: {e}"
                for q in batch.queries:
                    for r in by_key[self._cache_key(q)]:
                        responses[r.ticket] = Response(
                            ticket=r.ticket, query=r.query, result=None,
                            error=err,
                            latency_s=time.perf_counter() - r.t_submit)
                continue
            for i, q in enumerate(batch.queries):
                # own copy — a row VIEW would pin the whole (Q, n) batch
                # array in the cache for its lifetime
                res = np.array(results[i])
                self.cache.put(self._cache_key(q), res)
                for r in by_key[self._cache_key(q)]:
                    responses[r.ticket] = Response(
                        ticket=r.ticket, query=r.query, result=res,
                        latency_s=time.perf_counter() - r.t_submit,
                        supersteps=int(qsteps[i]))

        # 4. aggregate telemetry
        done = [resp for resp in responses.values() if resp.error is None]
        if self._stale_graphs:
            stale = sum(1 for resp in done
                        if resp.query.graph in self._stale_graphs)
            if stale:
                self.stats.stale_served += stale
                self.metrics.counter(
                    "serving_stale_served_total").inc(stale)
        if self.deadline_s is not None:
            # delivered-but-late responses count as misses too (the client
            # got an answer; the SLO did not)
            self.stats.deadline_misses += sum(
                1 for resp in done if resp.latency_s > self.deadline_s)
        self.stats.served += len(done)
        self.stats.latencies_s.extend(resp.latency_s for resp in done)
        self.stats.busy_seconds += time.perf_counter() - t0
        reg = self.metrics
        hits = sum(1 for resp in done if resp.cached)
        reg.counter("serving_requests_total",
                    labels={"result": "hit"}).inc(hits)
        reg.counter("serving_requests_total",
                    labels={"result": "served"}).inc(len(done) - hits)
        reg.counter("serving_requests_total",
                    labels={"result": "rejected"}).inc(
                        len(responses) - len(done))
        lat = reg.histogram("serving_latency_seconds")
        for resp in done:
            lat.observe(resp.latency_s)
        reg.gauge("serving_cache_hit_rate").set(self.stats.cache_hit_rate())
        return responses

    # ---------------- batch execution ----------------
    def _run_batch(self, batch: pl.Batch):
        """One batched engine run behind the graph's circuit breaker and a
        bounded exponential-backoff retry. A graph whose breaker is OPEN
        refuses the run outright — its queries degrade to typed error
        responses in drain() while the caches and landmarks still answer —
        instead of burning retries on a broken graph; the cooldown's one
        HALF_OPEN trial re-closes it on success."""
        br = self.breakers.get(batch.graph)
        if br is None:
            br = self.breakers[batch.graph] = CircuitBreaker(
                threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s, clock=self.clock)
        delays = backoff_delays(self.retry_base_s, self.max_retries)
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if not br.allow():
                raise RuntimeError(f"circuit open for graph "
                                   f"{batch.graph!r} ({br.opens} opens)")
            err = None
            try:
                _faults.fire("svc.query", graph=batch.graph,
                             family=batch.family, attempt=attempt)
                out = self._run_batch_once(batch)
            except Exception as e:  # serving-loop boundary: degrade
                err = e
            if self._any(err is not None) and err is None:
                err = RuntimeError("the batch failed on another rank")
            if err is None:
                br.record_ok()
                if attempt:
                    self.stats.recoveries += 1
                    self.metrics.counter(
                        "serving_recoveries_total",
                        labels={"graph": batch.graph, "site": "query"}).inc()
                return self._account(batch, *out)
            last = err
            opens = br.opens
            br.record_failure()
            if br.opens > opens:
                self.stats.breaker_opens += 1
                self.metrics.counter("serving_breaker_opens_total",
                                     labels={"graph": batch.graph}).inc()
            self.stats.query_retries += 1
            self.metrics.counter("serving_query_retries_total",
                                 labels={"graph": batch.graph}).inc()
            if attempt < self.max_retries:
                time.sleep(delays[attempt])
        raise last

    def _query_arrays(self, pg: PartitionedGraph, family: str,
                      lanes: list) -> tuple:
        """The run's extra entries and the state key its results are in."""
        if family == "ppr":
            return {"qseed": ppr_query_seed(pg, [q[0] for q in lanes])}, "r"
        return {"qinit": reachability_query_init(pg, lanes)}, "x"

    def _run_batch_once(self, batch: pl.Batch):
        """One batched engine run: (the (Q, n) results, the telemetry, the
        engine). What it teaches the service is folded in by
        :meth:`_account`, once the attempt has succeeded on every rank."""
        pg = self.graphs[batch.graph]
        Q = batch.padded_q
        # pad lanes replay query 0; their results are sliced away below
        lanes = batch.queries + [batch.queries[0]] * (Q - len(batch.queries))
        extra, state_key = self._query_arrays(
            pg, batch.family, [q.sources for q in lanes])
        eng = self._engine(batch.graph, batch.family, Q)
        state, tele = eng.run_queries(extra=extra)
        return gather_query_results(pg, state[state_key]), tele, eng

    def _account(self, batch: pl.Batch, results, tele, eng):
        """Fold a served batch into the stats, the graph's skew tracker and
        metrics, its host block's traffic profiles and, after an
        escalation, its tier plan; returns the batch's results and each
        query's own convergence superstep."""
        self.stats.batches += 1
        self.stats.engine_supersteps += tele.supersteps
        self.stats.lane_fill.append(batch.fill)
        # Gopher Scope: fold the run into the graph's live straggler picture
        tracker = self.skew.setdefault(batch.graph, SkewTracker())
        tracker.observe(tele)
        reg = self.metrics
        reg.counter("serving_batches_total",
                    labels={"graph": batch.graph,
                            "family": batch.family}).inc()
        reg.histogram("serving_batch_supersteps").observe(tele.supersteps)
        reg.gauge("serving_partition_imbalance",
                  labels={"graph": batch.graph}).set(tracker.imbalance())
        # fold this batch's per-pair wire observation into the graph's
        # traffic profile and its frontier histogram into the
        # changed-histogram EWMA (what the next tier plan is built from)
        host = self._host_gb.get(batch.graph)
        if host is not None:
            if tele.pair_slots is not None:
                update_profile(host, tele.pair_slots, tele.pair_rounds)
            if tele.count_hist is not None:
                update_changed_profile(host, tele.count_hist)
            if tele.phase_pair_slots is not None:
                update_phase_profile(host, tele.phase_pair_slots,
                                     tele.phase_hist)
        # an overflow escalation the engine applied: freshly pooled
        # engines, and the graph's other pooled tier engines, start from
        # the promoted plan
        if tele.escalations:
            self._tier_plans[batch.graph] = eng.tier_plan
            for key, other in self._engines.items():
                if (key[0] == batch.graph
                        and other.exchange in ("tiered", "phased")):
                    other.tier_plan = eng.tier_plan
        return results[:len(batch.queries)], tele.query_supersteps

    def _graph_block(self, graph: str) -> dict:
        """The graph's one device block, with the binned adjacency the
        query-batched programs read, shared by all its pooled engines."""
        if graph not in self._gb:
            host = self._host_gb.get(graph)
            if host is None:
                host = host_graph_block(self.graphs[graph])
                self._host_gb[graph] = host   # keep the patchable twin for
                                              # the next apply_delta
            self._gb[graph] = self._upload(graph, host)
        return self._gb[graph]

    def _upload(self, graph: str, host: dict) -> dict:
        """``host`` as the graph's device block with the binned adjacency:
        on a mesh this rank's rows [r·v, (r+1)·v) only."""
        rows = slice(None)
        if self.mesh is not None:
            v = self.graphs[graph].num_parts // self.mesh.size()
            me = self.mesh.get_local_rank()
            rows = slice(me * v, (me + 1) * v)
        return device_block(host, self.device, binned=True, rows=rows)

    # ---------------- agreement over the mesh ----------------
    def _on_rank0(self, values: list) -> list:
        """``values`` (floats, as many on every rank) as the mesh's rank 0
        has them; as they are without a mesh."""
        if self._group is None or not values:
            return values
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=dist.get_global_rank(self._group, 0),
                       group=self._group)
        return t.tolist()

    def _any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the mesh."""
        if self._group is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return bool(t.item())

    # ---------------- the pooled engines ----------------
    def _exchange_mode(self) -> str:
        """The exchange pooled engines run: 'phased' (Gopher Phases) on a
        mesh of several ranks — the per-graph plans ride the host blocks'
        traffic and changed-histogram profiles — and 'auto' everywhere
        else (the fused route or dense on 'local', dense on a one-rank
        mesh, where compaction is pure overhead)."""
        if self.mesh is None:
            return "auto"
        return "phased" if self.mesh.size() > 1 else "auto"

    def _tier_plan(self, graph: str) -> Optional[PhasedTierPlan]:
        """The graph's current Gopher Phases plan (a mesh of several ranks
        only): built from the host block's profiles, kept until a version
        bump or an escalation replaces it."""
        if self._exchange_mode() != "phased":
            return None
        if graph not in self._tier_plans:
            self._graph_block(graph)          # builds the host twin
            self._tier_plans[graph] = PhasedTierPlan.from_block(
                self._host_gb[graph])
        return self._tier_plans[graph]

    def _engine(self, graph: str, family: str, Q: int) -> GopherEngine:
        """The pooled engine of (graph, family, bucket), on the exchange
        :meth:`_exchange_mode` gives. On 'local', 'auto' resolves to the
        fused route for the traversal family and to the staged dense route
        for PPR."""
        key = (graph, family, Q)
        if key not in self._engines:
            pg = self.graphs[graph]
            if family == "ppr":
                prog = BatchedPersonalizedPageRank(
                    n_global=pg.n_global, num_queries=Q,
                    num_iters=self.ppr_iters)
                max_ss = max(self.ppr_iters + 1, 64)
            else:
                prog = BatchedSemiringProgram(semiring="min_plus",
                                              num_queries=Q)
                max_ss = 4096
            self._engines[key] = GopherEngine(
                pg, prog, backend=self.backend, mesh=self.mesh,
                max_supersteps=max_ss, gb=self._graph_block(graph),
                exchange=self._exchange_mode(),
                tier_plan=self._tier_plan(graph), device=self.device)
        return self._engines[key]

    def warm(self, name: str, families=("reach",), qs=(1,)) -> int:
        """Run one batch per (family, bucket) ``name`` will serve, from
        vertex 0, off the request path: it builds the pooled engine and its
        composed mailbox, the kernels, and primes PyTorch's caching
        allocator (there is no ahead-of-time compile to do, so this is the
        JAX package's fallback of one real run). On a phased service each
        engine also runs once on the narrow-resume plan, the one the
        landmark refresh rides after every ``apply_delta``. A query kind
        names its family (``reach`` warms the traversal engine). ``qs``
        entries are the planner's padded bucket sizes. Returns the number
        of batches run; the stats do not count them."""
        pg = self.graphs[name]
        done = 0
        for family in families:
            family = pl.FAMILY_OF_KIND.get(family, family)
            for Q in qs:
                extra, _ = self._query_arrays(pg, family, [(0,)] * Q)
                eng = self._engine(name, family, Q)
                plans = [eng.tier_plan]
                if self._exchange_mode() == "phased":
                    plans.append(PhasedTierPlan.narrow_resume(
                        self._host_gb[name]))
                saved = eng.tier_plan
                try:
                    for plan in plans:
                        eng.tier_plan = plan
                        eng.run_queries(extra=extra)
                        done += 1
                finally:
                    eng.tier_plan = saved
        self.metrics.counter("serving_warm_compiles_total",
                             labels={"graph": name}).inc(done)
        return done

    # ---------------- landmark tier (approximate SSSP, zero supersteps) ----
    def enable_landmarks(self, graph: str, num_landmarks: int = 8,
                         strategy: str = "degree") -> LandmarkCache:
        """Bootstrap the landmark cache with one batched SSSP run on the
        graph's shared block."""
        lc = LandmarkCache.build(self.graphs[graph],
                                 num_landmarks=num_landmarks,
                                 strategy=strategy, backend=self.backend,
                                 mesh=self.mesh,
                                 gb=self._graph_block(graph),
                                 device=self.device)
        self.landmark_caches[graph] = lc
        return lc

    def approx_sssp(self, graph: str, source: int) -> np.ndarray:
        """Triangle-inequality upper bounds on d(source, ·) — answered from
        the landmark cache without running the engine."""
        return self.landmark_caches[graph].approx_sssp(source)
