"""The port's serving front end against the JAX package's, on the CPU.

The planner (pure Python) and ``ResultCache``; ``LandmarkCache`` build,
bounds, stale set and refresh; ``GraphQueryService`` end to end against
the JAX service on the same stream (results, errors, cached flags,
supersteps, summary counts), its dedupe of identical in-flight queries,
deadline misses, the circuit breaker with ``_run_batch_once`` made to
raise and a patched block that fails its audit, in both services,
``apply_delta`` with landmarks, ``warm`` with its ``metrics=`` feed, and
the service on a one-rank mesh beside the 'local' one. The graphs are
``tests/test_serving.py``'s, in 4 partitions.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.serving as jsrv  # noqa: E402
from repro.gofs import (bfs_grow_partition, powerlaw_social,  # noqa: E402
                        road_grid)
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.gofs.temporal import EdgeDelta as JDelta  # noqa: E402
from repro.gofs.temporal import apply_delta as j_apply  # noqa: E402

import repro_torch.serving as tsrv  # noqa: E402
from repro_torch.core import GopherEngine  # noqa: E402
from repro_torch.gofs import EdgeDelta, apply_delta  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.obs import MetricsRegistry, default_registry  # noqa: E402
from repro_torch.serving import planner as tplanner  # noqa: E402

# one stream: SSSP, BFS and multi-seed reachability, PPR, a repeat (a
# cache hit in the next drain), an in-flight duplicate, an out-of-range
# source, an unknown graph, an unknown kind, two sources for sssp
STREAM = [("sssp", "social", 1), ("sssp", "social", 50),
          ("sssp", "social", 200), ("bfs", "road", 0),
          ("reach", "road", (0, 100)), ("ppr", "social", 9),
          ("sssp", "social", 50), ("sssp", "social", 10 ** 6),
          ("sssp", "nowhere", 0), ("walk", "social", 0),
          ("sssp", "social", (1, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graphs():
    """name: (JAX pg, port pg)."""
    out = {}
    g = powerlaw_social(600, m=4, seed=2)
    pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    out["social"] = pg
    g = road_grid(14, 14, drop_frac=0.05, seed=1)     # unit weights: BFS
    out["road"] = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    return {k: (v, partitioned_graph_from_fields(dataclasses.asdict(v)))
            for k, v in out.items()}


def _services(graphs, **kw):
    return (jsrv.GraphQueryService({k: v[0] for k, v in graphs.items()},
                                   **kw),
            tsrv.GraphQueryService({k: v[1] for k, v in graphs.items()},
                                   device="cpu", **kw))


def _same_response(a, b):
    assert (a.ticket, dataclasses.astuple(a.query), a.error, a.cached,
            a.supersteps) == (b.ticket, dataclasses.astuple(b.query),
                              b.error, b.cached, b.supersteps)
    if a.result is None:
        assert b.result is None
    elif a.query.kind == "ppr":
        np.testing.assert_allclose(b.result, a.result, rtol=1e-6, atol=1e-9)
    else:
        assert np.array_equal(b.result, a.result)


@pytest.fixture(scope="module")
def served(graphs):
    """Both services after the stream and one more drain that repeats a
    query: (JAX service, port service, [JAX responses], [port ones])."""
    jsvc, tsvc = _services(graphs, max_batch=4)
    outs = []
    for svc in (jsvc, tsvc):
        for kind, g, s in STREAM:
            svc.submit(kind, g, s)
        first = svc.drain()
        outs.append([first, {-1: svc.query("sssp", "social", 50)}])
    return jsvc, tsvc, outs[0], outs[1]


def test_planner_matches_jax():
    """The same batches (graph, family, queries, bucket) and rejections
    (query, reason) on one stream, oversize groups split."""
    sizes = {"g": 100, "h": 50}
    qs = [("sssp", "g", 1), ("sssp", "g", 2), ("bfs", "g", 3),
          ("reach", "g", (4, 5)), ("ppr", "h", 6), ("sssp", "MISSING", 0),
          ("sssp", "g", 999), ("unknown", "g", 1), ("reach", "h", ()),
          ("ppr", "h", (1, 2))] + [("sssp", "g", i) for i in range(10, 21)]
    for max_batch in (4, 8, 64):
        jb, jr = jsrv.plan([jsrv.Query.make(*q) for q in qs], sizes,
                           max_batch=max_batch)
        tb, tr = tsrv.plan([tsrv.Query.make(*q) for q in qs], sizes,
                           max_batch=max_batch)
        assert [dataclasses.astuple(b) for b in tb] == \
            [dataclasses.astuple(b) for b in jb]
        assert [(dataclasses.astuple(q), r) for q, r in tr] == \
            [(dataclasses.astuple(q), r) for q, r in jr]
    assert [tsrv.bucket_size(n) for n in (1, 2, 3, 5, 9, 33, 100)] == \
        [jsrv.bucket_size(n) for n in (1, 2, 3, 5, 9, 33, 100)]


def test_result_cache_lru():
    c = tsrv.ResultCache(capacity=2)
    c.put("a", np.zeros(1))
    c.put("b", np.ones(1))
    assert c.get("a") is not None          # refresh 'a'
    c.put("c", np.ones(1))                 # evicts 'b'
    assert c.get("b") is None
    assert c.get("a") is not None and c.get("c") is not None
    assert c.invalidate(lambda k: k == "a") == 1
    assert c.stats() == dict(entries=1, hits=3, misses=1, invalidations=1,
                             hit_rate=0.75)
    assert tsrv.ResultCache(capacity=0).put("x", np.ones(1)) is None


def test_landmark_cache_matches_jax(graphs):
    """Build (the landmarks, the distances), the bounds, the stale set of
    an insert and of a removal delta, and the refresh, against the JAX
    package's; the refreshed vectors equal a cold build on version 1."""
    pg, tpg = graphs["road"]
    jlc = jsrv.LandmarkCache.build(pg, num_landmarks=6)
    tlc = tsrv.LandmarkCache.build(tpg, num_landmarks=6, device="cpu")
    assert np.array_equal(tlc.landmarks, jlc.landmarks)
    assert np.array_equal(tlc.dist, jlc.dist)
    for s in (30, int(tlc.landmarks[0])):
        assert np.array_equal(tlc.approx_sssp(s), jlc.approx_sssp(s))
        assert np.array_equal(tlc.lower_bound_sssp(s),
                              jlc.lower_bound_sssp(s))
        assert tlc.bounds(s, 100) == jlc.bounds(s, 100)
    ins = ([0, 3, 40], [100, 150, 190], [1.0, 1.0, 1.0])
    jd, td = JDelta.inserts(*ins), EdgeDelta.inserts(*ins)
    assert np.array_equal(tlc.stale_landmarks(td), jlc.stale_landmarks(jd))
    assert tlc.stale_landmarks(EdgeDelta.removes([0], [1])).all()
    jres, tres = j_apply(pg, jd), apply_delta(tpg, td)
    jnew = jlc.refresh(jres.pg, jres, jd)
    tnew = tlc.refresh(tres.pg, tres, td, device="cpu")
    assert np.array_equal(tnew.dist, jnew.dist)
    for k in ("graph_version", "refreshed_landmarks", "stale_frac_ewma",
              "refreshes", "queries_answered"):
        assert getattr(tnew, k) == getattr(jnew, k), k
    cold = tsrv.LandmarkCache.build(tres.pg, landmarks=tlc.landmarks,
                                    device="cpu")
    assert np.array_equal(tnew.dist, cold.dist)


def test_service_matches_jax_service(served):
    """Every response of the stream and the repeat: result, error, cached
    flag and the query's own supersteps; the summary's counts, the
    report's keys and the per-graph imbalance its skew trackers read."""
    jsvc, tsvc, jout, tout = served
    for jd, td in zip(jout, tout):
        assert sorted(td) == sorted(jd)
        for t in jd:
            _same_response(jd[t], td[t])
    assert tout[1][-1].cached
    js, ts = jsvc.stats.summary(), tsvc.stats.summary()
    for k in ("served", "cache_hits", "rejected", "batches", "mean_fill"):
        assert ts[k] == js[k], k
    assert ts["served"] == 8 and ts["cache_hits"] == 1 and ts["qps"] > 0
    assert set(tsvc.stats()) == set(jsvc.stats())
    assert tsvc.stats()["imbalance"] == jsvc.stats()["imbalance"]
    assert tsvc.stats()["engine_supersteps"] == \
        jsvc.stats()["engine_supersteps"]


def test_service_dedupes_identical_inflight(graphs):
    _, tsvc = _services({"social": graphs["social"]}, max_batch=8)
    t1 = tsvc.submit("sssp", "social", 5)
    t2 = tsvc.submit("sssp", "social", 5)
    out = tsvc.drain()
    assert out[t1].result is out[t2].result
    assert tsvc.stats.batches == 1 and tsvc.stats.served == 2


def test_degradation_matches_jax(graphs, monkeypatch):
    """A request past its deadline is a typed error; a batch whose runs
    raise is retried, degrades to a typed error, opens the breaker, and
    the open breaker refuses the next batch; a patched block that fails
    its audit once is dropped and the retried apply installs version 1 —
    the same responses and counters in both services under the same
    patches."""
    import repro.serving.service as jservice
    import repro_torch.serving.service as tservice

    def boom(self, batch):
        raise RuntimeError("poisoned batch")

    for mod in (jservice, tservice):
        audit = mod.verify_host_block
        calls = []

        def corrupt_once(block, _audit=audit, _calls=calls):
            _calls.append(1)
            return ["corrupt"] if len(_calls) == 1 else _audit(block)
        monkeypatch.setattr(mod, "verify_host_block", corrupt_once)
    road = {"road": graphs["road"]}
    ins = ([0, 3], [100, 150], [1.0, 1.0])
    reports = []
    for svc, delta in zip(_services(road, max_retries=1, retry_base_s=0.0,
                                    breaker_threshold=2,
                                    breaker_cooldown_s=1e9),
                          (JDelta.inserts(*ins), EdgeDelta.inserts(*ins))):
        svc.apply_delta("road", delta)
        ok = svc.query("bfs", "road", 2)
        with monkeypatch.context() as m:
            m.setattr(type(svc), "_run_batch_once", boom)
            svc.deadline_s = -1.0             # every request is late
            late = svc.query("bfs", "road", 0)
            svc.deadline_s = None
            r1 = svc.query("bfs", "road", 3)
            r2 = svc.query("bfs", "road", 4)
        reports.append(((ok.error, ok.supersteps, late.error, r1.error,
                         r2.error, svc.graphs["road"].version), {
            k: svc.stats()[k] for k in (
                "deadline_misses", "query_retries", "breaker_opens",
                "degraded_batches", "recoveries", "served", "breakers",
                "delta_retries", "delta_failures")}))
    assert reports[1] == reports[0]
    (ok, _, late, r1, r2, version), st = reports[1]
    assert ok is None and version == 1
    assert late == "deadline exceeded"
    assert r1 == "degraded: poisoned batch" and "circuit open" in r2
    assert st["breaker_opens"] == 1 and st["breakers"] == {"road": "open"}
    assert st["delta_retries"] == 1 and st["recoveries"] == 1


def test_apply_delta_with_landmarks(graphs):
    """``apply_delta(rebuild_landmarks=True)`` patches, audits and
    re-uploads the block and refreshes the landmarks, as the JAX service
    does; queries after it answer on version 1, and the refreshed vectors
    equal a cold build there."""
    road = {"road": graphs["road"]}
    jsvc, tsvc = _services(road)
    ins = ([0, 3, 40], [100, 150, 190], [1.0, 1.0, 1.0])
    for svc, delta in ((jsvc, JDelta.inserts(*ins)),
                       (tsvc, EdgeDelta.inserts(*ins))):
        svc.query("sssp", "road", 7)
        svc.enable_landmarks("road", 6)
        svc.apply_delta("road", delta, rebuild_landmarks=True)
    assert tsvc.graphs["road"].version == jsvc.graphs["road"].version == 1
    assert tsvc.landmark_telemetry("road") == jsvc.landmark_telemetry("road")
    tlc = tsvc.landmark_caches["road"]
    assert np.array_equal(tlc.dist, jsvc.landmark_caches["road"].dist)
    cold = tsrv.LandmarkCache.build(tsvc.graphs["road"],
                                    landmarks=tlc.landmarks, device="cpu")
    assert np.array_equal(tlc.dist, cold.dist)
    _same_response(jsvc.query("sssp", "road", 7), tsvc.query("sssp", "road",
                                                              7))
    assert np.array_equal(tsvc.approx_sssp("road", 30),
                          jsvc.approx_sssp("road", 30))
    assert len(tsvc.stats.delta_apply_s) == 1


def test_warm_and_refusals(graphs, tmp_path):
    """``warm`` runs one batch per (family, bucket) on the engines real
    batches use, leaves the stats alone and counts the batches in the
    service's ``metrics=`` registry; ``rebalance`` without a skew picture
    does nothing. On a world of one gloo rank the service on
    ``backend='shard_map'`` (its shared block cut to the rank's rows)
    answers a stream as the 'local' service does, with its own convergence
    supersteps, and warms as many batches; ``shard_map`` without a mesh,
    or a mesh without it, is refused."""
    from _mesh_world import one_rank_world
    _, tpg = graphs["road"]
    reg = MetricsRegistry()
    svc = tsrv.GraphQueryService({"road": tpg}, metrics=reg, device="cpu")
    assert svc.metrics is reg
    assert svc.warm("road", families=("reach", "ppr"), qs=(1, 2)) == 4
    assert reg.snapshot()["counters"] == {
        "serving_warm_compiles_total{graph=road}": 4}
    assert sorted(svc._engines) == [("road", f, q) for f in
                                    ("ppr", "traversal") for q in (1, 2)]
    assert svc.stats.batches == 0 and svc.stats.served == 0
    assert all(isinstance(e, GopherEngine) for e in svc._engines.values())
    assert svc.rebalance("road") is None and svc.skew == {}
    assert tsrv.GraphQueryService({"road": tpg}, device="cpu").metrics \
        is default_registry()
    for kw in ({"backend": "shard_map"}, {"mesh": object()}):
        with pytest.raises(ValueError, match="go together"):
            tsrv.GraphQueryService({"road": tpg}, device="cpu", **kw)
    stream = [("sssp", 0), ("bfs", 7), ("reach", (1, 30)), ("ppr", 4),
              ("sssp", 90), ("bfs", 7)]
    local = tsrv.GraphQueryService({"road": tpg}, device="cpu")
    with one_rank_world(tmp_path) as mesh:
        msvc = tsrv.GraphQueryService({"road": tpg}, backend="shard_map",
                                      mesh=mesh, device="cpu")
        for s in (local, msvc):
            for kind, src in stream:
                s.submit(kind, "road", src)
        want, got = local.drain(), msvc.drain()
        assert msvc._gb["road"]["vmask"].shape[0] == tpg.num_parts
        assert msvc._exchange_mode() == "auto"
        assert msvc.warm("road", families=("reach", "ppr")) == 2
    assert sorted(got) == sorted(want)
    for t, w in want.items():
        g = got[t]
        assert (g.error, g.cached, g.supersteps) == (w.error, w.cached,
                                                     w.supersteps)
        if w.query.kind == "ppr":
            np.testing.assert_allclose(g.result, w.result, rtol=1e-5,
                                       atol=0)
        else:
            assert np.array_equal(g.result, w.result)
    assert all(e.exchange == "dense" for e in msvc._engines.values())
    assert msvc.stats.summary()["batches"] == local.stats.summary()[
        "batches"]
    assert tplanner.FAMILY_OF_KIND["reach"] == "traversal"
