"""The port's Gopher Scope feeds and traced routes against the JAX
package's, on the CPU.

The metrics the engine (every exchange, a tiered rerun, a taught phased
plan, a checkpointed run), the tier planner, the block patcher, the
service (and its pooled engines, in the default registry) and the
resilience loops feed equal the JAX package's for the same runs, the
wall-clock histograms' sums and percentiles left out; a traced query batch
and a traced tiered rerun give the JAX package's span trees; a traced
straggler's stalls land in ``part_seconds``; a tracer refuses a
checkpointer; ``profiler_dir`` writes a trace on the CPU; the scope CLI
writes its three files with the JAX CLI's spans and metrics. The graph is
``tests/test_obs.py``'s 14 x 14 road grid in 4 partitions.
"""
import collections
import contextlib
import dataclasses
import json
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core.tiers as jtiers  # noqa: E402
import repro.launch.scope as jscope  # noqa: E402
import repro.obs.metrics as jmetrics  # noqa: E402
import repro.resilience.balance as jbal  # noqa: E402
import repro.serving as jsrv  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import host_graph_block as j_host_block  # noqa: E402
from repro.core import init_max_vertex as j_init_max  # noqa: E402
from repro.core import make_sssp_init as j_sssp_init  # noqa: E402
from repro.gofs import bfs_grow_partition, road_grid  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.gofs.temporal import EdgeDelta as JDelta  # noqa: E402
from repro.gofs.temporal import apply_delta as j_apply  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import validate_metrics as j_validate_metrics  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro.resilience import run_with_recovery as j_recovery  # noqa: E402
from repro.serving import sssp_query_init as j_query_init  # noqa: E402
from repro.training.checkpoint import Checkpointer as JCheckpointer  # noqa: E402,E501

import repro_torch.core.tiers as ttiers  # noqa: E402
import repro_torch.obs.metrics as tmetrics  # noqa: E402
import repro_torch.resilience.balance as tbal  # noqa: E402
import repro_torch.serving as tsrv  # noqa: E402
from repro_torch.core import (GopherEngine, SemiringProgram,  # noqa: E402
                              host_graph_block, init_max_vertex,
                              make_sssp_init)
from repro_torch.gofs import EdgeDelta, apply_delta  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.launch import scope  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Tracer,  # noqa: E402
                             set_tracer, validate_chrome_trace,
                             validate_metrics)
from repro_torch.resilience import faults, run_with_recovery  # noqa: E402
from repro_torch.serving import sssp_query_init  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402

# wall-clock histograms: only their counts are the same run to run
WALL = ("serving_latency_seconds", "serving_delta_apply_seconds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def road():
    g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
    jpg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    return jpg, partitioned_graph_from_fields(dataclasses.asdict(jpg))


def _prog(algo, pg, jax_pkg: bool):
    if algo == "cc":
        return (JSemiring("max_first", j_init_max) if jax_pkg
                else SemiringProgram("max_first", init_max_vertex))
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    return (JSemiring("min_plus", j_sssp_init(*loc)) if jax_pkg
            else SemiringProgram("min_plus", make_sssp_init(*loc)))


def _comparable(snap: dict) -> dict:
    """A snapshot with the wall-clock histograms cut to their counts."""
    hist = {k: ({"count": v["count"]} if k.split("{")[0] in WALL else v)
            for k, v in snap["histograms"].items()}
    return dict(snap, histograms=hist)


@contextlib.contextmanager
def fresh_defaults():
    """A fresh default registry in both packages for the block; yields
    (JAX registry, port registry)."""
    jold, told = jmetrics.default_registry(), tmetrics.default_registry()
    try:
        yield (jmetrics.set_default_registry(None),
               tmetrics.set_default_registry(None))
    finally:
        jmetrics.set_default_registry(jold)
        tmetrics.set_default_registry(told)


def _same_snapshots(jreg, treg) -> dict:
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    validate_metrics(jsnap)
    j_validate_metrics(tsnap)
    assert _comparable(tsnap) == _comparable(jsnap)
    return tsnap


def span_tree(tracer) -> collections.Counter:
    return collections.Counter((s.name, s.depth) for s in tracer.spans)


def _narrow_tiered(pg, tiers):
    """The structural plan with the busiest pair demoted to cold: a cold
    SSSP fires every slot of it in the prime round, so the run reruns."""
    base = tiers.TierPlan.from_graph(pg)
    occ = tiers.occupancy_from_graph(pg)
    t = base.tiers.copy()
    t[np.unravel_index(np.argmax(occ), occ.shape)] = tiers.COLD
    return dataclasses.replace(base, tier_bytes=t.tobytes())


def _taught_phased(jpg, tpg):
    """Each package's PhasedTierPlan.from_block of a host block taught by
    its own compact CC run (two phases or more)."""
    plans = []
    for pg, jax_pkg, tiers, hb_of, eng in (
            (jpg, True, jtiers, j_host_block, JEngine),
            (tpg, False, ttiers, host_graph_block, GopherEngine)):
        kw = {} if jax_pkg else {"device": "cpu"}
        _, t = eng(pg, _prog("cc", pg, jax_pkg), exchange="compact",
                   metrics=JRegistry() if jax_pkg else MetricsRegistry(),
                   **kw).run()
        hb = hb_of(pg)
        tiers.update_profile(hb, t.pair_slots, t.pair_rounds)
        tiers.update_changed_profile(hb, t.count_hist)
        plans.append(tiers.PhasedTierPlan.from_block(hb))
    assert plans[1].num_phases >= 2
    return plans


def test_engine_metrics_and_traced_reruns_match_jax(road):
    """compact CC, a tiered SSSP that overflows and reruns dense, a phased
    CC on a taught plan and a checkpointed compact SSSP feed the engine's
    registry as in the JAX package; the tiered rerun and the phased run,
    traced, give the JAX package's span trees and counters."""
    jpg, tpg = road
    with fresh_defaults():
        jplan, tplan = _taught_phased(jpg, tpg)
        jreg, treg = JRegistry(), MetricsRegistry()
        trees = []
        for pg, jax_pkg in ((jpg, True), (tpg, False)):
            eng, reg, trc, ck, tiers = (
                (JEngine, jreg, JTracer, JCheckpointer, jtiers) if jax_pkg
                else (GopherEngine, treg, Tracer, Checkpointer, ttiers))
            kw = {} if jax_pkg else {"device": "cpu"}
            eng(pg, _prog("cc", pg, jax_pkg), exchange="compact",
                metrics=reg, **kw).run()
            tr = trc()
            _, t = eng(pg, _prog("sssp", pg, jax_pkg), exchange="tiered",
                       tier_plan=_narrow_tiered(pg, tiers), metrics=reg,
                       tracer=tr, **kw).run()
            assert t.retried and t.spills > 0
            tp = trc()
            _, t = eng(pg, _prog("cc", pg, jax_pkg), exchange="phased",
                       tier_plan=jplan if jax_pkg else tplan, metrics=reg,
                       tracer=tp, **kw).run()
            assert len(t.phase_switch_steps) >= 1
            with tempfile.TemporaryDirectory() as d:
                eng(pg, _prog("sssp", pg, jax_pkg), exchange="compact",
                    metrics=reg, **kw).run(checkpointer=ck(d),
                                           checkpoint_every=2)
            trees.append((span_tree(tr), tr.counts, span_tree(tp),
                          tp.counts))
        assert trees[0] == trees[1]
        assert ("dense-retry", 0) in trees[1][0]
        assert trees[1][2][("phase", 1)] == tplan.num_phases
        snap = _same_snapshots(jreg, treg)
    c = snap["counters"]
    assert c["engine_runs_total{backend=local,exchange=compact}"] == 2
    assert c["engine_dense_retries_total{backend=local,exchange=tiered}"] \
        == 1


def test_tier_and_block_metrics_match_jax(road):
    """Plan builds (static, phased, resume), the three profile folds and
    a delta's zero-repack patch feed the default registry as in the JAX
    package: counts, drift gauges and the patch's row/slot counters."""
    jpg, tpg = road
    ins = ([0, 3, 40], [100, 150, 190], [1.0, 1.0, 1.0])
    with fresh_defaults() as (jreg, treg):
        for pg, jax_pkg in ((jpg, True), (tpg, False)):
            tiers, hb_of, eng, delta, apply = (
                (jtiers, j_host_block, JEngine, JDelta, j_apply) if jax_pkg
                else (ttiers, host_graph_block, GopherEngine, EdgeDelta,
                      apply_delta))
            kw = {} if jax_pkg else {"device": "cpu"}
            tiers.TierPlan.from_graph(pg)
            hb = hb_of(pg)
            _, t = eng(pg, _prog("cc", pg, jax_pkg), exchange="phased",
                       tier_plan=tiers.PhasedTierPlan.from_graph(pg),
                       **kw).run()
            tiers.update_profile(hb, t.pair_slots, t.pair_rounds)
            tiers.update_changed_profile(hb, t.count_hist)
            tiers.update_phase_profile(hb, t.phase_pair_slots, t.phase_hist)
            tiers.PhasedTierPlan.from_block(hb)
            res = apply(pg, delta.inserts(*ins), block=hb)
            tiers.PhasedTierPlan.for_resume(res.block)
            tiers.PhasedTierPlan.narrow_resume(res.block)
        snap = _same_snapshots(jreg, treg)
    c = snap["counters"]
    for kind in ("static", "phased", "resume"):
        assert c[f"tiers_plans_built_total{{kind={kind}}}"] >= 1, kind
    assert c["blocks_patches_total"] == 1
    assert snap["gauges"]["tiers_profile_drift{profile=phase_pair}"] > 0


def test_service_metrics_match_jax(road):
    """One stream (batches, a hit, a rejection), landmarks and a delta
    through both services with ``metrics=``: every serving_* metric
    equals the JAX service's, and the pooled engines' engine_* metrics
    land in the default registry as the JAX package's do."""
    jpg, tpg = road
    stream = [("sssp", 1), ("bfs", 0), ("reach", (0, 100)), ("ppr", 9),
              ("sssp", 1), ("sssp", 10 ** 6)]
    ins = ([0, 3, 40], [100, 150, 190], [1.0, 1.0, 1.0])
    with fresh_defaults() as (jdef, tdef):
        jreg, treg = JRegistry(), MetricsRegistry()
        jsvc = jsrv.GraphQueryService({"g": jpg}, metrics=jreg)
        tsvc = tsrv.GraphQueryService({"g": tpg}, metrics=treg,
                                      device="cpu")
        for svc, delta in ((jsvc, JDelta), (tsvc, EdgeDelta)):
            for kind, s in stream:
                svc.submit(kind, "g", s)
            svc.drain()
            svc.query("sssp", "g", 1)
            svc.enable_landmarks("g", 4)
            svc.apply_delta("g", delta.inserts(*ins), rebuild_landmarks=True)
            svc.query("sssp", "g", 2)
        snap = _same_snapshots(jreg, treg)
        _same_snapshots(jdef, tdef)
        assert any(k.startswith("engine_runs_total")
                   for k in tdef.snapshot()["counters"])
    c = snap["counters"]
    assert c["serving_requests_total{result=hit}"] \
        + c["serving_requests_total{result=served}"] == tsvc.stats.served
    assert not any(k.startswith("engine_") for k in c)


def test_resilience_counters_match_jax():
    """A crash recovered by run_with_recovery ticks
    recovery_restarts_total, and a migration through migrate_and_resume
    rebalance_migrations_total, in the engine's registry as in the JAX
    package; the migrated engine keeps the tracer and the registry. The
    graph is ``tests/test_torch_balance.py``'s strip-folded 6 x 12 grid,
    whose partition 0 holds two sub-graphs and has somewhere to move."""
    rows, cols = 6, 12
    g = road_grid(rows, cols, drop_frac=0.0, seed=0, weighted=True)
    assign = np.asarray([0, 1, 2, 0, 3, 3], np.int32)[
        (np.arange(rows * cols) % cols) // 2]
    jpg = partition_graph(g, assign, 4)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(jpg))
    jreg, treg = JRegistry(), MetricsRegistry()
    for pg, jax_pkg in ((jpg, True), (tpg, False)):
        eng, reg, ck, f, rec, bal, trc = (
            (JEngine, jreg, JCheckpointer, jfaults, j_recovery, jbal,
             JTracer(enabled=False)) if jax_pkg
            else (GopherEngine, treg, Checkpointer, faults,
                  run_with_recovery, tbal, Tracer(enabled=False)))
        kw = {} if jax_pkg else {"device": "cpu"}
        e = eng(pg, _prog("cc", pg, jax_pkg), exchange="compact",
                metrics=reg, tracer=trc, **kw)
        plan = f.FaultPlan([f.FaultSpec("engine.superstep", "crash", at=2)])
        with tempfile.TemporaryDirectory() as d:
            with f.inject(plan):
                _, _, rep = rec(e, ck(d), every=1)
            assert rep.restarts == 1
            mplan = bal.plan_migration(pg, src=0, budget=12)
            assert mplan is not None
            e.run(checkpointer=ck(d + "/m"), checkpoint_every=1,
                  superstep_budget=1)
            e2, _, _ = bal.migrate_and_resume(e, ck(d + "/m"), mplan)
            assert e2._metrics is reg and e2._tracer is trc
    snap = _same_snapshots(jreg, treg)
    assert snap["counters"]["recovery_restarts_total{backend=local}"] == 1
    assert snap["counters"]["rebalance_migrations_total{backend=local}"] == 1


def test_traced_run_queries_match_jax(road):
    """A traced SSSP batch of 3 on the fused and the compact route equals
    the untraced batch (state and telemetry) and gives the JAX package's
    query_supersteps, span tree and counters."""
    jpg, tpg = road
    srcs = [0, 50, 150]
    for exchange in ("auto", "compact"):
        jtr, tr = JTracer(), Tracer()
        js, jt = JEngine(jpg, jsrv.BatchedSemiringProgram("min_plus", 3),
                         exchange=exchange, tracer=jtr).run_queries(
            extra={"qinit": j_query_init(jpg, srcs)})
        runs = [GopherEngine(tpg, tsrv.BatchedSemiringProgram("min_plus", 3),
                             exchange=exchange, tracer=t,
                             device="cpu").run_queries(
            extra={"qinit": sssp_query_init(tpg, srcs)})
            for t in (None, tr)]
        (s0, t0), (s1, t1) = runs
        assert np.array_equal(s0["x"], s1["x"])
        assert np.array_equal(s1["x"], np.asarray(js["x"]))
        for f in dataclasses.fields(t0):
            if f.name != "part_seconds":
                a, b = getattr(t0, f.name), getattr(t1, f.name)
                assert (a is None and b is None) or np.array_equal(
                    np.asarray(a), np.asarray(b)), f.name
        assert np.array_equal(t1.query_supersteps, jt.query_supersteps)
        assert t1.supersteps == jt.supersteps
        assert span_tree(tr) == span_tree(jtr) and tr.counts == jtr.counts
        run = next(s for s in tr.spans if s.name == "run")
        assert run.args["queries"] == 3


def test_traced_straggler_lands_in_part_seconds(road):
    """A straggler on partition 2 in a traced fused and a traced compact
    CC: part_seconds[2] − part_seconds[p] is the recorded stalls' sum for
    every other p (to the recorder's rounding), and the labels are the
    untraced run's."""
    _, tpg = road
    for exchange in ("megastep", "compact"):
        ref, _ = GopherEngine(tpg, _prog("cc", tpg, False),
                              exchange=exchange, device="cpu").run()
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "straggler", prob=1.0, times=9999,
            delay_s=1e-5, payload={"part": 2})])
        with faults.inject(plan):
            state, tele = GopherEngine(
                tpg, _prog("cc", tpg, False), exchange=exchange,
                tracer=Tracer(), device="cpu").run()
        assert np.array_equal(state["x"], ref["x"])
        fired = plan.record()
        assert len(fired) == tele.supersteps
        stalls = sum(r["stall_s"] for r in fired)
        ps = tele.part_seconds
        others = np.delete(ps, 2)
        assert np.allclose(ps[2] - others, stalls, rtol=0,
                           atol=5e-7 * len(fired) + 1e-12)
        assert np.all(others == others[0])
        assert tele.skew()["time_straggler"] == 2


def test_tracer_refuses_a_checkpointer_and_arms_late(road):
    """A traced run with a checkpointer raises ValueError (the JAX package
    asserts there), also when the tracer is the process default armed
    after the engine was built; an engine built before set_tracer traces
    its next run."""
    _, tpg = road
    eng = GopherEngine(tpg, _prog("cc", tpg, False), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="checkpoint"):
            GopherEngine(tpg, _prog("cc", tpg, False), tracer=Tracer(),
                         device="cpu").run(checkpointer=Checkpointer(d),
                                           checkpoint_every=1)
        tr = set_tracer(Tracer())
        try:
            with pytest.raises(ValueError, match="checkpoint"):
                eng.run(checkpointer=Checkpointer(d), checkpoint_every=1)
            _, t = eng.run()
        finally:
            set_tracer(None)
    assert eng.tracer is not tr
    assert [s.name for s in tr.spans].count("superstep") == t.supersteps


def test_profiler_dir_writes_a_trace_on_the_cpu(road, tmp_path):
    """``Tracer(profiler_dir=)`` wraps the run in torch.profiler (CPU
    activity only on a CPU run) and writes one Chrome trace a run."""
    _, tpg = road
    tr = Tracer(profiler_dir=str(tmp_path / "prof"))
    for exchange in ("megastep", "compact"):
        GopherEngine(tpg, _prog("sssp", tpg, False), exchange=exchange,
                     tracer=tr, device="cpu").run()
    assert len(tr.profiles) == 2
    for path in tr.profiles:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
    validate_chrome_trace(tr.chrome_trace())
    assert tr.balanced


def test_scope_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.scope --device cpu`` prints the
    timeline, skew and metrics and writes scope_trace.json, .jsonl and
    scope_metrics.json, with the JAX CLI's span tree and metrics for the
    same arguments; with ``--backend shard_map --devices 2`` (two gloo
    ranks, ROADMAP A8.1) rank 0 writes the same span tree (the JAX
    package's traced ``shard_map`` run's tree is held in
    tests/test_torch_mesh.py)."""
    argv = ["--algo", "sssp", "--rows", "14", "--cols", "14",
            "--exchange", "phased", "--boundary-sync"]
    outs = {}
    with fresh_defaults():
        for name, main, extra in (("jax", jscope.main, []),
                                  ("torch", scope.main,
                                   ["--device", "cpu"])):
            out = tmp_path / name
            main(argv + extra + ["--out", str(out)])
            outs[name] = out
    printed = capsys.readouterr().out
    assert "superstep" in printed and "# metrics" in printed
    trees, snaps = [], []
    for name in ("jax", "torch"):
        out = outs[name]
        with open(out / "scope_trace.json") as f:
            validate_chrome_trace(json.load(f))
        with open(out / "scope_trace.jsonl") as f:
            trees.append(collections.Counter(
                (e["name"], e["depth"]) for e in map(json.loads, f)))
        with open(out / "scope_metrics.json") as f:
            snaps.append(json.load(f))
    assert trees[0] == trees[1]
    validate_metrics(snaps[0])
    j_validate_metrics(snaps[1])
    assert _comparable(snaps[0]) == _comparable(snaps[1])
    out = tmp_path / "mesh"
    scope.main(argv + ["--backend", "shard_map", "--devices", "2",
                       "--device", "cpu", "--out", str(out)])
    assert "backend=shard_map" in capsys.readouterr().out
    with open(out / "scope_trace.json") as f:
        validate_chrome_trace(json.load(f))
    with open(out / "scope_trace.jsonl") as f:
        assert collections.Counter(
            (e["name"], e["depth"]) for e in map(json.loads, f)) == trees[0]
    with open(out / "scope_metrics.json") as f:
        validate_metrics(json.load(f))
