"""The port's Gopher Balance (live sub-graph migration) against the JAX
package's, on the CPU.

``plan_migration`` and ``apply_migration`` (its ``MigrationResult``, the
new graph's fields, the patched host block and the event log) equal the
JAX package's field for field; a migration at ``tests/test_resilience.py``'s
local-backend corners, resumed through ``migrate_and_resume``, ends
bit-equal in global order to the JAX package's migration-free run;
``run_with_rebalance`` heals a targeted straggler and rolls back a corrupt
patch; the service's ``svc.query``/``svc.apply_delta`` hooks and
``rebalance`` behave as the JAX service's; the chaos CLI's ``--quick`` run
passes on the CPU. The graph is ``tests/test_resilience.py``'s
``_strip_pg``: a 6 x 12 road grid in 2-column strips, partition 0 holding
two non-adjacent strips, partitions 1 and 2 half full.
"""
import dataclasses
import json
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.resilience.balance as jbal  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import host_graph_block as j_host_block  # noqa: E402
from repro.core import init_max_vertex as j_init_max  # noqa: E402
from repro.core import make_sssp_init as j_sssp_init  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.gofs.generators import road_grid  # noqa: E402
from repro.gofs.temporal import EdgeDelta as JDelta  # noqa: E402
from repro.obs.skew import SkewTracker as JSkewTracker  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro.serving.service import GraphQueryService as JService  # noqa: E402

import repro_torch.resilience.balance as tbal  # noqa: E402
from repro_torch.core import (GopherEngine, SemiringProgram,  # noqa: E402
                              host_graph_block, init_max_vertex,
                              make_sssp_init, verify_host_block)
from repro_torch.gofs import EdgeDelta  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.launch import chaos  # noqa: E402
from repro_torch.obs.skew import SkewTracker  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.serving.service import GraphQueryService  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def strip():
    """(JAX pg, port pg, the JAX package's migration-free dense runs in
    global order)."""
    rows, cols = 6, 12
    g = road_grid(rows, cols, drop_frac=0.0, seed=0, weighted=True)
    s = (np.arange(rows * cols) % cols) // 2
    assign = np.asarray([0, 1, 2, 0, 3, 3], np.int32)[s]
    jpg = partition_graph(g, assign, 4)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(jpg))
    refs = {a: jbal.to_global(JEngine(jpg, _prog(a, jpg, "jax"),
                                      exchange="dense").run()[0], jpg)
            for a in ("cc", "sssp")}
    return jpg, tpg, refs


def _prog(algo, pg, pkg):
    jax_pkg = pkg == "jax"
    if algo == "cc":
        return (JSemiring("max_first", j_init_max) if jax_pkg
                else SemiringProgram("max_first", init_max_vertex))
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    return (JSemiring("min_plus", j_sssp_init(*loc)) if jax_pkg
            else SemiringProgram("min_plus", make_sssp_init(*loc)))


def _same_global(ref, state):
    assert sorted(ref) == sorted(state)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(state[k])), k


def _same_value(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same_value(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a == b, what


def test_plan_migration_matches_jax(strip):
    """Budgets below, at and above a sub-graph, loads, full and
    self destinations and a partition that does not exist."""
    jpg, tpg, _ = strip
    cases = [dict(src=0, budget=11), dict(src=0, budget=12),
             dict(src=0, budget=24), dict(src=0, budget=12, dst=3),
             dict(src=0, budget=12, dst=0), dict(src=9, budget=12),
             dict(src=0, budget=12, load=np.array([4.0, 0.5, 0.2, 0.5])),
             dict(src=3, budget=48), dict(src=1, budget=12, dst=2)]
    moved = 0
    for kw in cases:
        j, t = jbal.plan_migration(jpg, **kw), tbal.plan_migration(tpg, **kw)
        assert (j is None) == (t is None), kw
        if j is not None:
            assert dataclasses.asdict(j) == dataclasses.asdict(t), kw
            moved += 1
    assert moved >= 4


def test_apply_migration_matches_jax(strip):
    """The migrated graph, the patched host block (patched through
    ``patch_host_block``, then announced), the move record, the stats and
    the event log equal the JAX package's, to a non-adjacent and an
    adjacent destination; the patched block passes its audit."""
    jpg, tpg, _ = strip
    for dst in (2, 1):
        jplan = jbal.plan_migration(jpg, src=0, budget=12, dst=dst)
        tplan = tbal.plan_migration(tpg, src=0, budget=12, dst=dst)
        jres = jbal.apply_migration(jpg, jplan, host_gb=j_host_block(jpg))
        tres = tbal.apply_migration(tpg, tplan,
                                    host_gb=host_graph_block(tpg))
        assert verify_host_block(tres.block) == []
        assert tres.stats == jres.stats
        assert tres.stats["out_moved" if dst == 2 else "converted_local"] > 0
        for f in ("moved_gids", "old_slots", "new_slots"):
            _same_value(getattr(jres, f), getattr(tres, f), f)
        _same_value(dataclasses.asdict(jres.pg), dataclasses.asdict(tres.pg),
                    "pg")
        _same_value(jres.block, tres.block, "block")
        touched, rdel, radd = tres.events
        _same_value(jres.events[0], touched, "touched_rows")
        _same_value([tuple(map(int, e)) for e in jres.events[1]],
                    [tuple(map(int, e)) for e in rdel], "rdel")
        _same_value([tuple(map(int, e)) for e in jres.events[2]],
                    [tuple(map(int, e)) for e in radd], "radd")
        assert tres.pg.version == tpg.version + 1
    # no block: the same graph, no patch
    plain = tbal.apply_migration(tpg, tplan)
    assert plain.block is None
    _same_value(dataclasses.asdict(plain.pg), dataclasses.asdict(tres.pg),
                "pg without block")


@pytest.mark.parametrize("algo,mode,k,budget,dst", [
    ("cc", "dense", 1, 12, None), ("cc", "megastep", 2, 24, None),
    ("cc", "tiered", 4, 12, 1), ("sssp", "compact", 2, 12, 2),
    ("sssp", "megastep", 5, 12, 1)])
def test_migration_superstep_corners(strip, algo, mode, k, budget, dst):
    """Run k supersteps, migrate, resume: the final state equals the JAX
    package's migration-free run in global order, and the migrated engine
    keeps the requested exchange."""
    _, tpg, refs = strip
    eng = GopherEngine(tpg, _prog(algo, tpg, "torch"), exchange=mode,
                       device="cpu")
    plan = tbal.plan_migration(tpg, src=0, budget=budget, dst=dst)
    assert plan is not None                 # corners are chosen to move
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        eng.run(checkpointer=ck, checkpoint_every=1, superstep_budget=k)
        eng2, res, at = tbal.migrate_and_resume(eng, ck, plan)
        assert at == ck.latest_good_step() and eng2.pg is res.pg
        assert eng2.exchange == eng.exchange
        state, _ = eng2.run(checkpointer=ck, checkpoint_every=1,
                            resume=True)
    _same_global(refs[algo], tbal.to_global(state, eng2.pg))


def test_run_with_rebalance_heals_and_rolls_back(strip):
    """A load-proportional straggler on partition 0 trips the hint and the
    actuator migrates sub-graphs off it, bit-equal to the migration-free
    run (and the migrated engine serves a fresh run); with every patch
    corrupted, each migration rolls back, nothing installs, and the run
    still ends bit-equal."""
    _, tpg, refs = strip
    pol = tbal.BalancePolicy(threshold=1.3, floor=1.05,
                             max_verts_per_step=12, check_every=2)
    eng = GopherEngine(tpg, _prog("cc", tpg, "torch"), exchange="compact",
                       device="cpu")
    stall = faults.FaultSpec("engine.superstep", "straggler", prob=1.0,
                             times=9999, delay_s=0.002, payload={"part": 0})
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(faults.FaultPlan([stall])):
            eng2, state, tele, rep = tbal.run_with_rebalance(
                eng, Checkpointer(d), every=1, policy=pol)
    _same_global(refs["cc"], tbal.to_global(state, eng2.pg))
    assert rep.migrations and rep.rollbacks == 0
    assert all(m["src"] == 0 for m in rep.migrations)
    assert rep.final_step == tele.supersteps
    assert rep.moved_verts() == int(
        (np.asarray(tpg.part_of) != np.asarray(eng2.pg.part_of)).sum())
    _same_global(refs["cc"], tbal.to_global(eng2.run()[0], eng2.pg))

    corrupt = faults.FaultSpec("blocks.patch", "corrupt_block", prob=1.0,
                               times=9999)
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(faults.FaultPlan([stall, corrupt])):
            eng3, state, _, rep = tbal.run_with_rebalance(
                eng, Checkpointer(d), every=1, policy=pol)
    assert rep.rollbacks >= 1 and not rep.migrations
    assert all(f["kind"] == "corrupt_block" for f in rep.faults)
    assert eng3 is eng and eng3.pg.version == tpg.version
    _same_global(refs["cc"], tbal.to_global(state, eng3.pg))


def _skewed():
    t = type("T", (), {})()
    t.local_iters = np.array([40.0, 10.0, 10.0, 10.0])
    t.pair_slots = None
    t.part_seconds = np.array([4.0, 0.5, 0.5, 0.5])
    return t


def test_service_hooks_and_rebalance_match_jax(strip):
    """The same fault plans on both services: a poisoned query is retried,
    a failed delta is retried and installs, a corrupt patch cold-rebuilds;
    then ``rebalance`` on a skewed tracker rolls back a corrupt patch
    (version v serves on) and installs a clean move. Answers, versions,
    stats and the migration result agree with the JAX service's."""
    jpg, tpg, _ = strip
    js = JService({"g": jpg}, retry_base_s=0.001)
    ts = GraphQueryService({"g": tpg}, retry_base_s=0.001, device="cpu")
    # every insert crosses partitions, so partition 0 keeps its two
    # sub-graphs for the rebalance below
    kw = dict(insert_src=[1, 40], insert_dst=[70, 3],
              insert_wgt=[0.5, 0.25])
    steps = [
        ("query", ("sssp", "g", [0]), ("svc.query", "poisoned_query")),
        ("delta", kw, ("svc.apply_delta", "failed_delta")),
        ("query", ("bfs", "g", [5]), None),
        ("delta", dict(insert_src=[13], insert_dst=[50], insert_wgt=[1.5]),
         ("blocks.patch", "corrupt_block")),
        ("query", ("sssp", "g", [9]), None)]
    for what, arg, spec in steps:
        answers = {}
        for pkg, svc, f in (("jax", js, jfaults), ("torch", ts, faults)):
            plan = (f.FaultPlan([f.FaultSpec(spec[0], spec[1], at=0)])
                    if spec else None)
            with f.inject(plan):
                if what == "query":
                    r = svc.query(*arg)
                    got = [r.error, r.result, r.supersteps]
                else:
                    delta = (JDelta if pkg == "jax" else EdgeDelta).of(**arg)
                    svc.apply_delta("g", delta)
                    got = [svc.graphs["g"].version]
            if plan is not None:
                got.append([(r["site"], r["kind"], r["visit"])
                            for r in plan.record()])
            answers[pkg] = got
        _same_value(answers["jax"], answers["torch"], what)
        assert answers["torch"][0] is not None or what == "query"
    keys = ("query_retries", "delta_retries", "recoveries", "migrations",
            "migration_rollbacks", "degraded_batches", "batches")
    assert {k: ts.stats()[k] for k in keys} == \
        {k: js.stats()[k] for k in keys}
    assert ts.stats()["imbalance"] == js.stats()["imbalance"]
    assert ts.stats()["skew"]["g"]["runs"] == js.stats()["skew"]["g"]["runs"]

    # rebalance: a skewed tracker, a corrupt patch first, then a clean move
    js.skew["g"] = JSkewTracker(num_parts=4)
    ts.skew["g"] = SkewTracker(num_parts=4)
    js.skew["g"].observe(_skewed())
    ts.skew["g"].observe(_skewed())
    r0 = ts.query("sssp", "g", [0])
    for svc, f in ((js, jfaults), (ts, faults)):
        with f.inject(f.FaultPlan([f.FaultSpec("blocks.patch",
                                               "corrupt_block", at=0)])):
            assert svc.rebalance("g") is None
    v = ts.graphs["g"].version
    assert ts.stats()["migration_rollbacks"] == 1
    assert ts.stats()["breakers"] == js.stats()["breakers"]
    assert ts.query("sssp", "g", [0]).error is None
    # the clean attempt: the tracker kept its skew through the rollback
    jres, tres = js.rebalance("g"), ts.rebalance("g")
    assert tres is not None and ts.graphs["g"].version == v + 1
    assert dataclasses.asdict(tres.plan) == dataclasses.asdict(jres.plan)
    _same_value(dataclasses.asdict(jres.pg), dataclasses.asdict(tres.pg),
                "migrated pg")
    r1 = ts.query("sssp", "g", [0])
    assert r1.error is None and np.array_equal(r0.result, r1.result)
    assert ts.stats()["migrations"] == js.stats()["migrations"] == 1
    assert ts.rebalance("g") is None                   # tracker was reset


def test_chaos_quick_on_the_cpu(tmp_path):
    """Every default scenario passes its gates on the CPU; ``skew_heal``
    migrates and halves the imbalance at least, and its side file sits
    beside the report, in a directory the CLI makes; ``device_loss``,
    asked for by name, passes on 4 gloo ranks: each algorithm's mesh
    shrinks from 4 ranks to 2 with partitions [2, 3] lost, one restart,
    results equal to the fault-free run."""
    out = tmp_path / "reports" / "chaos.json"
    rc = chaos.main(["--quick", "--device", "cpu", "--out", str(out)])
    # every assertion names the report it read, so that a failure under
    # load says which gate broke and on what numbers
    rep = json.loads(out.read_text())
    assert rc == 0, rep
    assert sorted(rep["scenarios"]) == sorted(chaos._DEFAULT), rep
    assert "device_loss" not in rep["scenarios"], rep
    assert all(r["ok"] for r in rep["scenarios"].values()), rep
    heal = rep["scenarios"]["skew_heal"]["algos"]["cc"]
    assert heal["migrations"] and heal["imbalance_drop"] >= 2.0, heal
    assert (tmp_path / "reports" / "balance_torch.json").exists()
    lost = tmp_path / "lost.json"
    rc = chaos.main(["--quick", "--device", "cpu", "--out", str(lost),
                     "--scenarios", "device_loss", "--devices", "4"])
    loss = json.loads(lost.read_text())["scenarios"]["device_loss"]
    assert rc == 0, loss
    assert loss["ok"] and sorted(loss["algos"]) == ["cc", "pagerank"], loss
    for r in loss["algos"].values():
        assert r["parity"] and r["restarts"] == 1, loss
        assert (r["old_devices"], r["new_devices"]) == (4, 2), loss
        assert r["lost_partitions"] == [2, 3], loss
