"""The port's Gopher Shield against the JAX package's, on the CPU.

A ``FaultPlan`` driven through the same visits fires the same faults as
the JAX package's (Bernoulli draws included); ``run_with_recovery``
recovers crashes at ``tests/test_resilience.py``'s local-backend corners
bit-equal to the JAX package's fault-free run and raises
``RecoveryExhausted`` with its report; ``run_with_failover`` restarts a
crash in place and refuses device loss off a mesh or of every device
(the multi-rank failover is ``tests/test_torch_failover.py``'s);
``launch.elastic`` and ``obs.skew`` give the JAX package's answers; a
targeted straggler's stalls land in ``part_seconds`` exactly. The graph is
``tests/test_resilience.py``'s random graph (100 vertices, 8 partitions).
"""
import dataclasses
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.launch.elastic as jelastic  # noqa: E402
import repro.obs.skew as jskew  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import init_max_vertex as j_init_max  # noqa: E402
from repro.core import make_sssp_init as j_sssp_init  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.gofs.generators import random_graph  # noqa: E402
from repro.gofs.partition import bfs_grow_partition  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro.resilience.failover import \
    _largest_divisor_at_most as j_divisor  # noqa: E402

import repro_torch.launch.elastic as telastic  # noqa: E402
import repro_torch.obs.skew as tskew  # noqa: E402
from repro_torch.core import (GopherEngine, SemiringProgram,  # noqa: E402
                              init_max_vertex, make_sssp_init)
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.resilience import (RecoveryExhausted, faults,  # noqa: E402
                                    run_with_failover, run_with_recovery,
                                    shrink_parts_mesh)
from repro_torch.resilience.failover import \
    _largest_divisor_at_most  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graph():
    """(JAX pg, port pg) and the JAX package's fault-free dense runs."""
    g = random_graph(100, avg_degree=4.0, seed=3, weighted=True)
    jpg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(jpg))
    refs = {a: JEngine(jpg, _prog(a, jpg, "jax"), exchange="dense").run()
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


def _same_state(js, ts):
    assert sorted(js) == sorted(ts)
    for k in js:
        assert np.array_equal(np.asarray(js[k]), ts[k]), k


def test_fault_plan_records_what_the_jax_plan_records():
    """The same specs and seed, driven through the same visits of every
    site, raise the same fault kinds at the same visits and record the
    same dicts: exact visits, Bernoulli draws from (seed, spec) streams,
    ``times`` disarming, a flat straggler; the hook is a no-op unarmed."""
    def specs(f):
        return [f.FaultSpec("svc.query", "poisoned_query", prob=0.5,
                            times=3),
                f.FaultSpec("engine.superstep", "crash", at=2),
                f.FaultSpec("engine.superstep", "straggler", prob=0.3,
                            times=4, delay_s=1e-4),
                f.FaultSpec("blocks.patch", "corrupt_block", prob=0.2,
                            times=9),
                f.FaultSpec("svc.apply_delta", "failed_delta", at=5),
                f.FaultSpec("exchange.route", "device_loss", at=7,
                            payload={"lost": [1]})]

    def drive(f, plan):
        raised = []
        for v in range(30):
            for site in f.SITES:
                try:
                    plan.fire(site, step=v, backend="local")
                except f.InjectedFault as e:
                    raised.append((type(e).__name__, e.site, e.visit))
        return raised

    jplan, tplan = jfaults.FaultPlan(specs(jfaults), seed=11), \
        faults.FaultPlan(specs(faults), seed=11)
    got = drive(faults, tplan)
    assert got == drive(jfaults, jplan) and len(got) >= 5
    rec, jrec = tplan.record(), jplan.record()
    assert [{k: v for k, v in r.items() if k != "stall_s"} for r in rec] \
        == [{k: v for k, v in r.items() if k != "stall_s"} for r in jrec]
    assert [r.get("stall_s") for r in rec] == [r.get("stall_s")
                                               for r in jrec]
    tplan.reset()
    assert drive(faults, tplan) == got          # replayable
    assert faults.fire("engine.superstep") is None      # nothing armed
    assert faults.SITES == jfaults.SITES and faults.KINDS == jfaults.KINDS
    with pytest.raises(ValueError):
        faults.FaultSpec("nowhere", "crash")


@pytest.mark.parametrize("algo,mode,k", [
    ("cc", "dense", 0), ("cc", "megastep", 1), ("sssp", "compact", 3),
    ("sssp", "megastep", 4)])
def test_crash_superstep_corners(graph, algo, mode, k):
    """A crash at superstep k, recovered from the last snapshot, ends
    bit-equal to the JAX package's fault-free run; the report names the
    fault and the step it resumed from."""
    jpg, tpg, refs = graph
    eng = GopherEngine(tpg, _prog(algo, tpg, "torch"), exchange=mode,
                       device="cpu")
    plan = faults.FaultPlan(
        [faults.FaultSpec("engine.superstep", "crash", at=k)])
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(plan):
            state, tele, rep = run_with_recovery(eng, Checkpointer(d),
                                                 every=1)
    _same_state(refs[algo][0], state)
    assert rep.restarts == len(plan.fired) == 1
    assert rep.faults == [dict(site="engine.superstep", kind="crash",
                               visit=k)]
    # every=1: the newest snapshot is the step before the crash
    assert rep.resumed_steps == [k if k > 0 else None]
    assert rep.final_step == tele.supersteps == refs[algo][1].supersteps


def test_recovery_exhaustion_raises_with_report(graph):
    _, tpg, _ = graph
    eng = GopherEngine(tpg, _prog("cc", tpg, "torch"), exchange="compact",
                       device="cpu")
    plan = faults.FaultPlan(
        [faults.FaultSpec("engine.superstep", "crash", prob=1.0, times=99)])
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(plan):
            with pytest.raises(RecoveryExhausted) as ei:
                run_with_recovery(eng, Checkpointer(d), every=1,
                                  max_restarts=2)
    rep = ei.value.report
    assert rep.attempts == 3 and rep.restarts == 3
    assert all(f["kind"] == "crash" for f in rep.faults)
    assert isinstance(ei.value.last_error, faults.CrashFault)


def test_failover_restarts_a_crash_and_refuses_device_loss(graph,
                                                           tmp_path):
    """A crash restarts the same engine in place (bit-equal end); device
    loss on a 'local' engine raises ``ValueError`` (the JAX package
    asserts a ``shard_map`` backend), and so does losing the only device
    of a one-rank mesh, through ``run_with_failover`` and through
    ``shrink_parts_mesh``; the shrunk mesh's ranks follow the JAX
    package's sizing (``shrink_after_failure``, clamped to a divisor of
    P, survivors in order)."""
    from _mesh_world import one_rank_world

    from repro_torch.resilience.failover import _shrunk_ranks
    _, tpg, refs = graph
    eng = GopherEngine(tpg, _prog("sssp", tpg, "torch"), exchange="compact",
                       device="cpu")
    plan = faults.FaultPlan(
        [faults.FaultSpec("engine.superstep", "crash", at=2)])
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(plan):
            eng2, state, tele, rep = run_with_failover(eng, Checkpointer(d),
                                                       every=1)
    assert eng2 is eng and rep.restarts == 1 and rep.resumed_steps == [2]
    assert rep.new_num_devices is None
    _same_state(refs["sssp"][0], state)

    def lose(engine):
        lost = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "device_loss", at=1, payload={"lost": [0]})])
        with tempfile.TemporaryDirectory() as d:
            with faults.inject(lost):
                with pytest.raises(ValueError) as ei:
                    run_with_failover(engine, Checkpointer(d), every=1)
        return str(ei.value)
    assert "shard_map" in lose(eng)
    with one_rank_world(tmp_path) as mesh:
        assert "every device" in lose(GopherEngine(
            tpg, _prog("sssp", tpg, "torch"), backend="shard_map",
            mesh=mesh, exchange="compact", device="cpu"))
        with pytest.raises(ValueError, match="every device"):
            shrink_parts_mesh(mesh, [0], 8)
    for D, lost, P in ((4, [1], 8), (4, [0], 8), (4, [1, 2], 8),
                       (6, [5], 12), (8, [0, 7], 8), (3, [2], 7)):
        survivors = [r for r in range(D) if r not in lost]
        k = j_divisor(P, jelastic.shrink_after_failure(
            jelastic.MeshPlan((D,), ("parts",)), len(lost)).shape[0])
        assert _shrunk_ranks(list(range(D)), lost, P) == survivors[:k]


def test_elastic_answers_match_jax(tmp_path):
    """``rebalance_hint``, ``shrink_after_failure``, ``plan_mesh`` and the
    divisor clamp on a table of inputs; on a one-rank world
    ``MeshPlan.make`` and a ``('parts',)`` ``restart`` of a snapshot equal
    to the JAX package's, a pspec naming an axis the plan lacks refused,
    and the LM's ('data', 'model') plan built."""
    base = dict(imbalance=1.3, straggler=0, time_imbalance=0.0,
                time_straggler=-1)
    skews = [base, dict(base, imbalance=1.8), dict(base, imbalance=1.05),
             dict(base, imbalance=1.0),
             dict(base, time_imbalance=2.5, time_straggler=3),
             dict(imbalance=9.9, straggler=-1), {}]
    for sk in skews:
        for kw in ({}, {"acting": True}, {"threshold": 1.2, "floor": 1.25}):
            assert telastic.rebalance_hint(sk, **kw) == \
                jelastic.rebalance_hint(sk, **kw), (sk, kw)
    plans = [((8,), ("parts",)), ((4, 16), ("data", "model")),
             ((2, 2, 8), ("pod", "data", "model")),
             ((1, 16), ("data", "model"))]
    for shape, axes in plans:
        for lost in (0, 1, 3, 16, 17):
            t = telastic.shrink_after_failure(telastic.MeshPlan(shape, axes),
                                              lost)
            j = jelastic.shrink_after_failure(jelastic.MeshPlan(shape, axes),
                                              lost)
            assert (t.shape, t.axes) == (j.shape, j.axes)
    for n, mp, pods in ((64, 16, 1), (256, 16, 2), (8, 16, 1), (48, 8, 3)):
        t, j = telastic.plan_mesh(n, mp, pods), jelastic.plan_mesh(n, mp,
                                                                   pods)
        assert (t.shape, t.axes) == (j.shape, j.axes)
    for p, d in ((8, 3), (8, 4), (12, 5), (7, 6), (12, 0)):
        assert _largest_divisor_at_most(p, d) == j_divisor(p, d)
    # the mesh half on a world of one gloo rank: the plan's mesh, and a
    # snapshot re-sharded onto it equal to the JAX package's restart of
    # the same snapshot on its one device
    from jax.sharding import PartitionSpec as JP
    from _mesh_world import one_rank_world

    from repro.training.checkpoint import Checkpointer as JCheckpointer
    rng = np.random.default_rng(0)
    saved = {"state": {"x": rng.random((8, 5), np.float32),
                       "frontier": rng.random((8, 5)) < 0.5},
             "step": np.asarray(7, np.int32)}
    PS = telastic.PartitionSpec
    with one_rank_world(tmp_path) as _:
        plan = telastic.MeshPlan((1,), ("parts",))
        mesh = plan.make(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("parts",)
        with pytest.raises(ValueError, match="world of 1"):
            telastic.MeshPlan((2,), ("parts",)).make(device="cpu")
        ck = Checkpointer(str(tmp_path / "ck"))
        ck.save(saved, 3)
        m2, got, step = telastic.restart(
            ck, saved, plan, {"state": PS("parts"), "step": None},
            device="cpu")
        _, want, jstep = jelastic.restart(
            JCheckpointer(str(tmp_path / "ck")), saved,
            jelastic.MeshPlan((1,), ("parts",)),
            {"state": {"x": JP("parts"), "frontier": JP("parts")},
             "step": JP()})
        assert step == int(jstep) == 3 and m2.size() == 1
        for k in ("x", "frontier"):
            assert np.array_equal(got["state"][k].numpy(),
                                  np.asarray(want["state"][k]))
        assert int(got["step"]) == int(want["step"]) == 7
        for lm in ({"state": PS("data"), "step": None},
                   {"state": PS("parts", "model"), "step": PS()}):
            with pytest.raises(ValueError, match="outside the plan"):
                telastic.restart(ck, saved, plan, lm, device="cpu")
        lm = telastic.MeshPlan((1, 1), ("data", "model")).make(device="cpu")
        assert lm.mesh_dim_names == ("data", "model") and lm.size() == 1


def test_skew_report_and_tracker_match_jax(graph):
    """The report off a checkpointed run's telemetry, and a tracker fed
    runs (a repartition resets its shape), equal the JAX package's
    functions on the same numbers."""
    _, tpg, _ = graph
    with tempfile.TemporaryDirectory() as d:
        _, tele = GopherEngine(tpg, _prog("sssp", tpg, "torch"),
                               exchange="compact", device="cpu").run(
            checkpointer=Checkpointer(d), checkpoint_every=2)
    rep = tele.skew()
    assert rep == jskew.skew_report(tele)
    assert rep["time_straggler"] >= 0 and rep["wire"]["send_imbalance"] > 0
    assert tskew.skew_report() == jskew.skew_report()
    fake = type("T", (), {})()
    fake.local_iters = np.array([3.0, 1.0, 1.0])
    fake.pair_slots = None
    fake.part_seconds = None
    tt, jt = tskew.SkewTracker(decay=0.5), jskew.SkewTracker(decay=0.5)
    for t in (tele, tele, fake, tele):
        tt.observe(t)
        jt.observe(t)
        assert tt.report() == jt.report()
        assert tt.imbalance() == jt.imbalance()
        assert tt.time_imbalance() == jt.time_imbalance()
    for load in (None, [], [0, 0], [1, 2, 3.5]):
        assert tskew.imbalance_score(load) == jskew.imbalance_score(load)
    assert tskew.pair_skew(tele.pair_slots) == \
        jskew.pair_skew(tele.pair_slots)


def test_targeted_straggler_lands_in_part_seconds_exactly(graph):
    """A straggler on partition 2 stalls delay_s per live vertex of it
    each superstep; the checkpointed loop charges exactly the recorded
    stalls to partition 2 and spreads the rest evenly, so part_seconds[2]
    − part_seconds[p] is the stalls' sum for every other p (to the
    recorder's rounding), and the result is unchanged."""
    _, tpg, refs = graph
    plan = faults.FaultPlan(
        [faults.FaultSpec("engine.superstep", "straggler", prob=1.0,
                          times=9999, delay_s=1e-4, payload={"part": 2})])
    with tempfile.TemporaryDirectory() as d:
        with faults.inject(plan):
            state, tele = GopherEngine(
                tpg, _prog("cc", tpg, "torch"), exchange="compact",
                device="cpu").run(checkpointer=Checkpointer(d),
                                  checkpoint_every=1)
    _same_state(refs["cc"][0], state)
    fired = plan.record()
    assert len(fired) == tele.supersteps
    verts = int(np.asarray(tpg.vmask)[2].sum())
    assert all(r["stall_s"] == round(1e-4 * verts, 6) for r in fired)
    stalls = sum(r["stall_s"] for r in fired)
    ps = tele.part_seconds
    others = np.delete(ps, 2)
    assert np.allclose(ps[2] - others, stalls, rtol=0,
                       atol=5e-7 * len(fired) + 1e-12)
    assert np.all(others == others[0])
    assert tele.skew()["time_straggler"] == 2
