"""The multi-device backend's service and device-loss half against the
JAX package's ``shard_map`` runs.

The module fixture runs two worlds side by side, each in processes of its
own, over road_grid(14, 14) in 8 partitions:

  * the JAX side: one process under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` runs
    ``run_with_failover`` on the phased exchange from a 4-device mesh
    (CC, SSSP and 10-iteration PageRank losing device 1, CC losing
    device 0), a plain run on each returned engine, and one service
    stream on the 4-device mesh (queries, landmarks, a delta, ``warm``);
  * the port: a world of 7 gloo ranks. Each failover starts on a mesh of
    4 of them (``launch.mesh.sub_mesh``: [0,1,2,3], [0,2,3,4], [0,3,4,5],
    [0,4,5,6]), so that every world rank the fault takes out is a fresh
    one: the lost rank writes what it holds and leaves its process at
    once, the rank the divisor clamp leaves out goes on to its next mesh.
    The service runs on ranks [3,4,5,6]; ranks [0,1] restart a snapshot
    through ``MeshPlan((2,)).make``. Every rank writes its results.

Every process is held to a deadline, so a survivor that waited on a rank
that left fails the fixture instead of hanging the suite. A group's name
hashes its ranks and the number of groups each member has made, so every
rank of the world makes a group of its own where a group it is not in is
made. The programs are written to ``tmp_path`` and run there, so no child
imports this module (which imports JAX). Min/max results are bit-equal
with equal Telemetry and FailoverReport fields, PageRank and PPR allclose
at rtol 1e-5 (sums over ranks associate differently from XLA's), landmark
bounds within 1e-4 relative. A one-rank world in this process holds the
service and a crash failover on ``shard_map`` to 'local'.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 7
DEADLINE_S = 240
# the port's 4-rank mesh of each scenario, in the world of 7
MESHES = {"cc_l1": [0, 1, 2, 3], "sssp_l1": [0, 2, 3, 4],
          "pr_l1": [0, 3, 4, 5], "cc_l0": [0, 4, 5, 6]}
SERVICE_RANKS = [3, 4, 5, 6]

COMMON = r'''
import numpy as np
FIELDS = ("supersteps", "local_iters", "changed_hist", "messages_sent",
          "wire_hist", "wire_slots", "bytes_on_wire", "count_hist",
          "pair_slots", "pair_rounds", "pair_overflow", "spills",
          "escalations", "retried", "phase_hist", "phase_switch_steps",
          "phase_wire", "dense_retry_steps", "query_supersteps", "exchange")
REPORT = ("attempts", "restarts", "resumed_steps", "final_step",
          "lost_devices", "lost_partitions", "old_num_devices",
          "new_num_devices")
# (name, algorithm, the device indices lost at superstep 2)
SCENARIOS = (("cc_l1", "cc", [1]), ("sssp_l1", "sssp", [1]),
             ("pr_l1", "pagerank", [1]), ("cc_l0", "cc", [0]))
STREAM = [("sssp", 0), ("bfs", 37), ("reach", (5, 120)), ("ppr", 3),
          ("sssp", 150), ("ppr", 77), ("sssp", 0)]
out = {}


def keep(name, x, t):
    out[f"{name}/x"] = np.asarray(x)
    for f in FIELDS:
        v = getattr(t, f, None)
        if v is not None:
            out[f"{name}/{f}"] = np.asarray(v)


def spans(name, tracer):
    import collections
    c = collections.Counter((sp.name, sp.depth) for sp in tracer.spans)
    out[f"{name}/span_names"] = np.array([k[0] for k in sorted(c)])
    out[f"{name}/span_depths"] = np.array([k[1] for k in sorted(c)])
    out[f"{name}/span_counts"] = np.array([c[k] for k in sorted(c)])


def report(name, rep):
    for f in REPORT:
        v = getattr(rep, f)
        out[f"{name}/rep_{f}"] = np.asarray(-1 if v is None else v)


def graph(road_grid, bfs_grow_partition, partition_graph, Semiring,
          init_max_vertex, make_sssp_init, PageRankProgram):
    g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    return pg, {"cc": Semiring("max_first", init_max_vertex),
                "sssp": Semiring("min_plus", make_sssp_init(*loc)),
                "pagerank": PageRankProgram(n_global=pg.n_global,
                                            num_iters=10)}


def serve(svc, EdgeDelta):
    for kind, src in STREAM:
        svc.submit(kind, "g", src)
    for t, r in svc.drain().items():
        out[f"svc/q{t}"] = (np.full(1, np.nan) if r.result is None
                            else np.asarray(r.result))
        out[f"svc/q{t}_meta"] = np.asarray([r.supersteps, int(r.cached),
                                            int(r.error is None)])
    lc = svc.enable_landmarks("g", 4)
    out["svc/landmarks"] = np.asarray(lc.landmarks)
    out["svc/lm_dist0"] = np.asarray(lc.dist)
    svc.apply_delta("g", EdgeDelta.inserts([0, 7], [150, 33], [1.0, 2.0]),
                    rebuild_landmarks=True)
    lc = svc.landmark_caches["g"]
    out["svc/lm_dist1"] = np.asarray(lc.dist)
    out["svc/lm_meta"] = np.asarray([lc.graph_version,
                                     lc.refreshed_landmarks, lc.refreshes])
    out["svc/approx"] = np.asarray(svc.approx_sssp("g", 30))
    r = svc.query("sssp", "g", 150)
    out["svc/after"] = np.asarray(r.result)
    out["svc/after_meta"] = np.asarray([r.supersteps, int(r.cached)])
    out["svc/warm"] = np.asarray(svc.warm("g"))
    st = svc.stats()
    out["svc/stats"] = np.asarray([st[k] for k in (
        "served", "cache_hits", "batches", "engine_supersteps", "rejected",
        "query_retries", "degraded_batches")])
'''

JAX_SIDE = COMMON + r'''
import sys
from repro.core import (GopherEngine, PageRankProgram, PhasedTierPlan,
                        SemiringProgram, compat, host_graph_block,
                        init_max_vertex, make_sssp_init)
from repro.gofs import EdgeDelta, bfs_grow_partition, road_grid
from repro.gofs.formats import partition_graph
from repro.obs import MetricsRegistry, Tracer
from repro.resilience import faults, run_with_failover
from repro.serving.service import GraphQueryService
from repro.training.checkpoint import Checkpointer
out_path, ck_root = sys.argv[1], sys.argv[2]
pg, progs = graph(road_grid, bfs_grow_partition, partition_graph,
                  SemiringProgram, init_max_vertex, make_sssp_init,
                  PageRankProgram)
mesh = compat.make_mesh((4,), ("parts",))
for name, algo, lost in SCENARIOS:
    key = "r" if algo == "pagerank" else "x"
    hb = host_graph_block(pg)
    reg, tr = MetricsRegistry(), Tracer(enabled=False)
    eng = GopherEngine(pg, progs[algo], backend="shard_map", mesh=mesh,
                       exchange="phased",
                       tier_plan=PhasedTierPlan.from_block(hb), metrics=reg,
                       tracer=tr,
                       max_supersteps=64 if algo == "pagerank" else 4096)
    plan = faults.FaultPlan([faults.FaultSpec(
        "engine.superstep", "device_loss", at=2, payload={"lost": lost})],
        seed=7)
    with faults.inject(plan):
        eng2, s, t, rep = run_with_failover(
            eng, Checkpointer(f"{ck_root}/{name}"), every=1, host_gb=hb)
    keep(name, s[key], t)
    report(name, rep)
    out[f"{name}/events"] = np.asarray(reg.snapshot()["counters"][
        "failover_events_total{backend=shard_map}"])
    tr.enabled = True
    s, t = eng2.run()
    keep(f"{name}_next", s[key], t)
    spans(f"{name}_spans", tr)
serve(GraphQueryService({"g": pg}, backend="shard_map", mesh=mesh),
      EdgeDelta)
np.savez(out_path, **out)
'''

TORCH_SIDE = COMMON + r'''
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import (GopherEngine, PageRankProgram, PhasedTierPlan,
                              SemiringProgram, host_graph_block,
                              init_max_vertex, make_sssp_init)
from repro_torch.gofs import EdgeDelta, bfs_grow_partition, road_grid
from repro_torch.gofs.formats import partition_graph
from repro_torch.launch.elastic import MeshPlan, PartitionSpec, restart
from repro_torch.launch.mesh import mesh_ranks, sub_mesh
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.resilience import faults, run_with_failover
from repro_torch.resilience.failover import _shrunk_ranks
from repro_torch.serving import GraphQueryService
from repro_torch.training.checkpoint import Checkpointer
rank, world, rdv, out_dir, ck_root = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
MESHES = eval(sys.argv[6])
SERVICE_RANKS = eval(sys.argv[7])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
pg, progs = graph(road_grid, bfs_grow_partition, partition_graph,
                  SemiringProgram, init_max_vertex, make_sssp_init,
                  PageRankProgram)


def write():
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def in_step(members):
    """Keep every rank's count of groups in step with the members' (a
    group's name hashes its ranks and each member's count so far): a rank
    outside ``members`` makes a group of its own where they make theirs."""
    if rank not in members:
        dist.new_group([rank], use_local_synchronization=True)


# (1) the elastic restart: rank 0 snapshots 8 rows, the world's one
# barrier, then MeshPlan((2,)) over ranks [0, 1] re-shards it
rng = np.random.default_rng(0)
saved = {"state": {"x": rng.random((8, 5), np.float32),
                   "frontier": rng.random((8, 5)) < 0.5},
         "step": np.asarray(7, np.int32)}
ck = Checkpointer(f"{ck_root}/elastic")
if rank == 0:
    ck.save(saved, 3)
dist.barrier()
try:
    restart(ck, saved, MeshPlan((2,), ("parts",)),
            {"state": PartitionSpec("model"), "step": None}, device="cpu")
    out["elastic/refuse_lm"] = np.asarray(False)
except NotImplementedError as e:
    out["elastic/refuse_lm"] = np.asarray("A8.3" in str(e))
m, st, step = restart(ck, saved, MeshPlan((2,), ("parts",)),
                      {"state": PartitionSpec("parts"), "step": None},
                      device="cpu")
in_step([0, 1])
out["elastic/member"] = np.asarray(m is not None)
if m is not None:
    out["elastic/x"] = st["state"]["x"].numpy()
    out["elastic/frontier"] = st["state"]["frontier"].numpy()
    out["elastic/step"] = np.asarray([step, int(st["step"])])
    out["elastic/ranks"] = np.asarray(mesh_ranks(m))
# (2) the service on 4 ranks of the world
smesh = sub_mesh(SERVICE_RANKS, ("parts",), device="cpu")
in_step(SERVICE_RANKS)
if smesh is not None:
    svc = GraphQueryService({"g": pg}, backend="shard_map", mesh=smesh,
                            device="cpu")
    serve(svc, EdgeDelta)
    out["svc/exchange"] = np.asarray(svc._exchange_mode())
# (3) the failovers, each from a mesh of 4 ranks of its own
for name, algo, lost in SCENARIOS:
    mesh = sub_mesh(MESHES[name], ("parts",), device="cpu")
    in_step(MESHES[name])
    survivors = _shrunk_ranks(MESHES[name], lost, pg.num_parts)
    if mesh is None:
        in_step(survivors)
        continue
    key = "r" if algo == "pagerank" else "x"
    hb = host_graph_block(pg)
    reg, tr = MetricsRegistry(), Tracer(enabled=False)
    eng = GopherEngine(pg, progs[algo], backend="shard_map", mesh=mesh,
                       exchange="phased",
                       tier_plan=PhasedTierPlan.from_block(hb), metrics=reg,
                       tracer=tr,
                       max_supersteps=64 if algo == "pagerank" else 4096,
                       device="cpu")
    plan = faults.FaultPlan([faults.FaultSpec(
        "engine.superstep", "device_loss", at=2, payload={"lost": lost})],
        seed=7)
    with faults.inject(plan):
        eng2, s, t, rep = run_with_failover(
            eng, Checkpointer(f"{ck_root}/{name}"), every=1, host_gb=hb)
    report(name, rep)
    if eng2 is None:
        out[f"{name}/left"] = np.asarray(True)
        if rank in [MESHES[name][i] for i in lost]:
            write()               # the lost rank leaves at once
            sys.stdout.flush()
            os._exit(0)
        in_step(survivors)        # left out by the clamp: the next mesh
        continue
    keep(name, s[key], t)
    out[f"{name}/events"] = np.asarray(reg.snapshot()["counters"].get(
        "failover_events_total{backend=shard_map}", 0))
    out[f"{name}/ranks"] = np.asarray(mesh_ranks(eng2.mesh))
    tr.enabled = True
    s, t = eng2.run()
    keep(f"{name}_next", s[key], t)
    spans(f"{name}_spans", tr)
write()
dist.destroy_process_group()
'''


def _spawn(args, env, tmp, name):
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    return subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=tmp), log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run both worlds at once under one deadline; return the JAX
    side's results, each port rank's, and the seconds it all took."""
    tmp = str(tmp_path_factory.mktemp("failover"))
    for name, text in (("jax_side.py", JAX_SIDE),
                       ("torch_side.py", TORCH_SIDE)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4").strip())
    t0 = time.perf_counter()
    procs = [_spawn(["jax_side.py", os.path.join(tmp, "jax.npz"),
                     os.path.join(tmp, "jax_ck")], jenv, tmp, "jax")]
    procs += [_spawn(["torch_side.py", str(r), str(WORLD),
                      os.path.join(tmp, "rdv"), tmp,
                      os.path.join(tmp, "torch_ck"), repr(MESHES),
                      repr(SERVICE_RANKS)], env, tmp, f"rank{r}")
              for r in range(WORLD)]
    # every process under one deadline; the first failure ends them all
    # (its peers may wait on it for ever)
    deadline = time.monotonic() + DEADLINE_S
    while True:
        rcs = [p.poll() for p, _ in procs]
        if None not in rcs or any(rcs) or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for p, log in procs:
        p.kill()
        p.wait()
        log.close()
    seconds = time.perf_counter() - t0
    if any(rc != 0 for rc in rcs):
        names = ["jax"] + [f"rank{r}" for r in range(WORLD)]
        logs = {n: open(os.path.join(tmp, f"{n}.log")).read()[-2500:]
                for n in names}
        pytest.fail(f"exit codes {rcs}: {logs}")
    return {"jax": dict(np.load(os.path.join(tmp, "jax.npz"))),
            "ranks": [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                      for r in range(WORLD)],
            "seconds": seconds}


def _fields(res: dict, case: str) -> dict:
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _same(case, got: dict, want: dict, skip=()) -> None:
    assert set(got) == set(want), (case, set(got) ^ set(want))
    for f, w in want.items():
        if f not in skip:
            assert np.array_equal(got[f], w), (case, f, got[f], w)


def _survivors(name):
    lost_index = 1 if name.endswith("_l1") else 0
    members = MESHES[name]
    alive = [r for i, r in enumerate(members) if i != lost_index]
    return alive[:2], [r for r in members if r not in alive[:2]]


def _runs(worlds, name, suffix=""):
    """Each surviving rank's fields of ``name``'s failover run (or, with
    ``suffix='_next'``, of the plain run on the returned engine) beside
    the JAX side's."""
    want = _fields(worlds["jax"], name + suffix)
    keep, _ = _survivors(name)
    got = [{k: v for k, v in _fields(worlds["ranks"][r], name + suffix)
            .items() if not k.startswith(("rep_", "events", "ranks",
                                          "left"))} for r in keep]
    want = {k: v for k, v in want.items()
            if not k.startswith(("rep_", "events"))}
    return got, want


def _report(res, name):
    return {k: res[f"{name}/rep_{k}"].tolist() for k in (
        "attempts", "restarts", "resumed_steps", "final_step",
        "lost_devices", "lost_partitions", "old_num_devices",
        "new_num_devices")}


def test_failover_losing_rank_1_matches_jax(worlds):
    """CC and SSSP losing device 1 of 4 on the phased exchange: on each
    survivor (world ranks of the shrunk 2-rank mesh) the state bit-equal
    to the JAX package's run with every Telemetry field equal; the
    report's mesh change 4 -> 2 devices with partitions [2, 3] lost, one
    restart from step 2, and its final step, equal to JAX's."""
    for name in ("cc_l1", "sssp_l1"):
        got, want = _runs(worlds, name)
        for g in got:
            _same(name, g, want)
        rep = _report(worlds["jax"], name)
        assert (rep["old_num_devices"], rep["new_num_devices"],
                rep["lost_partitions"], rep["lost_devices"]) == (
                    4, 2, [2, 3], [1])
        assert rep["restarts"] == 1 and rep["resumed_steps"] == [2]
        for r in _survivors(name)[0]:
            assert _report(worlds["ranks"][r], name) == rep, (name, r)


def test_failover_pagerank_matches_jax(worlds):
    """10-iteration PageRank losing device 1: ranks allclose at rtol 1e-5
    on each survivor, the integer Telemetry and the report equal."""
    got, want = _runs(worlds, "pr_l1")
    for g in got:
        np.testing.assert_allclose(g["x"], want["x"], rtol=1e-5, atol=0)
        _same("pr_l1", g, want, skip=("x",))
    for r in _survivors("pr_l1")[0]:
        assert _report(worlds["ranks"][r], "pr_l1") == _report(
            worlds["jax"], "pr_l1")


def test_failover_losing_rank_0_matches_jax(worlds):
    """CC losing device 0, the rank that wrote the snapshots and is rank
    0 of the old group: the survivors (group ranks 0 and 1 of a group of
    world ranks 4 and 5) resume from step 2 and end bit-equal to JAX, so
    no route, save or restore assumes world rank 0."""
    got, want = _runs(worlds, "cc_l0")
    assert len(got) == 2
    for g in got:
        _same("cc_l0", g, want)
    rep = _report(worlds["jax"], "cc_l0")
    assert rep["lost_partitions"] == [0, 1] and rep["new_num_devices"] == 2
    for r in (4, 5):
        assert _report(worlds["ranks"][r], "cc_l0") == rep
        assert list(worlds["ranks"][r]["cc_l0/ranks"]) == [4, 5]


def test_returned_engine_runs_on_like_jax(worlds):
    """A plain run on the engine ``run_with_failover`` returned (the
    survivors' 2-rank mesh, the rebuilt plan) equals the JAX package's
    plain run on its returned engine, for every scenario."""
    for name in MESHES:
        got, want = _runs(worlds, name, "_next")
        for g in got:
            if name == "pr_l1":
                np.testing.assert_allclose(g["x"], want["x"], rtol=1e-5,
                                           atol=0)
                _same(name, g, want, skip=("x",))
            else:
                _same(name, g, want)


def test_lost_and_clamped_ranks_take_no_part(worlds):
    """The lost rank and the survivor the divisor clamp leaves out get no
    engine back and carry the same mesh-change record (one attempt, no
    ``final_step``: they took no part in the resumed run); the lost rank left its process straight after the fault (it
    wrote nothing later), the clamped-out rank went on to its next mesh.
    Every process finished inside the deadline, so no survivor waited on
    a rank that had left."""
    ranks = worlds["ranks"]
    for name in MESHES:
        keep, out = _survivors(name)
        rep = _report(worlds["jax"], name)
        for r in out:
            assert ranks[r][f"{name}/left"]
            mine = _report(ranks[r], name)
            assert (mine["final_step"], mine["attempts"]) == (-1, 1)
            ran = ("final_step", "attempts")
            assert {k: v for k, v in mine.items() if k not in ran} \
                == {k: v for k, v in rep.items() if k not in ran}
            assert f"{name}/x" not in ranks[r]
        for r in keep:
            assert list(ranks[r][f"{name}/ranks"]) == keep
    # each lost rank wrote its file as it left: rank 0, lost last, holds
    # the three runs it survived before
    for name, lost in (("cc_l1", 1), ("sssp_l1", 2), ("pr_l1", 3),
                       ("cc_l0", 0)):
        assert ranks[lost][f"{name}/left"] and f"{name}/x" not in ranks[lost]
    assert all(f"{n}/x" in ranks[0] for n in ("cc_l1", "sssp_l1", "pr_l1"))
    assert worlds["seconds"] < DEADLINE_S


def test_failover_feeds_the_callers_registry_and_tracer(worlds):
    """``failover_events_total{backend=shard_map}`` is 1 in the registry
    the caller gave the engine, on every survivor, as in the JAX run; the
    rebuilt engine keeps the caller's tracer, and its traced run records
    the JAX package's (name, depth) span counts there, a ``superstep``
    span a superstep."""
    for name in MESHES:
        assert int(worlds["jax"][f"{name}/events"]) == 1
        want = _fields(worlds["jax"], f"{name}_spans")
        steps = int(worlds["jax"][f"{name}_next/supersteps"])
        for r in _survivors(name)[0]:
            res = worlds["ranks"][r]
            assert int(res[f"{name}/events"]) == 1
            got = _fields(res, f"{name}_spans")
            _same(name, got, want)
            tree = dict(zip(zip(got["span_names"].tolist(),
                                got["span_depths"].tolist()),
                            got["span_counts"].tolist()))
            assert tree[("superstep", 2)] == steps


def test_service_on_four_ranks_matches_jax(worlds):
    """The service on a 4-rank mesh (phased) against the JAX service on a
    4-device mesh, on every rank: each answer bit-equal (PPR rtol 1e-5)
    with its supersteps, cached flag and error; the landmarks and their
    distances before and after a delta, the refresh's counts and the
    post-delta answer equal; ``approx_sssp`` within 1e-4 relative;
    ``warm`` runs 2 batches (the traversal engine on its plan and on the
    narrow-resume plan) and the stats agree."""
    j = _fields(worlds["jax"], "svc")
    ppr = {f"q{t}" for t, (kind, _) in enumerate(
        [("sssp", 0), ("bfs", 37), ("reach", (5, 120)), ("ppr", 3),
         ("sssp", 150), ("ppr", 77), ("sssp", 0)]) if kind == "ppr"}
    for r in SERVICE_RANKS:
        t = _fields(worlds["ranks"][r], "svc")
        assert str(t.pop("exchange")) == "phased"
        assert set(t) == set(j)
        for k, w in j.items():
            if k in ppr:
                np.testing.assert_allclose(t[k], w, rtol=1e-5, atol=0)
            elif k == "approx":
                np.testing.assert_allclose(t[k], w, rtol=1e-4, atol=0)
            else:
                assert np.array_equal(t[k], w), (r, k, t[k], w)
    assert int(j["warm"]) == 2


def test_elastic_restart_on_two_ranks(worlds):
    """``MeshPlan((2,), ('parts',))`` builds a mesh over world ranks 0 and
    1 and ``restart`` gives each its 4 rows of the snapshot (and the
    replicated step whole); the other ranks get no mesh; a pspec naming
    'model' raises naming A8.3."""
    ranks = worlds["ranks"]
    full = ranks[0]["elastic/x"], ranks[1]["elastic/x"]
    rng = np.random.default_rng(0)
    x = rng.random((8, 5), np.float32)
    frontier = rng.random((8, 5)) < 0.5
    for r in (0, 1):
        res = ranks[r]
        assert list(res["elastic/ranks"]) == [0, 1]
        assert np.array_equal(res["elastic/x"], x[4 * r:4 * r + 4])
        assert np.array_equal(res["elastic/frontier"],
                              frontier[4 * r:4 * r + 4])
        assert list(res["elastic/step"]) == [3, 7]
    assert np.array_equal(np.concatenate(full), x)
    for r in range(WORLD):
        assert bool(ranks[r]["elastic/member"]) == (r < 2)
        assert ranks[r]["elastic/refuse_lm"]


def test_one_rank_world_equals_local(tmp_path):
    """A world of one gloo rank in this process (what the card runs, with
    one NCCL rank): the service on ``shard_map`` answers a stream, builds
    and refreshes landmarks after a delta and warms as the 'local' service
    does; a crash failover on the mesh ends bit-equal to 'local' with the
    same report; losing the only device raises."""
    from _mesh_world import one_rank_world

    from repro_torch.core import (GopherEngine, SemiringProgram,
                                  init_max_vertex)
    from repro_torch.gofs import (EdgeDelta, bfs_grow_partition,
                                  partition_graph, road_grid)
    from repro_torch.resilience import faults, run_with_failover
    from repro_torch.serving import GraphQueryService
    from repro_torch.training.checkpoint import Checkpointer
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
    delta = EdgeDelta.inserts([0, 7], [150, 33], [1.0, 2.0])
    stream = [("sssp", 0), ("bfs", 37), ("reach", (5, 120)), ("ppr", 3)]
    cc = SemiringProgram("max_first", init_max_vertex)

    def drive(svc):
        for kind, src in stream:
            svc.submit(kind, "g", src)
        res = svc.drain()
        svc.enable_landmarks("g", 4)
        svc.apply_delta("g", delta, rebuild_landmarks=True)
        return (res, svc.landmark_caches["g"].dist, svc.warm("g"),
                svc.query("sssp", "g", 150))

    def fail_over(**kw):
        eng = GopherEngine(pg, cc, exchange="compact", device="cpu", **kw)
        plan = faults.FaultPlan([faults.FaultSpec("engine.superstep",
                                                  "crash", at=2)])
        with tempfile.TemporaryDirectory() as d:
            with faults.inject(plan):
                return run_with_failover(eng, Checkpointer(d), every=1)

    try:
        want = drive(GraphQueryService({"g": pg}, device="cpu"))
        _, ls, lt, lrep = fail_over()
        with one_rank_world(tmp_path) as mesh:
            got = drive(GraphQueryService({"g": pg}, backend="shard_map",
                                          mesh=mesh, device="cpu"))
            eng, ms, mt, mrep = fail_over(backend="shard_map", mesh=mesh)
            assert eng.mesh is mesh
            loss = faults.FaultPlan([faults.FaultSpec(
                "engine.superstep", "device_loss", at=1,
                payload={"lost": [0]})])
            with tempfile.TemporaryDirectory() as d:
                with faults.inject(loss), pytest.raises(
                        ValueError, match="every device"):
                    run_with_failover(GopherEngine(
                        pg, cc, backend="shard_map", mesh=mesh,
                        exchange="compact", device="cpu"),
                        Checkpointer(d), every=1)
    finally:
        torch.set_num_threads(before)
    for t, w in want[0].items():
        r = got[0][t]
        assert (r.error, r.cached, r.supersteps) == (w.error, w.cached,
                                                     w.supersteps)
        np.testing.assert_allclose(r.result, w.result, rtol=1e-5, atol=0)
        if w.query.kind != "ppr":
            assert np.array_equal(r.result, w.result)
    assert np.array_equal(got[1], want[1]) and got[2] == want[2] == 1
    assert np.array_equal(got[3].result, want[3].result)
    assert np.array_equal(ms["x"], ls["x"]) and mt.supersteps == lt.supersteps
    assert mrep == lrep and mrep.resumed_steps == [2]


def test_rank_launcher_holds_every_rank_to_its_deadline():
    """``launch.mesh.launch_ranks`` (the scope and chaos CLIs' ``--devices
    N``): ranks that wait on a rank that never comes (a world of 3 with 2
    started) are killed at the deadline and it raises ``TimeoutError``;
    ranks that fail make it raise at once with their exit codes."""
    from repro_torch.launch.mesh import launch_ranks
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        launch_ranks("repro_torch.launch.scope",
                     ["--backend", "shard_map", "--devices", "3",
                      "--device", "cpu"], 2, "cpu", timeout=3)
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match="exited with"):
        launch_ranks("repro_torch.launch.scope", ["--no-such-flag"], 2,
                     "cpu", timeout=60)
    assert time.perf_counter() - t0 < 60
