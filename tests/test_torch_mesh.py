"""The port's multi-device backend (``backend='shard_map'`` over
``torch.distributed``) against the JAX package's ``shard_map`` backend.

One module fixture runs three worlds side by side, each in processes of
its own, over road_grid(14, 14) in 8 partitions:

  * the JAX side: one process under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` runs the
    matrix on a 4-device mesh;
  * the port: 4 gloo ranks (rendezvous through a file, one thread each)
    run the same matrix on a 4-rank mesh, and check the mesh routes alone
    and the refusals; rank 0 writes the results;
  * a 1-rank gloo world runs every exchange on ``shard_map`` beside
    ``local``.

The programs are written to ``tmp_path`` and run there, so no child
process imports this module (which imports JAX). The min/max semirings
are held bit-equal with equal Telemetry; PageRank allclose at rtol 1e-5
(a sum over ranks associates differently from XLA's ``psum``) with equal
supersteps.
"""
import collections
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4
TOL = 1e-4                      # the tol PageRank's threshold

# the matrix both packages run (the names index the .npz files)
COMMON = r'''
import collections, dataclasses, sys
import numpy as np
FIELDS = ("supersteps", "local_iters", "changed_hist", "messages_sent",
          "wire_hist", "wire_slots", "bytes_on_wire", "count_hist",
          "pair_slots", "pair_rounds", "pair_overflow", "spills",
          "escalations", "retried", "phase_hist", "phase_switch_steps",
          "phase_wire", "dense_retry_steps", "query_supersteps", "exchange")
out = {}


def keep(name, x, t):
    out[f"{name}/x"] = np.asarray(x)
    for f in FIELDS:
        v = getattr(t, f, None)
        if v is not None:
            out[f"{name}/{f}"] = np.asarray(v)


def matrix(P, pg, progs, run, tiers, TierPlan, PhasedTierPlan,
           connected_components, pagerank, PageRankProgram, Batched,
           sssp_query_init, faults, run_with_recovery, Checkpointer, Tracer,
           ck_dir, tol):
    for a, prog in progs.items():
        for ex in ("dense", "compact", "tiered", "phased", "auto"):
            plan = PhasedTierPlan.from_graph(pg) if ex == "phased" else None
            s, t = run(prog, exchange=ex, tier_plan=plan).run()
            keep(f"{a}_{ex}", s["x"], t)
    base = TierPlan.from_graph(pg)
    cold = np.where(base.tiers == tiers.EXCLUDED, tiers.EXCLUDED,
                    tiers.COLD).astype(np.int8).tobytes()
    s, t = run(progs["cc"], exchange="tiered",
               tier_plan=dataclasses.replace(base, tier_bytes=cold)).run()
    keep("cc_spill", s["x"], t)
    lab, _, t = connected_components(pg, mode="vertex", **P)
    keep("cc_vertex", lab, t)
    pr = PageRankProgram(n_global=pg.n_global, num_iters=10)
    for ex in ("dense", "phased"):
        s, t = run(pr, exchange=ex, max_supersteps=64).run()
        keep(f"pr_{ex}", s["r"], t)
    r, t = pagerank(pg, num_iters=200, tol=tol, **P)
    keep("pr_tol", r, t)
    qinit = sssp_query_init(pg, [0, 50, 120])
    for ex in ("compact", "tiered"):
        s, t = run(Batched(semiring="min_plus", num_queries=3),
                   exchange=ex).run_queries(extra={"qinit": qinit})
        keep(f"q_{ex}", s["x"], t)
    eng = run(progs["cc"], exchange="compact")
    plan = faults.FaultPlan([faults.FaultSpec("engine.superstep", "crash",
                                              at=2)])
    with faults.inject(plan):
        s, t, rep = run_with_recovery(eng, Checkpointer(ck_dir), every=2)
    keep("ck", s["x"], t)
    out["ck/restarts"] = np.asarray(rep.restarts)
    out["ck/resumed"] = np.asarray(rep.resumed_steps)
    tr = Tracer(enabled=True)
    s, t = run(progs["sssp"], exchange="phased",
               tier_plan=PhasedTierPlan.from_graph(pg), tracer=tr).run()
    keep("traced", s["x"], t)
    c = collections.Counter((sp.name, sp.depth) for sp in tr.spans)
    out["traced/span_names"] = np.array([k[0] for k in c])
    out["traced/span_depths"] = np.array([k[1] for k in c])
    out["traced/span_counts"] = np.array(list(c.values()))
'''

JAX_SIDE = COMMON + r'''
from repro.algorithms import connected_components, pagerank
from repro.core import (GopherEngine, PageRankProgram, PhasedTierPlan,
                        SemiringProgram, TierPlan, compat, init_max_vertex,
                        make_sssp_init, tiers)
from repro.gofs import bfs_grow_partition, road_grid
from repro.gofs.formats import partition_graph
from repro.obs import Tracer
from repro.resilience import faults, run_with_recovery
from repro.serving import BatchedSemiringProgram, sssp_query_init
from repro.training.checkpoint import Checkpointer
out_path, ck_dir, tol = sys.argv[1], sys.argv[2], float(sys.argv[3])
g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
pg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
P = {"backend": "shard_map", "mesh": compat.make_mesh((4,), ("parts",))}
progs = {"cc": SemiringProgram(semiring="max_first", init_fn=init_max_vertex),
         "sssp": SemiringProgram(semiring="min_plus", init_fn=make_sssp_init(
             int(pg.part_of[0]), int(pg.local_of[0])))}
matrix(P, pg, progs, lambda prog, **kw: GopherEngine(pg, prog, **P, **kw),
       tiers, TierPlan, PhasedTierPlan, connected_components, pagerank,
       PageRankProgram, BatchedSemiringProgram, sssp_query_init, faults,
       run_with_recovery, Checkpointer, Tracer, ck_dir, tol)
np.savez(out_path, **out)
'''

TORCH_SIDE = COMMON + r'''
import hashlib
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.algorithms import connected_components, pagerank
from repro_torch.core import (GopherEngine, PageRankProgram, PhasedTierPlan,
                              SemiringProgram, TierPlan, init_max_vertex,
                              make_sssp_init, tiers)
from repro_torch.core import messages as msg
from repro_torch.core.blocks import host_graph_block
from repro_torch.gofs import bfs_grow_partition, road_grid
from repro_torch.gofs.formats import partition_graph
from repro_torch.kernels.ref import outbox_pack_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import Tracer
from repro_torch.resilience import faults, run_with_recovery
from repro_torch.serving import (BatchedSemiringProgram, GraphQueryService,
                                 sssp_query_init)
from repro_torch.training.checkpoint import Checkpointer
rank, world, rdv, out_path, ck_dir, tol = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], float(sys.argv[6]))
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
mesh = make_mesh((world,), ("parts",), device="cpu")
g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
pg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
P = {"backend": "shard_map", "mesh": mesh, "device": "cpu"}
progs = {"cc": SemiringProgram("max_first", init_max_vertex),
         "sssp": SemiringProgram("min_plus", make_sssp_init(
             int(pg.part_of[0]), int(pg.local_of[0])))}


def run(prog, **kw):
    return GopherEngine(pg, prog, **P, **kw)


def refused(fn, err, text):
    try:
        fn()
    except err as e:
        return text in str(e)
    return False


if world > 1:
    matrix(P, pg, progs, run, tiers, TierPlan, PhasedTierPlan,
           connected_components, pagerank, PageRankProgram,
           BatchedSemiringProgram, sssp_query_init, faults,
           run_with_recovery, Checkpointer, Tracer, ck_dir, tol)
    # every rank returned the same state and Telemetry
    digest = hashlib.sha1(b"".join(np.ascontiguousarray(v).tobytes()
                                   for k, v in sorted(out.items()))).digest()
    digests = [None] * world
    dist.all_gather_object(digests, digest)
    out["ranks_agree"] = np.asarray(len(set(digests)) == 1)
    # the routes alone: this rank's received slots are route_local's
    # delivery of the whole outbox, sliced to the rank
    Pn, cap, v = pg.num_parts, pg.mailbox_cap, pg.num_parts // world
    rows = slice(rank * v, (rank + 1) * v)
    rng = np.random.default_rng(5)
    occ = host_graph_block(pg)["ob_inv"].reshape(Pn, Pn, cap) != -1
    act = (rng.random((Pn, Pn, cap)) < 0.4) & occ
    vals = np.where(act, rng.uniform(-5, 5, act.shape), np.inf)
    vals = torch.from_numpy(vals.astype(np.float32))
    want = msg.route_local(vals)[rows]
    ok = torch.equal(msg.route_shard_map(vals[rows].contiguous(),
                                         mesh.get_group()), want)
    qv = vals[..., None].expand(-1, -1, -1, 3) + torch.arange(3.0)
    ok &= torch.equal(msg.route_shard_map(qv[rows].contiguous(),
                                          mesh.get_group()),
                      msg.route_local(qv)[rows])
    plan = TierPlan.from_graph(pg)
    lim = torch.from_numpy(plan.limits()[rows].reshape(-1))
    R = v * Pn
    pv, sids, _, _, over = outbox_pack_ref(
        vals[rows].reshape(R, cap),
        torch.from_numpy(act[rows].reshape(R, cap)), lim, float("inf"))
    got = msg.route_tiered(vals[rows], pv.reshape(v, Pn, cap),
                           sids.reshape(v, Pn, cap), plan.schedule(world),
                           "min", group=mesh.get_group())
    ok &= not bool(over.any()) and torch.equal(got, want)
    flags = torch.tensor([int(not ok)])
    dist.all_reduce(flags)
    out["routes_ok"] = np.asarray(int(flags) == 0)
    # the refusals
    g6 = road_grid(6, 6, seed=2)
    pg6 = partition_graph(g6, bfs_grow_partition(g6, 6, seed=0), 6)
    out["refuse_tiling"] = np.asarray(refused(lambda: GopherEngine(
        pg6, progs["cc"], **P), ValueError, "do not tile"))
    out["refuse_megastep"] = np.asarray(refused(lambda: run(
        progs["cc"], exchange="megastep"), ValueError, "local-backend"))
    out["refuse_service"] = np.asarray(refused(lambda: GraphQueryService(
        {"g": pg}, **P), NotImplementedError, "A8.2"))
else:
    # one rank: every exchange bit-equal to 'local', 'auto' is 'dense'
    for a, prog in progs.items():
        for ex in ("dense", "compact", "tiered", "phased", "auto"):
            plan = PhasedTierPlan.from_graph(pg) if ex == "phased" else None
            lx = "dense" if ex == "auto" else ex
            sl, tl = GopherEngine(pg, prog, exchange=lx, tier_plan=plan,
                                  device="cpu").run()
            sm, tm = run(prog, exchange=ex, tier_plan=plan).run()
            keep(f"{a}_{ex}_local", sl["x"], tl)
            keep(f"{a}_{ex}_mesh", sm["x"], tm)
    pr = PageRankProgram(n_global=pg.n_global, num_iters=10)
    sl, tl = GopherEngine(pg, pr, exchange="dense", max_supersteps=64,
                          device="cpu").run()
    sm, tm = run(pr, exchange="dense", max_supersteps=64).run()
    keep("pr_local", sl["r"], tl)
    keep("pr_mesh", sm["r"], tm)
if rank == 0:
    np.savez(out_path, **out)
dist.destroy_process_group()
'''


def _spawn(args, env, tmp, name):
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    return subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=tmp), log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the three worlds at once; return their .npz results and the
    port's snapshot directory."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    for name, text in (("jax_side.py", JAX_SIDE),
                       ("torch_side.py", TORCH_SIDE)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={D}").strip())
    path = {k: os.path.join(tmp, k) for k in (
        "jax.npz", "torch.npz", "one.npz", "jax_ck", "torch_ck", "one_ck")}
    t0 = time.perf_counter()
    procs = [_spawn(["jax_side.py", path["jax.npz"], path["jax_ck"],
                     str(TOL)], jenv, tmp, "jax")]
    procs += [_spawn(["torch_side.py", str(r), str(D),
                      os.path.join(tmp, "rdv4"), path["torch.npz"],
                      path["torch_ck"], str(TOL)], env, tmp, f"rank{r}")
              for r in range(D)]
    procs.append(_spawn(["torch_side.py", "0", "1",
                         os.path.join(tmp, "rdv1"), path["one.npz"],
                         path["one_ck"], str(TOL)], env, tmp, "one"))
    rcs = []
    for p, log in procs:
        try:
            rcs.append(p.wait(timeout=600))
        finally:
            p.kill()
            log.close()
    if any(rcs):
        logs = {n: open(os.path.join(tmp, f"{n}.log")).read()[-3000:]
                for n in ["jax", "one"] + [f"rank{r}" for r in range(D)]}
        pytest.fail(f"exit codes {rcs}: {logs}")
    res = {k: dict(np.load(path[f"{k}.npz"])) for k in ("jax", "torch",
                                                        "one")}
    res["torch_ck"] = path["torch_ck"]
    res["seconds"] = time.perf_counter() - t0
    return res


def _fields(res: dict, case: str) -> dict:
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _same(case: str, got: dict, want: dict, skip=()) -> None:
    """Every field of ``want`` equal in ``got`` (bit for bit)."""
    assert set(got) == set(want), (case, set(got) ^ set(want))
    for f, w in want.items():
        if f not in skip:
            assert np.array_equal(got[f], w), (case, f, got[f], w)


def test_min_max_exchanges_match_jax(worlds):
    """CC and SSSP on dense, compact, tiered (the structural plan), phased
    (``PhasedTierPlan.from_graph``) and auto (tiered at D = 4): the state
    bit-equal to the JAX package's 4-device run, and every Telemetry field
    equal; every rank returned the same."""
    t, j = worlds["torch"], worlds["jax"]
    assert t["ranks_agree"]
    for a in ("cc", "sssp"):
        for ex in ("dense", "compact", "tiered", "phased", "auto"):
            case = f"{a}_{ex}"
            _same(case, _fields(t, case), _fields(j, case))
        assert str(t[f"{a}_auto/exchange"]) == "tiered"


def test_spill_and_vertex_mode_match_jax(worlds):
    """A too-narrow plan (every pair cold) spills, reruns dense and
    escalates, bit-equal with the JAX run's Telemetry; vertex-mode CC
    through ``connected_components(backend='shard_map')`` likewise."""
    t, j = worlds["torch"], worlds["jax"]
    spill = _fields(t, "cc_spill")
    assert spill["retried"] and spill["spills"] > 0 and spill["escalations"]
    assert np.array_equal(spill["x"], t["cc_dense/x"])
    for case in ("cc_spill", "cc_vertex"):
        _same(case, _fields(t, case), _fields(j, case))
    assert t["cc_vertex/supersteps"] > t["cc_dense/supersteps"]


def test_pagerank_matches_jax(worlds):
    """10-iteration PageRank on dense and phased, and ``pagerank(tol=)``
    (auto: tiered): ranks allclose at rtol 1e-5, supersteps and the
    integer Telemetry equal."""
    t, j = worlds["torch"], worlds["jax"]
    for case in ("pr_dense", "pr_phased", "pr_tol"):
        got, want = _fields(t, case), _fields(j, case)
        np.testing.assert_allclose(got["x"], want["x"], rtol=1e-5, atol=0)
        _same(case, got, want, skip=("x",))
    assert 10 < t["pr_tol/supersteps"] < 200


def test_run_queries_matches_jax(worlds):
    """An SSSP batch of 3 through ``run_queries`` on compact and tiered:
    (P, v_max, Q) distances bit-equal, ``query_supersteps`` and the rest
    of the Telemetry equal."""
    t, j = worlds["torch"], worlds["jax"]
    for case in ("q_compact", "q_tiered"):
        got = _fields(t, case)
        assert got["x"].shape[-1] == 3 and "query_supersteps" in got
        _same(case, got, _fields(j, case))


def test_routes_alone_deliver_route_local(worlds):
    """``route_shard_map`` (slot values and a query batch's Q-vectors) and
    ``route_tiered`` over 4 gloo ranks (a structural plan: no overflow)
    give each rank exactly ``route_local``'s delivery of the whole outbox,
    sliced to its rows."""
    assert worlds["torch"]["routes_ok"]


def test_recovered_run_and_its_snapshot(worlds):
    """A checkpointed compact CC crashed at superstep 2 and recovered by
    ``run_with_recovery`` (one restart, from step 2) is bit-equal to the
    JAX run with its Telemetry; its newest snapshot, written by rank 0,
    restores in the JAX package's ``Checkpointer`` as the full (P, ...)
    arrays and equals the port's own restore."""
    from repro.training.checkpoint import Checkpointer as JCheckpointer

    from repro_torch.training.checkpoint import Checkpointer
    t, j = worlds["torch"], worlds["jax"]
    _same("ck", _fields(t, "ck"), _fields(j, "ck"))
    assert int(t["ck/restarts"]) == 1 and list(t["ck/resumed"]) == [2]
    ck = Checkpointer(worlds["torch_ck"])
    step = ck.latest_good_step()
    like = {"state": {k: np.zeros_like(t["ck/x"], dtype=dt) for k, dt in
                      (("x", np.float32), ("changed_v", bool),
                       ("frontier", bool))},
            "inbox": np.zeros_like(t["ck/x"], dtype=np.float32)}
    mine, _ = ck.restore(like, step=step, device="cpu")
    theirs, jstep = JCheckpointer(worlds["torch_ck"]).restore(like,
                                                              step=step)
    assert int(jstep) == step == int(t["ck/supersteps"])
    assert np.array_equal(np.asarray(theirs["state"]["x"]), t["ck/x"])
    for a, b in ((mine["inbox"], theirs["inbox"]),
                 *((mine["state"][k], theirs["state"][k])
                   for k in like["state"])):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_traced_span_tree_matches_jax(worlds):
    """A traced phased SSSP on the mesh: rank 0's (name, depth) span
    counts are the JAX traced ``shard_map`` run's, and its results and
    Telemetry the untraced run's."""
    t, j = worlds["torch"], worlds["jax"]

    def tree(r):
        return collections.Counter({
            (str(n), int(d)): int(c) for n, d, c in zip(
                r["traced/span_names"], r["traced/span_depths"],
                r["traced/span_counts"])})
    assert tree(t) == tree(j)
    assert tree(t)[("superstep", 2)] == t["traced/supersteps"]
    _same("traced", _fields(t, "traced"), _fields(j, "traced"),
          skip=("span_names", "span_depths", "span_counts"))
    assert np.array_equal(t["traced/x"], t["sssp_phased/x"])


def test_one_rank_world_equals_local(worlds):
    """A world of one gloo rank (what the card runs, with one NCCL rank):
    every exchange bit-equal to 'local' with equal Telemetry, 'auto'
    resolving to 'dense'; PageRank equal too."""
    o = worlds["one"]
    for a in ("cc", "sssp"):
        for ex in ("dense", "compact", "tiered", "phased", "auto"):
            case = f"{a}_{ex}"
            _same(case, _fields(o, case + "_mesh"), _fields(o, case + "_local"))
        assert str(o[f"{a}_auto_mesh/exchange"]) == "dense"
    _same("pr", _fields(o, "pr_mesh"), _fields(o, "pr_local"))


def test_refusals(worlds):
    """On the mesh: partitions that do not tile it and the megastep route
    raise ValueError; the service on a mesh raises NotImplementedError
    naming ROADMAP A8.2. The three worlds took under a minute here."""
    t = worlds["torch"]
    assert t["refuse_tiling"] and t["refuse_megastep"] and t["refuse_service"]
    assert worlds["seconds"] < 300
