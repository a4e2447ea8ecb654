"""The port's Gopher Sentinel Pass 1 on a mesh: the collective recorder
and its cross-rank agreement over 4 gloo ranks, held against the JAX
package's Pass 1 on a real 4-device ``jax.sharding.Mesh`` (the JAX
package's own Pass 1 tests build an ``AbstractMesh``, which fails under
jax 0.9.0).

One module fixture runs, at once and each in processes of its own, on
``road_grid(10, 10, drop_frac=0.05, seed=1, weighted=True)`` in 8 parts:

  * the JAX side: one process under
    ``--xla_force_host_platform_device_count=4`` runs ``verify_collectives``
    on every exchange for CC, SSSP and PageRank, and
    ``validate_stage_fns`` on compact SSSP;
  * the port: 4 gloo ranks run the same configurations with
    ``validate=True`` beside unvalidated runs, the staged stepped driver,
    the service's pooled loops, a seeded rank-dependent extra all_reduce,
    a branch on an all-reduced flag, and a collective on WORLD inside a
    3-of-4 ``sub_mesh``; each rank writes what it saw;
  * the sentinel CLI's quick matrix on 1 and 4 ranks.

The programs are written to ``tmp_path`` and run there, so no child
process imports this module (which imports JAX).
"""
import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4
ALGOS = ("cc", "sssp", "pagerank")
EXCHANGES = ("dense", "compact", "tiered", "phased")

JAX_SIDE = r'''
import argparse, json, sys
from repro.analysis import validate_stage_fns, verify_collectives
from repro.core import GopherEngine, compat
from repro.launch.sentinel import _build_graph, _plan, _program
pg = _build_graph(argparse.Namespace(rows=10, cols=10, parts=8))
mesh = compat.make_mesh((4,), ("parts",))
out = {}
for algo in ("cc", "sssp", "pagerank"):
    for ex in ("dense", "compact", "tiered", "phased"):
        eng = GopherEngine(pg, _program(algo, pg), backend="shard_map",
                           mesh=mesh, exchange=ex, tier_plan=_plan(ex, pg))
        s, vs = verify_collectives(eng)
        out[f"{algo}/{ex}"] = {"counts": s.counts,
                               "errors": [v.code for v in vs]}
eng = GopherEngine(pg, _program("sssp", pg), backend="shard_map", mesh=mesh,
                   exchange="compact")
sm, vs = validate_stage_fns(eng)
out["stages"] = {k: s.counts for k, s in sm.items()}
json.dump(out, open(sys.argv[1], "w"))
'''

TORCH_SIDE = r'''
import argparse, dataclasses, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.analysis import (PORT_CLASS, SentinelError, errors,
                                  validate_service, validate_stage_fns)
from repro_torch.core import GopherEngine, PhasedTierPlan, SemiringProgram
from repro_torch.core import Telemetry, TierPlan, init_max_vertex, tiers
from repro_torch.core import wire
from repro_torch.gofs import bfs_grow_partition, road_grid
from repro_torch.gofs.formats import partition_graph
from repro_torch.launch.mesh import make_mesh, sub_mesh
from repro_torch.launch.sentinel import _build_graph, _plan, _program
from repro_torch.serving import GraphQueryService
rank, world, rdv, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)
mesh = make_mesh((world,), ("parts",), device="cpu")
pg = _build_graph(argparse.Namespace(rows=10, cols=10, parts=8))
M = {"backend": "shard_map", "mesh": mesh, "device": "cpu"}
out = {}


def same(a, b):
    (s0, t0), (s1, t1) = a, b
    ok = all(np.array_equal(s0[k], s1[k]) for k in s0)
    for f in Telemetry.__dataclass_fields__:
        x, y = getattr(t0, f), getattr(t1, f)
        ok &= (x is None and y is None) or np.array_equal(np.asarray(x),
                                                          np.asarray(y))
    return bool(ok)


def record(name, eng, res, plain):
    summary, vs = eng.sentinel
    out[name] = {
        "equal": same(plain, res),
        "kinds": sorted({PORT_CLASS.get(k, k)
                         for k in summary.superstep_kinds()}),
        "counts": summary.counts, "static": summary.static_counts(),
        "end": summary.end_counts, "errors": [v.code for v in errors(vs)],
        "per_superstep": summary.per_superstep()}


for algo in ("cc", "sssp", "pagerank"):
    for ex in ("dense", "compact", "tiered", "phased"):
        prog = _program(algo, pg)
        plain = GopherEngine(pg, prog, exchange=ex, tier_plan=_plan(ex, pg),
                             **M).run()
        eng = GopherEngine(pg, prog, exchange=ex, tier_plan=_plan(ex, pg),
                           validate=True, **M)
        record(f"{algo}/{ex}", eng, eng.run(), plain)
# plans too narrow for the traffic: the phased route's dense retry (a branch
# on the all-reduced overflow flag) and the tiered route's dense rerun
base = TierPlan.from_graph(pg)
cold = dataclasses.replace(base, tier_bytes=np.where(
    base.tiers == tiers.EXCLUDED, tiers.EXCLUDED, tiers.COLD).astype(
    np.int8).tobytes())
for ex, plan in (("phased", PhasedTierPlan.from_tier_plan(cold)),
                 ("tiered", cold)):
    prog = _program("cc", pg)
    plain = GopherEngine(pg, prog, exchange=ex, tier_plan=plan, **M).run()
    eng = GopherEngine(pg, prog, exchange=ex, tier_plan=plan, validate=True,
                       **M)
    res = eng.run()
    record(f"spill/{ex}", eng, res, plain)
    out[f"spill/{ex}"]["dense_steps"] = int(res[1].dense_retry_steps)
    out[f"spill/{ex}"]["retried"] = bool(res[1].retried)

stages, vs = validate_stage_fns(GopherEngine(pg, _program("sssp", pg),
                                             exchange="compact", **M))
out["stages"] = {"stages": stages, "errors": [v.code for v in errors(vs)]}
svc = GraphQueryService({"g": pg}, **M)
res = validate_service(svc, families=("reach", "ppr"), qs=(1, 2))
out["service"] = {f"{k[1]}/{k[2]}": [v.code for v in errors(vs)]
                  for k, vs in res.items()}


@dataclasses.dataclass(frozen=True)
class Extra(SemiringProgram):
    """Rank 1 issues one all_reduce the others do not, at superstep 1."""
    def superstep(self, state, inbox, gb, step, reduce=None):
        if step == 1 and dist.get_rank() == 1:
            reduce(torch.ones(1, dtype=torch.int64))
        return super().superstep(state, inbox, gb, step, reduce=reduce)


@dataclasses.dataclass(frozen=True)
class Agreed(SemiringProgram):
    """An extra all_reduce on every rank, taken on an all-reduced flag
    that only rank 1 raises."""
    def superstep(self, state, inbox, gb, step, reduce=None):
        flag = reduce(torch.tensor([int(step == 1 and
                                        dist.get_rank() == 1)]))
        if int(flag) > 0:
            reduce(torch.ones(1, dtype=torch.int64))
        return super().superstep(state, inbox, gb, step, reduce=reduce)


@dataclasses.dataclass(frozen=True)
class OnWorld(SemiringProgram):
    """An all_reduce on WORLD at superstep 1."""
    def superstep(self, state, inbox, gb, step, reduce=None):
        if step == 1:
            wire.all_reduce(torch.ones(1))
        return super().superstep(state, inbox, gb, step, reduce=reduce)


t0 = time.perf_counter()
try:
    GopherEngine(pg, Extra("max_first", init_max_vertex), exchange="compact",
                 validate=True, **M).run()
    out["mismatch"] = {"raised": False}
except SentinelError as e:
    out["mismatch"] = {"raised": True,
                       "codes": [v.code for v in e.violations],
                       "detail": e.violations[0].detail,
                       "where": e.violations[0].where}
out["mismatch"]["seconds"] = time.perf_counter() - t0
eng = GopherEngine(pg, Agreed("max_first", init_max_vertex),
                   exchange="compact", validate=True, **M)
res = eng.run()
plain = GopherEngine(pg, _program("cc", pg), exchange="compact", **M).run()
out["agreed"] = {"equal": same(plain, res),
                 "errors": [v.code for v in errors(eng.sentinel[1])],
                 "extra": eng.sentinel[0].per_superstep()[1]}
g6 = road_grid(10, 10, drop_frac=0.05, seed=1, weighted=True)
pg6 = partition_graph(g6, bfs_grow_partition(g6, 6, seed=0), 6)
sub = sub_mesh([0, 1, 2], device="cpu")
if sub is not None:
    try:
        GopherEngine(pg6, OnWorld("max_first", init_max_vertex),
                     backend="shard_map", mesh=sub, exchange="dense",
                     validate=True, device="cpu").run()
        out["unbound"] = {"raised": False}
    except SentinelError as e:
        out["unbound"] = {"raised": True,
                          "codes": [v.code for v in e.violations],
                          "where": e.violations[0].where}
with open(f"{out_path}.{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _spawn(args, env, tmp, name, module=False):
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    cmd = [sys.executable, *(["-m"] if module else []), *args]
    return subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=tmp), log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sentinel"))
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
    t0 = time.perf_counter()
    procs = {"jax": _spawn(["jax_side.py", os.path.join(tmp, "jax.json")],
                           jenv, tmp, "jax")}
    for r in range(D):
        procs[f"rank{r}"] = _spawn(
            ["torch_side.py", str(r), str(D), os.path.join(tmp, "rdv"),
             os.path.join(tmp, "torch")], env, tmp, f"rank{r}")
    procs["cli"] = _spawn(
        ["repro_torch.launch.sentinel", "--matrix", "quick", "--devices",
         "1,4", "--device", "cpu", "--out", os.path.join(tmp, "cli.json")],
        env, tmp, "cli", module=True)
    rcs = {}
    for name, (p, log) in procs.items():
        try:
            rcs[name] = p.wait(timeout=300)
        finally:
            p.kill()
            log.close()
    logs = {n: open(os.path.join(tmp, f"{n}.log")).read()[-3000:]
            for n in procs}
    bad = {n: rc for n, rc in rcs.items() if rc and n != "cli"}
    if bad:
        pytest.fail(f"exit codes {bad}: {logs}")
    res = {"jax": json.load(open(os.path.join(tmp, "jax.json"))),
           "ranks": [json.load(open(os.path.join(tmp, f"torch.{r}.json")))
                     for r in range(D)],
           "cli_rc": rcs["cli"], "cli_log": logs["cli"],
           "cli_path": os.path.join(tmp, "cli.json"),
           "seconds": time.perf_counter() - t0}
    return res


def test_superstep_kinds_within_the_jax_reference(worlds):
    """Every exchange × CC/SSSP/PageRank on 4 ranks: the kinds each
    superstep issued, mapped through REF_KIND, are a subset of the JAX
    package's real-mesh verify_collectives kinds (its counts beside the
    port's: the JAX walk counts one ppermute per shifted array, the port
    one batch_isend_irecv per shift), no error; the port's stored
    REFERENCE_COUNTS are what the JAX package counts today."""
    from repro_torch.analysis import REF_KIND, REFERENCE_COUNTS
    from repro_torch.analysis.collectives import fold
    jax, r0 = worlds["jax"], worlds["ranks"][0]
    for algo in ALGOS:
        for ex in EXCHANGES:
            key = f"{algo}/{ex}"
            want = {REF_KIND[k] for k in jax[key]["counts"]}
            got = set(r0[key]["kinds"])
            assert got and got <= want, (key, got, want)
            assert jax[key]["errors"] == [] and r0[key]["errors"] == []
            fam = "pagerank" if algo == "pagerank" else "semiring"
            assert REFERENCE_COUNTS[(fam, ex)] == jax[key]["counts"], key
            print(key, "port", r0[key]["static"], "jax",
                  fold(jax[key]["counts"], REF_KIND))
    # the phased loop's supersteps route tiered: the shifts and the
    # overflow flag's all_reduce, as JAX's tiered branch
    assert r0["cc/phased"]["counts"]["batch_isend_irecv"] > 0
    assert r0["cc/tiered"]["counts"]["all_reduce"] == 1


def test_validated_mesh_runs_equal_unvalidated(worlds):
    """Each validated run returned the unvalidated run's state and
    Telemetry bit for bit on every rank (PageRank too: the same ranks sum
    in the same order), the plans that overflow included: the phased
    route's dense retries (a branch on the all-reduced overflow flag)
    and the tiered route's dense rerun, whose dense blocks stay within the
    dense byte budget."""
    for r, res in enumerate(worlds["ranks"]):
        for key, v in res.items():
            if "/" in key and "equal" in v:
                assert v["equal"], (r, key)
                assert v["errors"] == [], (r, key)
    r0 = worlds["ranks"][0]
    assert r0["spill/phased"]["dense_steps"] > 0
    assert r0["spill/tiered"]["retried"]
    # the run-end gathers are recorded beside the supersteps
    assert r0["cc/dense"]["end"]["all_gather"] >= 3


def test_stage_fns_and_service_clean(worlds):
    """validate_stage_fns (the checkpointed loop's init/sweep/pack/
    exchange/halt-vote) and validate_service (reach and PPR at Q 1 and 2
    on the phased mesh service) are clean on every rank; the staged
    driver routes its superstep by all_to_all_single, as the JAX stage
    program routes by all_to_all."""
    jax = worlds["jax"]["stages"]
    for res in worlds["ranks"]:
        assert res["stages"]["errors"] == []
        assert all(v == [] for v in res["service"].values())
        assert len(res["service"]) == 4
        st = res["stages"]["stages"]
        assert set(st["exchange"]) == {"all_to_all_single"}
        assert set(st["halt-vote"]) == {"all_reduce"}
        assert st["checkpoint"]["barrier"] == 1
    assert set(jax["route"]) == {"all_to_all"} and jax["init"] == {}


def test_rank_dependent_collective_raises_on_every_rank(worlds):
    """Rank 1 issues one all_reduce the others do not: every rank raises
    COLLECTIVE_MISMATCH at once, naming each rank's site, kind and shape,
    and none hangs (the agreement exchange runs before the collective)."""
    for r, res in enumerate(worlds["ranks"]):
        m = res["mismatch"]
        assert m["raised"] and m["codes"] == ["COLLECTIVE_MISMATCH"], r
        assert "rank 1: all_reduce of shape (1,)" in m["detail"]
        assert "torch_side.py" in m["detail"]       # rank 1's own site
        assert "rank 0: all_to_all_single" in m["detail"]
        assert "core/messages.py" in m["detail"]    # the others' site
        assert m["seconds"] < 120, m


def test_branch_on_an_all_reduced_flag_passes(worlds):
    """An extra collective every rank takes on an all-reduced flag agrees
    by construction: the validated run passes, equal to the plain run."""
    for res in worlds["ranks"]:
        a = res["agreed"]
        assert a["equal"] and a["errors"] == []
        assert a["extra"]["all_reduce"] == 3        # flag, extra, halt vote


def test_world_collective_in_a_sub_mesh_is_unbound(worlds):
    """Inside a 3-of-4 sub_mesh (rank 3 lost) an all_reduce on WORLD is
    refused on each survivor before it is issued (UNBOUND_GROUP, naming
    its file:line), and nobody hangs on the lost rank."""
    for r, res in enumerate(worlds["ranks"]):
        if r == 3:
            assert "unbound" not in res
            continue
        u = res["unbound"]
        assert u["raised"] and u["codes"] == ["UNBOUND_GROUP"], u
        assert u["where"].startswith(worlds["ranks"][0]["unbound"]["where"]
                                     .rsplit(":", 1)[0])
        assert "torch_side.py:" in u["where"]


def test_cli_quick_matrix(worlds):
    """``python -m repro_torch.launch.sentinel --matrix quick --devices
    1,4 --device cpu`` exits 0 with the JAX CLI's report keys, an 'hlo'
    entry saying what replaced the HLO cross-check, and the D = 4 counts
    beside the JAX reference's."""
    assert worlds["cli_rc"] == 0, worlds["cli_log"]
    rep = json.load(open(worlds["cli_path"]))
    for k in ("matrix", "devices", "configs", "staged_driver", "serving",
              "kernel_lint", "semirings", "violations", "summary", "hlo"):
        assert k in rep, k
    assert rep["devices"] == [1, 4] and rep["summary"]["errors"] == 0
    assert rep["hlo"]["ported"] is False
    local = [c for c in rep["configs"] if c["backend"] == "local"]
    assert {c["exchange"] for c in local} == {"megastep"}
    assert all(c["counts"] == {} and c["errors"] == 0 for c in local)
    mesh4 = [c for c in rep["configs"] if c["D"] == 4]
    assert len(mesh4) == 6 and all("reference_counts" in c for c in mesh4)
    print("sentinel fixture", worlds["seconds"], "s")
