"""Gopher Shield chaos CLI — deterministic fault scenarios with parity gates.

    PYTHONPATH=src python -m repro_torch.launch.chaos [--quick] \
        [--device cuda] [--parts 8] [--out chiprun_out/chaos_torch.json] \
        [--scenarios a,b,...]

The port of the JAX package's ``launch/chaos.py``, on the port's engine,
service and checkpointer, on ``--device`` (the card unless ``cpu`` is
asked for). Each scenario injects a seeded
:class:`repro_torch.resilience.faults.FaultPlan` into a real run and
asserts BOTH recovery and parity (recovered results bit-identical to the
fault-free reference for idempotent ⊕ programs, allclose for PageRank):

    corrupt_snapshot  the newest checkpoint is bit-flipped on disk; resume
                      must fall back to the previous checksum-verified one
    failed_delta      a delta-apply attempt fails; the service retries with
                      backoff and reports the recovery, clients never error
    corrupt_block     the zero-repack block patch is corrupted; the service
                      cold-rebuilds from the installed version and retries
    straggler         injected superstep stalls; the run completes with
                      bit-identical results (stalls cost time, never math)
    poisoned_query    a batch run is poisoned; the retry serves the batch
                      with no client-visible error
    skew_heal         a load-proportional straggler pins one partition; the
                      Gopher Balance actuator migrates its sub-graphs off,
                      the imbalance score drops >=2x, only the PLANNED
                      sub-graphs move (no full re-partition), and results
                      match the fault-free run (also writes
                      ``balance_torch.json`` next to the main report)
    device_loss       mid-run device loss on a D-device mesh: it needs the
                      multi-device backend's device-loss half (ROADMAP
                      A8.2), so it reports a failed gate naming it; not in
                      the default list

Writes the machine-readable report to ``--out`` only, and exits non-zero
if any scenario failed its recovery or parity gate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

_ALL = ("device_loss", "corrupt_snapshot", "failed_delta", "corrupt_block",
        "straggler", "poisoned_query", "skew_heal")
# device_loss needs the mesh's device-loss half (ROADMAP A8.2): asked for
# by name only
_DEFAULT = tuple(s for s in _ALL if s != "device_loss")


def _parse(argv=None):
    ap = argparse.ArgumentParser(description="Gopher Shield chaos scenarios")
    ap.add_argument("--quick", action="store_true",
                    help="smaller matrix (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (the card) or cpu")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--rows", type=int, default=9)
    ap.add_argument("--cols", type=int, default=9)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="chiprun_out/chaos_torch.json")
    ap.add_argument("--scenarios", default=",".join(_DEFAULT),
                    help="comma-separated subset of: " + ", ".join(_ALL))
    return ap.parse_args(argv)


def _graph(args):
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    g = road_grid(args.rows, args.cols, drop_frac=0.05, seed=args.seed,
                  weighted=True)
    return g, partition_graph(g, bfs_grow_partition(g, args.parts, seed=0),
                              args.parts)


def _program(algo, pg):
    from repro_torch.core import (PageRankProgram, SemiringProgram,
                                  init_max_vertex, make_sssp_init)
    if algo == "cc":
        return SemiringProgram(semiring="max_first", init_fn=init_max_vertex)
    if algo == "sssp":
        sp, sl = int(pg.part_of[0]), int(pg.local_of[0])
        return SemiringProgram(semiring="min_plus",
                               init_fn=make_sssp_init(sp, sl))
    return PageRankProgram(n_global=pg.n_global, num_iters=10)


def _state_parity(a, b, exact):
    import numpy as np
    if sorted(a) != sorted(b):
        return False
    la, lb = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
    if len(la) != len(lb):
        return False
    if exact:
        return all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(la, lb))
    return all(np.allclose(np.asarray(x), np.asarray(y), rtol=1e-6,
                           atol=1e-6) for x, y in zip(la, lb))


# ---------------------------------------------------------------- scenarios

def scenario_device_loss(args):
    """Mid-run device loss on a D-device mesh -> shrink + resume. The
    mesh-shrink failover waits for ROADMAP A8.2."""
    return {"ok": False,
            "error": "needs the mesh's device-loss half: ROADMAP A8.2"}


def scenario_corrupt_snapshot(args):
    """Bit-flip the newest snapshot; resume must fall back one step."""
    from repro_torch.core import GopherEngine
    from repro_torch.training.checkpoint import Checkpointer
    _, pg = _graph(args)
    prog = _program("cc", pg)
    ref, _ = GopherEngine(pg, prog, exchange="dense",
                          device=args.device).run()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        eng = GopherEngine(pg, prog, exchange="compact", max_supersteps=3,
                           device=args.device)
        eng.run(checkpointer=ck, checkpoint_every=1)
        latest = ck.latest_step()
        npz = os.path.join(d, f"step_{latest}", "host_0.npz")
        with open(npz, "r+b") as f:      # flip bytes mid-file: truncation
            f.seek(200)                   # and bit-rot look the same to CRC
            f.write(b"\xde\xad\xbe\xef")
        good = ck.latest_good_step()
        eng2 = GopherEngine(pg, prog, exchange="compact",
                            device=args.device)
        state, tele = eng2.run(checkpointer=ck, checkpoint_every=1,
                               resume=True)
    parity = _state_parity(state, ref, exact=True)
    fell_back = good is not None and latest is not None and good < latest
    return {"ok": parity and fell_back, "parity": parity,
            "latest_step": latest, "fallback_step": good,
            "fell_back": fell_back, "supersteps": int(tele.supersteps)}


def _service(args, **kw):
    from repro_torch.serving.service import GraphQueryService
    _, pg = _graph(args)
    return pg, GraphQueryService({"g": pg}, retry_base_s=0.001,
                                 device=args.device, **kw)


def _delta(pg, seed):
    import numpy as np
    from repro_torch.gofs import EdgeDelta
    rng = np.random.default_rng(seed)
    n = pg.n_global
    iu = rng.integers(0, n, 6)
    iv = (iu + rng.integers(1, n, 6)) % n
    return EdgeDelta.of(insert_src=iu, insert_dst=iv,
                        insert_wgt=rng.uniform(0.2, 2.0, 6)
                        .astype(np.float32))


def scenario_failed_delta(args):
    """Delta-apply fault: retry with backoff, recovery in svc.stats(),
    clients keep getting version-v answers with no errors."""
    from repro_torch.resilience import faults
    pg, svc = _service(args)
    r0 = svc.query("sssp", "g", [0])
    v0 = svc.graphs["g"].version
    plan = faults.FaultPlan([faults.FaultSpec(
        "svc.apply_delta", "failed_delta", at=0)], seed=args.seed)
    with faults.inject(plan):
        svc.apply_delta("g", _delta(pg, args.seed))
    r1 = svc.query("sssp", "g", [1])
    st = svc.stats()
    ok = (r0.error is None and r1.error is None
          and svc.graphs["g"].version == v0 + 1
          and st["delta_retries"] >= 1 and st["recoveries"] >= 1)
    return {"ok": ok, "version_before": v0,
            "version_after": svc.graphs["g"].version,
            "delta_retries": st["delta_retries"],
            "recoveries": st["recoveries"],
            "client_errors": int(r0.error is not None)
            + int(r1.error is not None), "fired": plan.record()}


def scenario_corrupt_block(args):
    """Corrupted zero-repack patch: cold rebuild + retry; patched-serving
    results match an independently built service at the same version."""
    import numpy as np
    from repro_torch.gofs.temporal import apply_delta as _apply
    from repro_torch.resilience import faults
    from repro_torch.serving.service import GraphQueryService
    pg, svc = _service(args)
    svc.query("sssp", "g", [0])           # build the patchable host twin
    delta = _delta(pg, args.seed + 1)
    plan = faults.FaultPlan([faults.FaultSpec(
        "blocks.patch", "corrupt_block", at=0)], seed=args.seed)
    v0 = svc.graphs["g"].version
    with faults.inject(plan):
        svc.apply_delta("g", delta)
    got = svc.query("sssp", "g", [5])
    ref_pg = _apply(pg, delta, directed=False).pg
    ref = GraphQueryService({"g": ref_pg}, device=args.device).query(
        "sssp", "g", [5])
    st = svc.stats()
    parity = (got.error is None and ref.error is None
              and np.array_equal(got.result, ref.result))
    ok = (parity and svc.graphs["g"].version == v0 + 1
          and st["delta_retries"] >= 1 and st["recoveries"] >= 1)
    return {"ok": ok, "parity": parity,
            "delta_retries": st["delta_retries"],
            "recoveries": st["recoveries"], "fired": plan.record()}


def scenario_straggler(args):
    """Injected superstep stalls: completion + bit-identical results."""
    from repro_torch.core import GopherEngine
    from repro_torch.resilience import faults
    from repro_torch.training.checkpoint import Checkpointer
    _, pg = _graph(args)
    prog = _program("cc", pg)
    ref, _ = GopherEngine(pg, prog, exchange="dense",
                          device=args.device).run()
    plan = faults.FaultPlan([faults.FaultSpec(
        "engine.superstep", "straggler", prob=0.5, times=3,
        delay_s=0.05)], seed=args.seed)
    with tempfile.TemporaryDirectory() as d:
        eng = GopherEngine(pg, prog, exchange="compact", device=args.device)
        t0 = time.perf_counter()
        with faults.inject(plan):
            state, tele = eng.run(checkpointer=Checkpointer(d),
                                  checkpoint_every=2)
        wall_s = time.perf_counter() - t0
    parity = _state_parity(state, ref, exact=True)
    stalls = len(plan.record())
    return {"ok": parity and stalls >= 1, "parity": parity,
            "stalls": stalls, "wall_s": round(wall_s, 3),
            "supersteps": int(tele.supersteps)}


def scenario_poisoned_query(args):
    """Poisoned batch run: the retry serves it, no client-visible error."""
    from repro_torch.resilience import faults
    _, svc = _service(args)
    plan = faults.FaultPlan([faults.FaultSpec(
        "svc.query", "poisoned_query", at=0)], seed=args.seed)
    with faults.inject(plan):
        r = svc.query("sssp", "g", [3])
    st = svc.stats()
    ok = (r.error is None and st["query_retries"] >= 1
          and st["recoveries"] >= 1 and st["degraded_batches"] == 0)
    return {"ok": ok, "client_error": r.error,
            "query_retries": st["query_retries"],
            "recoveries": st["recoveries"], "fired": plan.record()}


def _skew_graph(args):
    """A deliberately skewed layout the actuator can actually heal:
    partition 0 holds TWO non-adjacent 2-column strips of a road grid
    (two whole local sub-graphs with real cut edges), partitions 1 and 2
    are half-full (free slots = migration headroom), partition 3 is full
    — so healing means draining partition 0 into 1 and 2, one sub-graph
    per move, and nothing else is allowed to change."""
    import numpy as np
    from repro_torch.gofs import partition_graph, road_grid
    rows, cols = 6, 12
    g = road_grid(rows, cols, drop_frac=0.0, seed=args.seed, weighted=True)
    strip = (np.arange(rows * cols) % cols) // 2
    assign = np.asarray([0, 1, 2, 0, 3, 3], np.int32)[strip]
    return g, partition_graph(g, assign, 4)


def scenario_skew_heal(args):
    """Straggler pins partition 0 -> live migration drains it; gates:
    imbalance drops >=2x, results match the fault-free run, and ONLY the
    planned sub-graphs moved (no full re-partition)."""
    import numpy as np
    from repro_torch.core import GopherEngine
    from repro_torch.resilience import faults
    from repro_torch.resilience.balance import (BalancePolicy,
                                                run_with_rebalance, to_global)
    from repro_torch.training.checkpoint import Checkpointer
    _, pg = _skew_graph(args)
    part0 = np.asarray(pg.part_of).copy()
    algos = ("cc",) if args.quick else ("cc", "pagerank")
    out = {"ok": True, "algos": {}}
    for algo in algos:
        prog = _program(algo, pg)
        ref, _ = GopherEngine(pg, prog, exchange="dense",
                              device=args.device).run()
        ref_g = to_global(ref, pg)
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", "straggler", prob=1.0, times=9999,
            delay_s=0.008, payload={"part": 0})], seed=args.seed)
        eng = GopherEngine(pg, prog, exchange="compact", device=args.device)
        # sub-graph-centric cc converges in quotient-graph-diameter
        # supersteps (~5 here), so decide EVERY superstep: two moves drain
        # partition 0 early enough that the final segment runs stall-free
        pol = BalancePolicy(threshold=1.3, floor=1.05,
                            max_verts_per_step=12, check_every=1,
                            cooldown_segments=0)
        with tempfile.TemporaryDirectory() as d:
            with faults.inject(plan):
                eng2, state, tele, rep = run_with_rebalance(
                    eng, Checkpointer(d), every=1, policy=pol)
        parity = _state_parity(to_global(state, eng2.pg), ref_g,
                               exact=algo != "pagerank")
        # only the planned sub-graphs moved, along the planned routes
        part1 = np.asarray(eng2.pg.part_of)
        changed = np.nonzero(part0 != part1)[0]
        routes = {(m["src"], m["dst"]) for m in rep.migrations}
        moved_ok = (len(changed) == rep.moved_verts()
                    and all((int(part0[g]), int(part1[g])) in routes
                            for g in changed))
        ratio = rep.imbalance_before / max(rep.imbalance_after, 1e-9)
        drained = int(np.sum(part1 == 0)) == 0
        ok = (parity and moved_ok and rep.rollbacks == 0
              and len(rep.migrations) >= 1 and ratio >= 2.0
              and eng2.pg.num_parts == pg.num_parts)
        out["algos"][algo] = {
            "parity": parity, "migrations": rep.migrations,
            "rollbacks": rep.rollbacks, "segments": rep.segments,
            "moved_verts": rep.moved_verts(),
            "moved_only_planned": moved_ok, "victim_drained": drained,
            "imbalance_before": round(rep.imbalance_before, 3),
            "imbalance_after": round(rep.imbalance_after, 3),
            "imbalance_drop": round(ratio, 3),
            "supersteps": int(tele.supersteps), "stalls": len(plan.record()),
        }
        out["ok"] = out["ok"] and ok
    bench = os.path.join(
        os.path.dirname(os.path.abspath(args.out)), "balance_torch.json")
    with open(bench, "w") as f:
        json.dump({"scenario": "skew_heal", "quick": bool(args.quick),
                   "gates": {"min_imbalance_drop": 2.0,
                             "parity": "exact (cc) / allclose (pagerank)",
                             "moved_only_planned": True},
                   "algos": out["algos"]}, f, indent=1)
    out["bench"] = bench
    return out


_SCENARIOS = {
    "device_loss": scenario_device_loss,
    "corrupt_snapshot": scenario_corrupt_snapshot,
    "failed_delta": scenario_failed_delta,
    "corrupt_block": scenario_corrupt_block,
    "straggler": scenario_straggler,
    "poisoned_query": scenario_poisoned_query,
    "skew_heal": scenario_skew_heal,
}


def main(argv=None) -> int:
    args = _parse(argv)
    names = [s for s in str(args.scenarios).split(",") if s]
    unknown = [s for s in names if s not in _SCENARIOS]
    if unknown:
        print(f"unknown scenarios: {unknown}", file=sys.stderr)
        return 2
    # the report and skew_heal's side file go beside each other
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    report = {"quick": bool(args.quick), "device": args.device,
              "parts": args.parts, "seed": args.seed, "scenarios": {}}
    for name in names:
        t0 = time.perf_counter()
        try:
            res = _SCENARIOS[name](args)
        except Exception as e:  # a scenario crash is a failed gate
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        res["seconds"] = round(time.perf_counter() - t0, 2)
        report["scenarios"][name] = res
        print(f"chaos[{name}]: {'OK' if res['ok'] else 'FAIL'} "
              f"({res['seconds']}s)"
              + (f" — {res.get('error')}" if not res["ok"] else ""))
    passed = sum(1 for r in report["scenarios"].values() if r["ok"])
    report["summary"] = {"total": len(names), "passed": passed,
                         "failed": len(names) - passed}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"# gopher chaos — {passed}/{len(names)} scenarios recovered "
          f"with parity -> {args.out}")
    return 0 if passed == len(names) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
