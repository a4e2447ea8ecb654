"""Gopher Sentinel CLI — the whole verification matrix.

    PYTHONPATH=src python -m repro_torch.launch.sentinel --matrix quick \
        [--devices 1,4] [--device cpu|cuda] [--parts 8] [--rows 10] \
        [--cols 10] [--out sentinel_report.json]

The port of the JAX package's ``launch/sentinel.py``, on ``--device`` (the
card unless ``cpu`` is asked for). It runs the three sentinel passes (see
``repro_torch.analysis``) over the exchange × algorithm × mesh matrix:

  * **Pass 1** (the collective recorder) runs every configuration once
    with ``GopherEngine(validate=True)``: {dense, compact, tiered, phased,
    auto} × {cc, bfs, sssp, pagerank} on ``backend='shard_map'`` for each
    D of ``--devices`` (quick: cc and pagerank on dense, tiered and
    phased), every rank agreeing on every collective before it runs; plus
    the LOCAL backend where ``exchange='auto'`` takes the fused megastep
    route, which must record no collective at all. Each D > 1 (and D = 1:
    one rank) runs in ``launch.mesh.launch_ranks`` processes of this
    command (gloo ranks on the CPU, NCCL ranks on the card, one card a
    rank), which report to the launcher.
  * **Pass 1 over the staged stepped driver** (``validate_stage_fns``:
    the loop checkpointed and recovered runs take) and the service's
    pooled batched loops (``validate_service``), per D.
  * **Pass 2** (semiring laws) probes every registered semiring and each
    program's ⊕/⊗ algebra.
  * **Pass 3** (the CUDA-source linter) lints ``kernels/csrc/*.cu`` and the
    wrappers.

The JAX CLI's HLO cross-check has no port: it parses XLA's compiled HLO,
which the port does not have. Its byte rule lives on in Pass 1's
``WIRE_BYTE_BUDGET`` over the bytes each recorded collective ships; the
report says so under ``"hlo"``. At the JAX reference's own configuration
(10 × 10, 8 parts, D = 4) each mesh entry also carries the JAX loop's
counts (``reference_counts``) beside its own, and a difference is a
warning.

Writes a machine-readable JSON report (the JAX CLI's keys) and exits
non-zero on any error-severity violation.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.launch.mesh import init_rank, launch_ranks

_ALGOS = ("cc", "bfs", "sssp", "pagerank")
_MODES = ("dense", "compact", "tiered", "phased", "auto")
# the configuration the port's reference counts were taken at
_REFERENCE_AT = (10, 10, 8, 4)


def _parse(argv=None):
    ap = argparse.ArgumentParser(description="Gopher Sentinel checks")
    ap.add_argument("--matrix", choices=("full", "quick"), default="full")
    ap.add_argument("--devices", default="1,2,4",
                    help="comma-separated mesh sizes to verify")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--rows", type=int, default=10)
    ap.add_argument("--cols", type=int, default=10)
    ap.add_argument("--out", default="sentinel_report.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    # a rank of one mesh size's run (set by the command itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _build_graph(args):
    from repro_torch.gofs import bfs_grow_partition, road_grid
    from repro_torch.gofs.formats import partition_graph
    g = road_grid(args.rows, args.cols, drop_frac=0.05, seed=1,
                  weighted=True)
    return partition_graph(g, bfs_grow_partition(g, args.parts, seed=0),
                           args.parts)


def _program(algo: str, pg):
    from repro_torch.core import (PageRankProgram, SemiringProgram,
                                  init_max_vertex, make_bfs_init,
                                  make_sssp_init)
    sp, sl = int(pg.part_of[0]), int(pg.local_of[0])
    if algo == "cc":
        return SemiringProgram(semiring="max_first", init_fn=init_max_vertex)
    if algo == "bfs":
        return SemiringProgram(semiring="min_plus",
                               init_fn=make_bfs_init(sp, sl))
    if algo == "sssp":
        return SemiringProgram(semiring="min_plus",
                               init_fn=make_sssp_init(sp, sl))
    return PageRankProgram(n_global=pg.n_global, num_iters=12)


def _plan(mode: str, pg):
    from repro_torch.core import PhasedTierPlan, TierPlan
    from repro_torch.core.tiers import _NO_BOUNDARY
    if mode == "tiered":
        return TierPlan.from_graph(pg)
    if mode == "phased":
        base = TierPlan.from_graph(pg)
        return PhasedTierPlan(
            num_parts=base.num_parts, cap=base.cap, warm_cap=base.warm_cap,
            phase_tier_bytes=(base.tier_bytes, base.tier_bytes),
            boundaries=(3, _NO_BOUNDARY))
    return None


def _matrix(args):
    algos = _ALGOS if args.matrix == "full" else ("cc", "pagerank")
    modes = _MODES if args.matrix == "full" else ("dense", "tiered",
                                                  "phased")
    return algos, modes


def _validated(make, entry: dict, violations: list, reference=None):
    """Build an engine with ``make()`` (validate=True), run it once and
    fill ``entry`` with its record; a SentinelError (raised on every rank
    alike) becomes the entry's violations."""
    from repro_torch.analysis import SentinelError, check_run, errors
    eng = None
    try:
        eng = make()
        eng.run()
        summary, vs = eng.sentinel
        if reference is not None:
            vs = vs + [v for v in check_run(
                summary, eng.exchange, eng.backend, reference=reference,
                where=entry["where"]) if v.code ==
                "COUNT_DIFFERS_FROM_REFERENCE"]
        entry.update(exchange=eng.exchange,
                     static_counts=summary.static_counts(),
                     **summary.to_json())
    except SentinelError as e:
        vs = e.violations
        if eng is not None:
            entry["exchange"] = eng.exchange
    violations += vs
    entry["errors"] = len(errors(vs))
    return entry


def run_mesh(args, mesh) -> dict:
    """One rank's share of the mesh matrix at D = ``args.world``: every
    rank runs every configuration; returns the entries and findings."""
    from repro_torch.analysis import (ERROR, REFERENCE_COUNTS, SentinelError,
                                      Violation, errors, validate_service,
                                      validate_stage_fns)
    from repro_torch.analysis.collectives import program_family
    from repro_torch.core import GopherEngine
    from repro_torch.serving.service import GraphQueryService

    pg = _build_graph(args)
    D = args.world
    algos, modes = _matrix(args)
    at_ref = (args.rows, args.cols, args.parts, D) == _REFERENCE_AT
    violations, configs = [], []
    for algo in algos:
        for mode in modes:
            prog = _program(algo, pg)
            ex = "tiered" if mode == "auto" and D > 1 else (
                "dense" if mode == "auto" else mode)
            ref = (REFERENCE_COUNTS.get((program_family(prog), ex))
                   if at_ref else None)
            entry = {"algo": algo, "requested_exchange": mode, "D": D,
                     "backend": "shard_map",
                     "where": f"{algo}/{mode}/D={D}"}
            if ref is not None:
                entry["reference_counts"] = ref
            configs.append(_validated(lambda: GopherEngine(
                pg, prog, backend="shard_map", mesh=mesh, exchange=mode,
                tier_plan=_plan(mode, pg), validate=True,
                device=args.device), entry, violations, ref))

    staged = {"driver": "staged", "D": D}
    try:
        stages, vs = validate_stage_fns(GopherEngine(
            pg, _program("sssp", pg), backend="shard_map", mesh=mesh,
            exchange="compact", device=args.device))
        violations += vs
        staged["stages"] = stages
        staged["errors"] = len(errors(vs))
    except SentinelError as e:
        violations.append(Violation(
            pass_name="collectives", code="STAGED_DRIVER",
            where=f"staged/D={D}", detail=str(e), severity=ERROR))
        staged["errors"] = 1

    svc = GraphQueryService({"sentinel": pg}, backend="shard_map",
                            mesh=mesh, device=args.device)
    families = ("reach", "ppr") if args.matrix == "full" else ("reach",)
    qs = (1, 2) if args.matrix == "full" else (1,)
    serving = {}
    try:
        res = validate_service(svc, families=families, qs=qs)
        serving = {f"{g}/{fam}/Q={q}/D={D}": len(errors(vs))
                   for (g, fam, q), vs in res.items()}
        for vs in res.values():
            violations += vs
    except SentinelError as e:
        violations.append(Violation(
            pass_name="collectives", code="SERVING_LOOP",
            where=f"serving/D={D}", detail=str(e), severity=ERROR))
    return {"configs": configs, "staged": staged, "serving": serving,
            "violations": [v.to_json() for v in violations]}


def run_matrix(args) -> dict:
    """The whole report: Passes 2 and 3 and the local configurations
    here, each mesh size's configurations in its own ranks."""
    from repro_torch.analysis import (REGISTRY, Violation, check_program,
                                      check_semiring, errors, lint_kernels)
    from repro_torch.core import GopherEngine

    pg = _build_graph(args)
    devices = tuple(int(d) for d in str(args.devices).split(",") if d)
    algos, _ = _matrix(args)
    violations = []
    kern = lint_kernels()
    violations += kern
    semi = {}
    for name in REGISTRY:
        vs = check_semiring(name)
        violations += vs
        semi[name] = {"violations": [v.to_json() for v in vs]}

    configs = []
    # local-backend coverage: 'auto' takes the fused megastep route for the
    # eligible programs, which must record no collective
    for algo in algos:
        prog = _program(algo, pg)
        entry = {"algo": algo, "requested_exchange": "auto", "D": 1,
                 "backend": "local", "where": f"{algo}/auto/local"}
        configs.append(_validated(lambda: GopherEngine(
            pg, prog, exchange="auto", validate=True, device=args.device),
            entry, violations))
    staged, serving = [], {}
    for D in devices:
        text = launch_ranks("repro_torch.launch.sentinel",
                            args.argv + ["--world", str(D)], D, args.device)
        part = json.loads(text.strip().splitlines()[-1])
        configs += part["configs"]
        staged.append(part["staged"])
        serving.update(part["serving"])
        violations += [Violation(**v) for v in part["violations"]]
    # Pass 2's findings (infos included) on each program × exchange run
    for algo, ex in sorted({(c["algo"], c["exchange"]) for c in configs
                            if "exchange" in c}):
        violations += check_program(_program(algo, pg), ex)

    errs = errors(violations)
    for c in configs:
        c.pop("where", None)
    return {
        "matrix": args.matrix,
        "devices": list(devices),
        "device": args.device,
        "configs": configs,
        "staged_driver": staged,
        "serving": serving,
        "kernel_lint": [v.to_json() for v in kern],
        "semirings": semi,
        "hlo": {"ported": False,
                "detail": ("the JAX CLI's HLO cross-check parses XLA's "
                           "compiled HLO, which the port has none of; the "
                           "recorded collectives' WIRE_BYTE_BUDGET (Pass 1) "
                           "holds each tiered/phased run's shipped bytes to "
                           "the tier schedule's per-kind budgets instead")},
        "violations": [v.to_json() for v in violations],
        "summary": {
            "configs": len(configs),
            "violations": len(violations),
            "errors": len(errs),
            "warnings_infos": len(violations) - len(errs),
            "hlo_checked": 0,
            "budget_checked": sum(
                1 for c in configs if c.get("backend") == "shard_map"
                and c.get("exchange") in ("tiered", "phased")),
        },
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    if args.rank is not None:
        mesh = init_rank(args.rank, args.world, args.rendezvous, args.device)
        try:
            part = run_mesh(args, mesh)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        if args.rank == 0:
            print(json.dumps(part))
        return 0
    args.argv = argv
    report = run_matrix(args)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    s = report["summary"]
    print(f"# gopher sentinel — matrix={report['matrix']} "
          f"device={report['device']} configs={s['configs']} "
          f"budget_checked={s['budget_checked']}")
    for v in report["violations"]:
        print(f"  [{v['pass_name']}:{v['code']}] ({v['severity']}) "
              f"{v['where']}: {v['detail']}")
    print(f"# errors={s['errors']} warnings/infos={s['warnings_infos']} "
          f"-> {args.out}")
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
