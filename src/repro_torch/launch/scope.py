"""Gopher Scope CLI: trace a BSP run and render the observability report.

    PYTHONPATH=src python -m repro_torch.launch.scope [--algo cc|sssp] \
        [--rows 40 --cols 40] [--parts 4] [--exchange auto|dense|compact| \
        tiered|phased] [--device cuda] [--boundary-sync] \
        [--profile-dir DIR] [--out chiprun_out/scope]

The port of the JAX package's ``launch/scope.py``, on ``--device`` (the
card unless ``cpu`` is asked for). Builds a road-grid graph, runs CC or
SSSP with the Gopher Scope tracer enabled, then

  * prints the TEXT TIMELINE — the nested run -> phase -> superstep ->
    {plan, pack, exchange, sweep, halt-vote} spans with wall-clock;
  * prints the per-partition skew report and the metrics snapshot (engine
    counters, tier-plan builds, profile drift);
  * writes scope_trace.json (load in Perfetto / chrome://tracing),
    scope_trace.jsonl and scope_metrics.json into --out.

``--profile-dir`` also captures the run under ``torch.profiler`` (the
kernels' device time on the card) into that directory.
``--backend shard_map`` needs the multi-device backend, which is not
ported (ROADMAP A8), and raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _parse(argv=None):
    ap = argparse.ArgumentParser(description="Gopher Scope trace report")
    ap.add_argument("--algo", choices=("cc", "sssp"), default="cc")
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--cols", type=int, default=40)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--backend", choices=("local", "shard_map"),
                    default="local")
    ap.add_argument("--exchange", default="auto",
                    choices=("auto", "dense", "compact", "tiered", "phased"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--boundary-sync", action="store_true",
                    help="synchronize the card per stage: honest per-stage "
                         "wall-clock instead of enqueue time")
    ap.add_argument("--profile-dir", default=None,
                    help="also capture a torch.profiler trace there")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "scope"),
                    help="directory for scope_trace.json[l] + "
                         "scope_metrics.json")
    return ap.parse_args(argv)


def text_timeline(tracer, file=None) -> None:
    """Indented span tree with wall-clock — the terminal half of the
    Perfetto file."""
    file = file or sys.stdout
    show = ("supersteps", "wire_slots", "step", "phase", "nchanged",
            "spills", "dispatches")
    for s in sorted(tracer.spans, key=lambda s: (s.t0_ns, -s.dur_ns)):
        args = " ".join(f"{k}={s.args[k]}" for k in show if k in s.args)
        print(f"{'  ' * s.depth}{s.name:<{24 - 2 * min(s.depth, 8)}} "
              f"{s.dur_ns / 1e6:9.3f} ms  {args}", file=file)


def _build(args):
    from repro_torch.core import (GopherEngine, PhasedTierPlan,
                                  SemiringProgram, init_max_vertex,
                                  make_sssp_init)
    from repro_torch.gofs import bfs_grow_partition, road_grid
    from repro_torch.gofs.formats import partition_graph
    from repro_torch.obs import Tracer

    if args.backend == "shard_map":
        raise NotImplementedError(
            "--backend shard_map needs the multi-device backend, which is "
            "not ported yet: ROADMAP A8")
    g = road_grid(args.rows, args.cols, seed=1)
    pg = partition_graph(g, bfs_grow_partition(g, args.parts, seed=0),
                         args.parts)
    if args.algo == "cc":
        prog = SemiringProgram(semiring="max_first", init_fn=init_max_vertex)
    else:
        prog = SemiringProgram(
            semiring="min_plus",
            init_fn=make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    plan = (PhasedTierPlan.from_graph(pg)
            if args.exchange == "phased" else None)
    tracer = Tracer(enabled=True, boundary_sync=args.boundary_sync,
                    profiler_dir=args.profile_dir)
    eng = GopherEngine(pg, prog, exchange=args.exchange, tier_plan=plan,
                       tracer=tracer, device=args.device)
    return eng, tracer


def main(argv=None) -> None:
    args = _parse(argv)
    eng, tracer = _build(args)
    state, tele = eng.run()
    from repro_torch.obs import metrics as obs_metrics

    print(f"# gopher scope — {args.algo} on {args.rows}x{args.cols} road "
          f"grid, {args.parts} parts, device={eng.device} "
          f"exchange={eng.exchange}")
    print(f"# supersteps={tele.supersteps} wire_slots={tele.wire_slots} "
          f"messages={tele.messages_sent}\n")
    text_timeline(tracer)
    print("\n# skew")
    print(json.dumps(tele.skew(), indent=1))
    print("\n# metrics")
    snap = obs_metrics.default_registry().snapshot()
    print(json.dumps(snap, indent=1))

    os.makedirs(args.out, exist_ok=True)
    tp = tracer.write_chrome_trace(os.path.join(args.out, "scope_trace.json"))
    lp = tracer.write_jsonl(os.path.join(args.out, "scope_trace.jsonl"))
    mp = obs_metrics.default_registry().write_json(
        os.path.join(args.out, "scope_metrics.json"))
    print(f"\n# wrote {tp}  {lp}  {mp}", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
