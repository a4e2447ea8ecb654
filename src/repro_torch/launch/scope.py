"""Gopher Scope CLI: trace a BSP run and render the observability report.

    PYTHONPATH=src python -m repro_torch.launch.scope [--algo cc|sssp] \
        [--rows 40 --cols 40] [--parts 4] [--exchange auto|dense|compact| \
        tiered|phased] [--backend local|shard_map] [--devices 4] \
        [--device cuda] [--boundary-sync] [--profile-dir DIR] \
        [--out chiprun_out/scope]

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

``--backend shard_map --devices N`` runs the traced run on a mesh of N
ranks: the command starts N processes of itself (gloo ranks on ``--device
cpu``; NCCL ranks on ``cuda``, one card each, so N must not exceed the
cards present), rendezvousing through a file in a temporary directory.
Every rank traces; rank 0 prints the report and writes the three files,
and the command fails if any rank does.
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
    ap.add_argument("--devices", type=int, default=4,
                    help="the mesh's ranks on --backend shard_map")
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
    # a rank of a --backend shard_map run (set by the command itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
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


def _build(args, mesh=None):
    from repro_torch.core import (GopherEngine, PhasedTierPlan,
                                  SemiringProgram, init_max_vertex,
                                  make_sssp_init)
    from repro_torch.gofs import bfs_grow_partition, road_grid
    from repro_torch.gofs.formats import partition_graph
    from repro_torch.obs import Tracer

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
    eng = GopherEngine(pg, prog, backend=args.backend, mesh=mesh,
                       exchange=args.exchange, tier_plan=plan,
                       tracer=tracer, device=args.device)
    return eng, tracer


def _launch_ranks(argv, args) -> None:
    """Start ``--devices`` ranks of this command and wait for them; rank
    0's standard output becomes this process's. Raises if any rank
    failed."""
    import subprocess
    import tempfile

    import torch
    if args.device.startswith("cuda") and (
            args.devices > torch.cuda.device_count()):
        raise ValueError(f"--devices {args.devices} on cuda needs as many "
                         f"cards; {torch.cuda.device_count()} present")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="scope_rdv_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.scope", *argv,
             "--rank", str(r), "--rendezvous", os.path.join(tmp, "rdv")],
            env=env, stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
            text=True) for r in range(args.devices)]
        out, _ = procs[0].communicate()
        rcs = [procs[0].returncode] + [p.wait() for p in procs[1:]]
    sys.stdout.write(out)
    if any(rcs):
        raise RuntimeError(f"scope ranks exited with {rcs}")


def _rank_mesh(args):
    """This rank's process group (gloo on the CPU, NCCL on the card) and
    its one-axis mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    cuda = args.device.startswith("cuda")
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{args.rendezvous}",
        rank=args.rank, world_size=args.devices,
        **({"device_id": torch.device("cuda", args.rank)} if cuda else {}))
    return make_mesh((args.devices,), ("parts",), device=args.device)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    if args.backend == "shard_map" and args.rank is None:
        _launch_ranks(argv, args)
        return
    mesh = _rank_mesh(args) if args.backend == "shard_map" else None
    try:
        _report(args, *_build(args, mesh))
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _report(args, eng, tracer) -> None:
    """Run, then (on rank 0 of a mesh) print the report and write the
    files."""
    state, tele = eng.run()
    if args.rank:
        return
    from repro_torch.obs import metrics as obs_metrics

    print(f"# gopher scope — {args.algo} on {args.rows}x{args.cols} road "
          f"grid, {args.parts} parts, backend={args.backend} "
          f"device={eng.device} exchange={eng.exchange}")
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
