"""What each collective of the ``shard_map`` backend costs on a world of
one NCCL rank, at phase 4j's shapes (road_grid(1400, 1400) in 12
partitions: v_max 163,334, mailbox cap 969), beside what ``local`` does
in its place. For each operation: the host's wall time a call over 200
back-to-back calls ended by one synchronize (what the staged loop pays,
since it reads the host every superstep), and the card's time a call by
CUDA events around the same 200 calls.

    mesh: all_reduce of a scalar        PageRank's dangling mass, its delta
    mesh: halt vote                     the counters' all_reduce, then the
                                        one host read  (local: the read)
    mesh: route_shard_map (dense row)   (12, 12, 969) float32: one
                                        all_to_all_single and two copies
                                        (local: route_local, a view)
    mesh: gather of the state           (12, 163334) float32, at the end
                                        of a run (local: nothing)

With ``--pagerank`` it also runs phase 4j's 30-iteration PageRank on
'dense' at that size, on 'local' and on the mesh, once each to warm up,
then in turns (local, mesh, mesh, local, twice; ``warm_s`` each), then
once each under ``torch.profiler`` (``chip_smoke.device_breakdown``):
the card's time by kind (NCCL's kernels, the rest), its launches and its
idle share against the mean unprofiled ``warm_s``.

Prints the card's name and power limit first and one JSON line; needs a
card.

    python3 tools/mesh_collectives.py [--pagerank]
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

P, V_MAX, CAP, CALLS = 12, 163334, 969, 200


def timed(fn) -> dict:
    """Host ms and card ms a call of ``fn`` over CALLS calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    e0.record()
    for _ in range(CALLS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return {"host_ms": (time.perf_counter() - t) * 1e3 / CALLS,
            "card_ms": e0.elapsed_time(e1) / CALLS}


def pagerank(dev, mesh) -> dict:
    """Phase 4j's PageRank on 'local' and on ``mesh``, timed in turns and
    profiled (see the module docstring)."""
    import torch
    from repro_torch.core import GopherEngine, PageRankProgram
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
    prog = PageRankProgram(n_global=pg.n_global, num_iters=30)

    def run(backend):
        GopherEngine(pg, prog, backend=backend,
                     mesh=mesh if backend == "shard_map" else None,
                     exchange="dense", max_supersteps=64, device=dev).run()
    run("local")                        # builds K1; warms both
    run("shard_map")
    secs = {"local": [], "shard_map": []}
    for backend in ("local", "shard_map", "shard_map", "local", "local",
                    "shard_map", "shard_map", "local"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(backend)
        torch.cuda.synchronize()
        secs[backend].append(time.perf_counter() - t)
    return {b: {"warm_s": s, "profile": cs.device_breakdown(
        lambda: run(b), sum(s) / len(s) * 1e3, ("nccl", "nccl"))}
        for b, s in secs.items()}


def main() -> None:
    dev = cs.environment()
    import torch
    import torch.distributed as dist
    from repro_torch.core import messages as msg
    from repro_torch.core.engine import _Ranks, _stats
    from repro_torch.launch.mesh import make_mesh
    g = torch.Generator(device=dev).manual_seed(0)
    scalar = torch.rand((), device=dev, generator=g)
    counts = [torch.randint(0, 100, (), device=dev, generator=g)
              for _ in range(5)]
    slots = torch.rand((P, P, CAP), device=dev, generator=g)
    state = torch.rand((P, V_MAX), device=dev, generator=g)
    with tempfile.TemporaryDirectory(prefix="mesh_collectives_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh((1,), ("parts",), device="cuda")
            mr, lr = _Ranks(P, mesh.get_group()), _Ranks(P)
            out = {"pagerank": pagerank(dev, mesh)} \
                if "--pagerank" in sys.argv else {}
            for name, ranks in (("mesh", mr), ("local", lr)):
                out[name] = {
                    "scalar_all_reduce": timed(lambda: ranks.sum(scalar)),
                    "halt_vote": timed(
                        lambda: ranks.sum(_stats(*counts)).tolist()),
                    "route_dense_row": timed(
                        lambda: (msg.route_local(slots) if ranks.group is None
                                 else msg.route_shard_map(slots,
                                                          ranks.group))),
                    "gather_state": timed(lambda: ranks.gather(state))}
        finally:
            dist.destroy_process_group()
    print(json.dumps({"mesh_collectives": out, "calls": CALLS,
                      "shapes": {"P": P, "v_max": V_MAX, "cap": CAP}}),
          flush=True)


if __name__ == "__main__":
    main()
