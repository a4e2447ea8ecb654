"""Phase 4i of ``chip_smoke.py`` alone: the tracer, the traced stepped
driver and the metrics registry at the main path's size (the
1,960,000-vertex road grid in 12 partitions). It builds the kernels and
the graph as ``chip_smoke.py`` does, runs the references 4i is held to —
phase 4a's fused CC and SSSP and phase 4b's compact CC, each once — and,
in place of phase 4g's service, a service over a 60 x 60 road grid with
its own registry serving a few queries (4i reads only a service's
registry and stats), then ``chip_smoke.observability_path``: every check
of the phase, its ``scope`` line (span totals, traced beside untraced
``warm_s``) and its ``observability`` line. Prints the card's name and
power limit first, and exits 1 without a card.

    python3 tools/observability_phase.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> None:
    dev = cs.environment()
    from repro_torch import algorithms
    from repro_torch.core import GopherEngine, SemiringProgram, init_max_vertex
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import GraphQueryService
    _build.build()
    _build.library()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    src = 0
    fused = {"cc": algorithms.connected_components(pg),
             "sssp": algorithms.sssp(pg, src)}
    staged = {"cc_compact": GopherEngine(
        pg, SemiringProgram("max_first", init_max_vertex),
        exchange="compact").run()}
    sg = road_grid(60, 60, drop_frac=0.05, seed=2)
    spg = partition_graph(sg, bfs_grow_partition(sg, 6, seed=0), 6)
    svc = GraphQueryService({"g": spg}, metrics=MetricsRegistry(), device=dev)
    for kind, s in (("bfs", 0), ("sssp", 7), ("bfs", 0), ("sssp", 10 ** 6)):
        svc.submit(kind, "g", s)
    svc.drain()
    svc.query("bfs", "g", 0)
    launches = dict.fromkeys(_build.launches, 0)
    t = time.perf_counter()
    cs.observability_path(dev, pg, src, fused, staged, svc, launches)
    print(json.dumps({"phase_4i_s": time.perf_counter() - t,
                      "observability_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
