"""Phase 4h of ``chip_smoke.py`` alone: checkpointing and resilience at the
main path's size (the 1,960,000-vertex road grid in 12 partitions). It
builds the kernels and the graph as ``chip_smoke.py`` does, runs the
references 4h is held to — phase 4a's fused CC and SSSP, phase 4b's
compact CC and 30-iteration dense PageRank, each once — then
``chip_smoke.checkpoint_path``: every check of the phase, its JSON lines
(the checkpointed and recovered runs, the snapshots' bytes and the save
and restore seconds, the straggler's ``part_seconds``, the chaos
scenarios) and the phase's wall time. Prints the card's name and power
limit first, and exits 1 without a card.

    python3 tools/checkpoint_phase.py
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
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex)
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import _build
    _build.build()
    _build.library()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    src = 0
    fused = {"cc": algorithms.connected_components(pg),
             "sssp": algorithms.sssp(pg, src)}
    staged = {
        "cc_compact": GopherEngine(
            pg, SemiringProgram("max_first", init_max_vertex),
            exchange="compact").run(),
        "pagerank_dense": GopherEngine(
            pg, PageRankProgram(n_global=pg.n_global, num_iters=30),
            exchange="dense", max_supersteps=64).run()}
    launches = dict.fromkeys(_build.launches, 0)
    t = time.perf_counter()
    cs.checkpoint_path(dev, pg, src, fused, staged, launches)
    print(json.dumps({"phase_4h_s": time.perf_counter() - t,
                      "checkpoint_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
