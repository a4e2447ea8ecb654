"""Phase 4g of ``chip_smoke.py`` alone: Gopher Serve at the main path's
size (the 1,960,000-vertex road grid, weighted and unit, in 12
partitions), with phase 4f's 1 % reopened-segment delta for the landmark
refresh. It builds the kernels (the scalar runs the batches are held to
take K3), the graphs and the delta as ``chip_smoke.py`` does, then runs
``chip_smoke.serving_path``: every check of the phase, its JSON lines (the
batches' sweeps and ms a sweep, the profiled batch, the service, the
landmarks, one sweep's time at Q 4 / 8 / 16) and the phase's wall time.
Prints the card's name and power limit first, and exits 1 without a card.

    python3 tools/serving_phase.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    dev = cs.environment()
    from repro_torch.gofs import (EdgeDelta, bfs_grow_partition,
                                  partition_graph, road_grid)
    from repro_torch.kernels import _build
    _build.build()
    _build.library()
    side = 1400
    g = road_grid(side, side, drop_frac=0.03, seed=1, weighted=True)
    assign = bfs_grow_partition(g, 12, seed=0)
    pg = partition_graph(g, assign, 12)
    ug = road_grid(side, side, drop_frac=0.03, seed=1, weighted=False)
    upg = partition_graph(ug, assign, 12)
    iu, iv = cs.reopened_edges(g, side, side, (g.nnz // 2) // 100, seed=7)
    iw = np.random.default_rng(8).uniform(5.0, 10.0, iu.size) \
        .astype(np.float32)
    launches = dict.fromkeys(_build.launches, 0)
    t = time.perf_counter()
    cs.serving_path(dev, g, ug, pg, upg, EdgeDelta.inserts(iu, iv, iw),
                    launches)
    print(json.dumps({"phase_4g_s": time.perf_counter() - t,
                      "serving_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
