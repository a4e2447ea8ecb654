"""Phase 4m of ``chip_smoke.py`` alone: Gopher Sentinel on the card.

It builds phase 4's graph (road_grid(1400, 1400, drop_frac=0.03,
weighted), 12 partitions) and 4c's taught phased plan (from one compact
CC run, as phase 4c teaches it), then runs ``chip_smoke.sentinel_path``:
Passes 2 and 3 clean; the fused CC and SSSP with ``validate=True``
recording no collective, bit-equal to unvalidated runs with the same K3
launches; on a world of one NCCL rank the staged compact CC, phased CC and
30-iteration PageRank validated, bit-equal to unvalidated runs with equal
Telemetry and K2/K5/K1 launches; the sentinel CLI's quick matrix on the
card. Without phases 4a-4c the unvalidated runs here are the only
reference. Prints the card's name and power limit first, the phase's
lines, then one ``sentinel_launches`` line; exits 1 without a card.

    python3 tools/sentinel_phase.py
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
    from repro_torch.core import (GopherEngine, PhasedTierPlan,
                                  SemiringProgram, host_graph_block,
                                  init_max_vertex, update_changed_profile,
                                  update_profile)
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import _build
    _build.build()
    _build.library()
    t = time.perf_counter()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    _, tc = GopherEngine(pg, SemiringProgram("max_first", init_max_vertex),
                         exchange="compact", device=dev).run()
    hb = host_graph_block(pg)
    update_profile(hb, tc.pair_slots, tc.pair_rounds)
    update_changed_profile(hb, tc.count_hist)
    taught = PhasedTierPlan.from_block(hb)
    cs.log(json.dumps({"sentinel_setup_s": time.perf_counter() - t}))
    launches = dict.fromkeys(_build.launches, 0)
    cs.sentinel_path(dev, pg, 0, None, None, taught, launches)
    print(json.dumps({"sentinel_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
