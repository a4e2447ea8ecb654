"""Phase 4k of ``chip_smoke.py`` alone: the multi-device backend's service
and device-loss half on a world of one NCCL rank, at the main path's size
(the 1,960,000-vertex road grid, weighted and unit, in 12 partitions).

It builds the kernels, the graphs and phase 4f's 1 % reopened-segment
delta as ``chip_smoke.py`` does, then what phase 4k holds itself to, on
'local': phase 4g's 25-query stream through a 'local' service with its
landmarks refreshed after the delta, and compact CC, phased CC and SSSP
(``PhasedTierPlan.from_graph`` standing in for 4c's taught plan) and
dense 30-iteration PageRank (phase 4j showed each equal on one NCCL rank
to its 'local' run). Then ``chip_smoke.failover_path``: every check of
the phase, its JSON lines and the phase's wall time. Prints the card's
name and power limit first, and exits 1 without a card.

    python3 tools/failover_phase.py
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
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  PhasedTierPlan, SemiringProgram,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.gofs import (EdgeDelta, bfs_grow_partition,
                                  partition_graph, road_grid)
    from repro_torch.kernels import _build
    from repro_torch.serving import GraphQueryService
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
    delta = EdgeDelta.inserts(iu, iv, iw)

    t = time.perf_counter()
    svc = GraphQueryService({"rn": pg, "rn_unit": upg}, device=dev)
    _, stream, _ = cs.service_stream(g)
    for kind, gname, s in stream:
        svc.submit(kind, gname, s)
    t0 = time.perf_counter()
    resp = svc.drain()
    drain_s = time.perf_counter() - t0
    lc = svc.enable_landmarks("rn", cs.LANDMARKS)
    svc.apply_delta("rn", delta, rebuild_landmarks=True)
    served = {"stream": stream, "resp": resp, "drain_s": drain_s,
              "landmarks": lc.landmarks,
              "landmark_dist": svc.landmark_caches["rn"].dist}
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    plan = PhasedTierPlan.from_graph(pg)
    cc = SemiringProgram("max_first", init_max_vertex)
    runs = {"cc_compact": (cc, "compact", None),
            "cc_phased": (cc, "phased", plan),
            "sssp_phased": (SemiringProgram("min_plus", make_sssp_init(
                *loc)), "phased", plan),
            "pagerank_dense": (PageRankProgram(n_global=pg.n_global,
                                               num_iters=30), "dense", None)}
    local = {name: GopherEngine(
        pg, prog, exchange=ex, tier_plan=p, device=dev,
        **({"max_supersteps": 64} if ex == "dense" else {})).run()
        for name, (prog, ex, p) in runs.items()}
    print(json.dumps({"references_s": time.perf_counter() - t,
                      "local_drain_s": drain_s}), flush=True)

    launches = dict.fromkeys(_build.launches, 0)
    t = time.perf_counter()
    cs.failover_path(dev, pg, upg, 0, delta, served, local, plan, launches)
    print(json.dumps({"phase_4k_s": time.perf_counter() - t,
                      "failover_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
