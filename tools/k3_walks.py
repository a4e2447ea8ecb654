"""K3's time at CC's first superstep on the main path's graph (the
1,960,000-vertex road grid in 12 partitions) at several values of
``megastep.K3_DENSE_FRONTIER``, the share of a partition's rows at which
a sweep walks every row instead of its work list: 0 walks every sweep
densely, 2 every sweep by work list. Each value's result is held bit-equal
to the plain version first; each time is the mean of 5 back-to-back calls
by CUDA events (``chip_smoke.batch_ms``). Prints one JSON line with the
card's name and power limit, and exits 1 without a card.

    python3 tools/k3_walks.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

FRACTIONS = (0.0, 0.03125, 0.0625, 0.125, 0.25, 0.5, 2.0)


def main() -> None:
    import torch
    from repro_torch.core import SemiringProgram, graph_block, init_max_vertex
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import megastep as mega

    dev = cs.environment()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    st = SemiringProgram(semiring="max_first",
                         init_fn=init_max_vertex).init(gb)
    xs, ch, fr = (st[k].reshape(-1).contiguous()
                  for k in ("x", "changed_v", "frontier"))
    want = mega.megastep_semiring_ref(xs, ch, fr, cm, "max_first")
    saved, ms = mega.K3_DENSE_FRONTIER, {}
    try:
        for frac in FRACTIONS:
            mega.K3_DENSE_FRONTIER = frac
            got = mega.megastep_semiring_cuda(xs, ch, fr, cm, "max_first")
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    cs.fail(f"K3 at K3_DENSE_FRONTIER {frac} differs from "
                            f"the plain version")
            ms[str(frac)] = cs.batch_ms(lambda: mega.megastep_semiring_cuda(
                xs, ch, fr, cm, "max_first"), reps=5)
    finally:
        mega.K3_DENSE_FRONTIER = saved
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"k3_ms_by_K3_DENSE_FRONTIER": ms, "kept": saved,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
