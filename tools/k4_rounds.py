"""K4, the resident loop, at the main path's size (the 1,960,000-vertex
road grid in 12 partitions) from CC's and SSSP's init states: its device
time, where that time goes (the kernel's phase timer: the set-up, the
deliveries and the sweeps, each with the wait at its grid-wide barrier),
the work the plain loop does round by round (``chip_smoke.k4_work``: the
send set, the rows delivered to, the frontier, the rows with an active
in-neighbour) and K4's bound from it (``chip_smoke.k4_bound``). With
``--walks``, also K4's time at several values of
``megastep.K4_DENSE_FRONTIER``, the share of all rows at which a round's
sweep walks every row instead of its work list (0: every round dense, 2:
every round by work list), each the mean of 3 back-to-back calls by CUDA
events (``chip_smoke.batch_ms``). Every K4 result is held bit-equal to the
plain loop first. With ``--out PATH``, writes the per-round counts there
as JSON. Prints one JSON line a run with the card's name and power
limit, and exits 1 without a card.

    python3 tools/k4_rounds.py [--walks] [--out PATH]
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

FRACTIONS = (0.0, 0.015625, 0.03125, 0.0625, 0.125, 0.25, 0.5, 2.0)


def main() -> None:
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import megastep as mega

    ap = argparse.ArgumentParser()
    ap.add_argument("--walks", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    dev = cs.environment()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    n = cm["n"]
    width = mega.k3_lanes(cm, "max_first")[0].shape[1]
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    per_round = {}
    for algo, sr, init in (("cc", "max_first", init_max_vertex),
                           ("sssp", "min_plus", make_sssp_init(*loc))):
        st = SemiringProgram(semiring=sr, init_fn=init).init(gb)
        start = tuple(st[k].reshape(-1).contiguous()
                      for k in ("x", "changed_v", "frontier"))
        counts, want = cs.k4_work(cm, *start, sr)

        def held(what):
            got = mega.resident_megastep_cuda(*start, cm, sr, 4096)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    cs.fail(f"K4 {algo} {what} differs from the plain loop")

        held("")
        phase = torch.zeros(3, dtype=torch.int64, device=dev)
        mega.resident_megastep_cuda(*start, cm, sr, 4096, phase_ns=phase)
        torch.cuda.synchronize()
        split = (phase.cpu().numpy() / 1e6).tolist()
        ms = cs.device_ms(lambda: mega.resident_megastep_cuda(
            *start, cm, sr, 4096), "resident_kernel", reps=2)
        bound, dense = cs.k4_bound(cm, counts, sr, width)
        by_frac = {}
        if args.walks:
            saved = mega.K4_DENSE_FRONTIER
            try:
                for frac in FRACTIONS:
                    mega.K4_DENSE_FRONTIER = frac
                    held(f"at K4_DENSE_FRONTIER {frac}")
                    by_frac[str(frac)] = cs.batch_ms(
                        lambda: mega.resident_megastep_cuda(
                            *start, cm, sr, 4096), reps=3)
            finally:
                mega.K4_DENSE_FRONTIER = saved
        rounds = len(counts["active"])
        per_round[algo] = {k: v.tolist() for k, v in counts.items()}
        print(json.dumps({
            "k4_rounds": algo, "rounds": rounds, "n": n, "ms": ms,
            "ms_per_round": ms / rounds,
            "phase_ms": dict(zip(("setup", "deliveries", "sweeps"), split)),
            "bound_ms": bound, "bound_dense_ms": dense,
            "share_of_bound": bound / ms, "share_of_dense": dense / ms,
            "feed_rows": mega.feed_rows(cm).numel(), "lanes": width,
            "mean_share": {k: float(v.mean() / n)
                           for k, v in counts.items() if k != "feed_bytes"},
            "rounds_frontier_over_n_8": int((counts["frontier"]
                                             > n / 8).sum()),
            "rounds_active_over_n_8": int((counts["active"] > n / 8).sum()),
            "ms_by_K4_DENSE_FRONTIER": by_frac,
            "K4_DENSE_FRONTIER": mega.K4_DENSE_FRONTIER, "card": card}),
            flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(per_round))


if __name__ == "__main__":
    main()
