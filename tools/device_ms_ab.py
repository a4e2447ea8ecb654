"""Hold ``chip_smoke.device_ms`` against the helper it replaced, on the
same yardsticks in one process: K1's library call (``torch.sparse.mm``
over the main path's adjacency), K7's library call (SDPA at llama3-8b's
prefill shape) and K3 at CC's first superstep on the main path's graph.

The earlier helper traced one window of ``reps`` calls and, with
``kernel=None``, took a trace only where every kernel name showed a whole
multiple of ``reps`` launches. The current one traces a second window
after a discarded warm-up window and, with ``kernel=None``, takes a trace
whose counts are at most max(2, reps/10) short of a whole multiple, using
each name's mean time a launch. Each yardstick is read earlier, current,
current, earlier, and by CUDA events around back-to-back calls
(``chip_smoke.batch_ms``, no profiler) as a third reading. Prints one JSON
line with the readings and the card's name and power limit, and exits 1
without a card.

    python3 tools/device_ms_ab.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def device_ms_earlier(fn, kernel=None, reps: int = 20, traces: int = 5):
    """The helper as it was before the warm-up window, returning None where
    it refused every trace (it failed the run there)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(evt.count, evt.device_time_total / 1e3)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and (kernel is None or kernel in evt.key)]
        launches, ms = sum(c for c, _ in hits), sum(t for _, t in hits)
        if kernel is not None and launches:
            return ms / launches
        if kernel is None and launches \
                and all(c % reps == 0 for c, _ in hits):
            return ms / reps
    return None


def readings(fn, kernel=None, reps: int = 20) -> dict:
    order = (device_ms_earlier, cs.device_ms, cs.device_ms,
             device_ms_earlier)
    got = [helper(fn, kernel, reps=reps) for helper in order]
    return {"earlier": [got[0], got[3]], "current": [got[1], got[2]],
            "events_batch_ms": cs.batch_ms(fn, reps=reps)}


def main() -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.core import SemiringProgram, graph_block, init_max_vertex
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import flat
    from repro_torch.kernels import megastep as mega

    dev = cs.environment()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 12, seed=0), 12)
    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    n = cm["nbr"].shape[0]
    out = {}

    # K1's yardstick, built as chip_smoke's phase 5 builds it
    deg = gb["out_degree"].reshape(-1).float()
    r0 = torch.where(cm["vmask"], 1.0 / pg.n_global, 0.0)
    x = torch.where(deg > 0, r0 / deg.clamp(min=1.0), 0.0).contiguous()
    nbr, ones = cm["nbr"], flat.unit_weights(cm)
    ok = nbr >= 0
    rows = torch.arange(n, device=dev).repeat_interleave(ok.sum(1))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[ok].long()]), ones[ok],
        (n, n)).coalesce().to_sparse_csr()
    xcol = x.reshape(-1, 1)
    out["k1_library_sparse_mm"] = readings(lambda: torch.sparse.mm(csr, xcol))

    # K3 at CC's first superstep, by kernel name as phase 5 reads it
    st = SemiringProgram(semiring="max_first",
                         init_fn=init_max_vertex).init(gb)
    xs, ch, fr = (st[k].reshape(-1).contiguous()
                  for k in ("x", "changed_v", "frontier"))
    out["k3_megastep_kernel"] = readings(
        lambda: mega.megastep_semiring_cuda(xs, ch, fr, cm, "max_first"),
        "megastep_kernel", reps=3)
    del csr, xcol, cm, gb
    torch.cuda.empty_cache()

    # K7's yardstick: SDPA at llama3-8b's prefill shape
    what, B, Sq, Sk, H, KV, dh, win, off, dt = cs.K7_CHECKS[0]
    q, k, v = cs.attention_inputs(dev, 0, B, Sq, Sk, H, KV, dh, dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["k7_library_sdpa"] = readings(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    out["k7_library_sdpa"]["shape"] = what

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device_ms_ab": out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
