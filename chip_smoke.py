"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, ``nvcc`` and the
checkout's ``src/`` (it imports nothing of JAX). Phases, in order; any
failure exits non-zero and prints no result:

1. environment: a CUDA card, its name and power limit from nvidia-smi;
2. build: the kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card: K1 on a
   random ELL (V = 2e6, D = 8, PAD rows, ±inf), K3 over every superstep of
   CC and SSSP on a road grid and on a powerlaw graph with hub feeds;
4. the main path at full size: CC, SSSP, BFS and 30-iteration PageRank
   through the public functions on road_grid(1400, 1400) — 1.96M vertices,
   the vertex count of the paper's RN graph — in 12 partitions, each
   checked against scipy / numpy; one JSON line per algorithm;
5. kernel times at the main path's shapes: one ``{"kernels": [...]}`` line.

Min/max results are held bit-equal; plus_times allclose (rtol=1e-6,
atol=1e-7 on the random ELL, whose values are O(1); rtol=1e-5, atol=0 at
PageRank's pull, whose values are O(1/n)). The last line is
``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SEMIRINGS = ("min_plus", "max_first", "plus_times")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(semiring: str, got, want, what: str, rtol: float = 1e-6,
            atol: float = 1e-7) -> float:
    """Hold a kernel's output against its plain version (plus_times to
    ``rtol``/``atol``); returns the max absolute error over entries finite
    in both."""
    import torch
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    if semiring in ("min_plus", "max_first", "bool"):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{what}: {bad} entries differ from the plain version")
    else:
        if not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
            fail(f"{what}: not allclose to the plain version")
    fin = np.isfinite(g) & np.isfinite(w)
    if not np.array_equal(np.isfinite(g), np.isfinite(w)):
        fail(f"{what}: non-finite entries differ")
    if g.dtype == bool or not fin.any():
        return 0.0
    return float(np.abs(g[fin].astype(np.float64) - w[fin]).max())


def gather(pg, per_part):
    """(P, v_max) -> (n,) global order."""
    out = np.zeros(pg.n_global, per_part.dtype)
    m = pg.vmask
    out[pg.global_id[m]] = per_part[m]
    return out


# ---------------- phase 1: environment ----------------

def environment():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


# ---------------- phase 3: kernels against their plain versions ----------

def check_k1(dev) -> None:
    import torch
    from repro_torch.gofs.formats import PAD
    from repro_torch.kernels.ref import semiring_spmv_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda
    rng = np.random.default_rng(0)
    v, d = 2_000_000, 8
    nbr = rng.integers(0, v, (v, d), dtype=np.int32)
    nbr[rng.random((v, d)) < 0.3] = PAD
    nbr[rng.random(v) < 0.02] = PAD                  # all-PAD rows
    wgt = rng.uniform(0.1, 2.0, (v, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, v).astype(np.float32)
    x[rng.random(v) < 0.01] = np.inf
    x[rng.random(v) < 0.01] = -np.inf
    x, nbr, wgt = (torch.from_numpy(a).to(dev) for a in (x, nbr, wgt))
    for sr in SEMIRINGS:
        got = semiring_spmv_cuda(x, nbr, wgt, sr)
        want = semiring_spmv_ref(x, nbr, wgt, sr)
        torch.cuda.synchronize()
        err = compare(sr, got, want, f"K1 {sr}")
        log(f"K1 semiring_spmv {sr}: V={v} D={d} agrees "
            f"(max_abs_err {err})")


def check_k3(dev) -> None:
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex, make_sssp_init)
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  powerlaw_social, road_grid)
    from repro_torch.kernels import megastep as mega
    cases = [("road_grid(300,300)", road_grid(300, 300, weighted=True,
                                              seed=1), 12),
             ("powerlaw_social(20000,m=5)",
              powerlaw_social(20000, m=5, seed=2), 8)]
    for gname, g, P in cases:
        pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
        gb = graph_block(pg, dev)
        cm = mega.compose_mailbox(gb)
        hubs = int(cm["hub_row_ok"].sum())
        for sr, init in (("max_first", init_max_vertex),
                         ("min_plus", make_sssp_init(int(pg.part_of[0]),
                                                     int(pg.local_of[0])))):
            st = SemiringProgram(semiring=sr, init_fn=init).init(gb)
            x, ch, fr = (st[k].reshape(-1).contiguous()
                         for k in ("x", "changed_v", "frontier"))
            steps = 0
            while bool(ch.any()) and steps < 4096:
                got = mega.megastep_semiring_cuda(x, ch, fr, cm, sr)
                want = mega.megastep_semiring_ref(x, ch, fr, cm, sr)
                torch.cuda.synchronize()
                for name, kind, a, b in zip(
                        ("x2", "changed2", "frontier_left", "liters"),
                        (sr, "bool", "bool", "max_first"), got, want):
                    compare(kind, a, b, f"K3 {gname} {sr} superstep "
                            f"{steps} {name}")
                x, ch, fr = got[:3]
                steps += 1
            log(f"K3 megastep_semiring {gname} P={P} {sr}: {steps} "
                f"supersteps bit-equal (hub feed rows {hubs})")


# ---------------- phase 4: the main path ----------------

def main_path(dev):
    import torch
    import scipy.sparse.csgraph as csgraph
    from repro_torch import algorithms
    from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                                  road_grid)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    g = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=True)
    t1 = time.perf_counter()
    assign = bfs_grow_partition(g, 12, seed=0)
    t2 = time.perf_counter()
    pg = partition_graph(g, assign, 12)
    t3 = time.perf_counter()
    # BFS runs on the unweighted build of the same grid (same edges, same
    # partition: road_grid draws the deletions before the weights)
    ug = road_grid(1400, 1400, drop_frac=0.03, seed=1, weighted=False)
    upg = partition_graph(ug, assign, 12)
    log(json.dumps({
        "graph": "road_grid(1400,1400,drop_frac=0.03,seed=1)", "n": g.n,
        "nnz": g.nnz, "parts": 12, "v_max": pg.v_max, "d_max": pg.d_max,
        "mailbox_cap": pg.mailbox_cap, "cut_edges": pg.edge_cut(),
        "host_s": {"generate": t1 - t0, "bfs_grow_partition": t2 - t1,
                   "partition_graph": t3 - t2,
                   "unweighted_build": time.perf_counter() - t3}}))
    src = 0
    runs = {
        "cc": lambda: algorithms.connected_components(pg),
        "sssp": lambda: algorithms.sssp(pg, src),
        "bfs": lambda: algorithms.bfs(upg, src),
        "pagerank": lambda: algorithms.pagerank(pg, num_iters=30),
    }
    uses = {"cc": "megastep_semiring", "sssp": "megastep_semiring",
            "bfs": "megastep_semiring", "pagerank": "semiring_spmv"}
    first = {}
    for name, fn in runs.items():                    # warm-up, not counted
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[name] = time.perf_counter() - t

    results, path_launches = {}, dict.fromkeys(_build.launches, 0)
    for name, fn in runs.items():
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(_build.launches)
        if launches[uses[name]] == 0:
            fail(f"{name}: kernel {uses[name]} was never launched")
        for k, c in launches.items():
            path_launches[k] += c
        tele = out[-1]
        results[name] = out
        log(json.dumps({
            "algorithm": name, "n": g.n, "parts": 12,
            "supersteps": tele.supersteps,
            "local_iters_sum": int(tele.local_iters.sum()),
            "first_s": first[name], "warm_s": secs, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}))

    # against scipy / numpy
    labels, ncc, _ = results["cc"]
    ncc_true, lab_true = csgraph.connected_components(g.undirected_csr(),
                                                      directed=False)
    ours = gather(pg, labels)
    if ncc != ncc_true:
        fail(f"cc: {ncc} components, scipy finds {ncc_true}")
    # same partition: each scipy component maps to one label and back
    pairs = np.unique(np.stack([lab_true, ours]), axis=1)
    if pairs.shape[1] != ncc_true:
        fail("cc: the components differ from scipy's")
    dist = gather(pg, results["sssp"][0])
    d_true = csgraph.dijkstra(g.csr().T, indices=[src])[0]
    fin = np.isfinite(d_true)
    if not np.array_equal(np.isfinite(dist), fin) or not np.allclose(
            dist[fin], d_true[fin], rtol=1e-5):
        fail("sssp: distances differ from scipy's dijkstra")
    lvl = gather(upg, results["bfs"][0])
    hops = csgraph.shortest_path(ug.undirected_csr(), unweighted=True,
                                 indices=[src])[0]
    if not np.array_equal(lvl, hops.astype(np.float32)):
        fail("bfs: hop counts differ from scipy's")
    r = gather(pg, results["pagerank"][0])
    a = g.csr()
    a.data[:] = 1.0
    outdeg = g.out_degree.astype(np.float64)
    rr = np.full(g.n, 1.0 / g.n)
    for _ in range(30):
        contrib = np.where(outdeg > 0, rr / np.maximum(outdeg, 1), 0)
        rr = 0.15 / g.n + 0.85 * (a @ contrib + rr[outdeg == 0].sum() / g.n)
    if not np.allclose(r, rr, rtol=1e-4, atol=1e-9):
        fail(f"pagerank: max abs diff {np.abs(r - rr).max()} from the "
             f"float64 power iteration")
    log(f"main path checks: cc {ncc} components, sssp {int(fin.sum())} "
        f"reached, bfs max {int(hops[np.isfinite(hops)].max())} hops, "
        f"pagerank max abs diff {np.abs(r - rr).max():.3e} — all agree")
    breakdown(pg, upg, src)
    return pg, path_launches


def breakdown(pg, upg, src):
    """Where one warm run's time goes, per algorithm: the engine's set-up
    (graph block upload and mailbox compose), then the BSP loop, and inside
    it the kernel's own device time, by CUDA events around every call of
    the superstep (K3) or of the pull (K1). The rest of the loop is the
    plain PyTorch ops around the kernel and the per-superstep halt read."""
    import torch
    from repro_torch.core import (GopherEngine, PageRankProgram,
                                  SemiringProgram, init_max_vertex,
                                  make_bfs_init, make_sssp_init)
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels import ops

    loc = (int(pg.part_of[src]), int(pg.local_of[src]))
    cases = {
        "cc": (pg, SemiringProgram("max_first", init_max_vertex), mega,
               "megastep_semiring"),
        "sssp": (pg, SemiringProgram("min_plus", make_sssp_init(*loc)),
                 mega, "megastep_semiring"),
        "bfs": (upg, SemiringProgram("min_plus", make_bfs_init(*loc)), mega,
                "megastep_semiring"),
        "pagerank": (pg, PageRankProgram(n_global=pg.n_global,
                                         num_iters=30), ops,
                     "semiring_spmv"),
    }
    for name, (graph, prog, module, attr) in cases.items():
        events = []
        kernel = getattr(module, attr)

        def timed(*args, _kernel=kernel, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _kernel(*args, **kw)
            end.record()
            events.append((start, end))
            return out

        eng = GopherEngine(graph, prog, max_supersteps=4096)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gb, cm = eng._gb_for_run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        setattr(module, attr, timed)
        try:
            _, steps, _ = eng._run_megastep(gb, cm)
            torch.cuda.synchronize()
        finally:
            setattr(module, attr, kernel)
        t2 = time.perf_counter()
        if len(events) != steps:     # one kernel call per superstep
            fail(f"breakdown {name}: {len(events)} timed kernel calls in "
                 f"{steps} supersteps: the timing hook missed the kernel")
        kernel_ms = sum(a.elapsed_time(b) for a, b in events)
        log(json.dumps({
            "breakdown": name, "setup_s": t1 - t0, "loop_s": t2 - t1,
            "supersteps": steps, "kernel_calls": len(events),
            "kernel_ms": kernel_ms,
            "kernel_share_of_loop": kernel_ms / 1e3 / (t2 - t1)}))


# ---------------- phase 5: kernel times at the main path's shapes --------

def kernel_times(dev, pg, path_launches):
    import torch
    from repro_torch.core import (SemiringProgram, graph_block,
                                  init_max_vertex)
    from repro_torch.kernels import megastep as mega
    from repro_torch.kernels.ref import semiring_spmv_ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda

    gb = graph_block(pg, dev)
    cm = mega.compose_mailbox(gb)
    n, d = cm["nbr"].shape

    # K1 at PageRank's pull: plus_times over the flat PAD-filled adjacency;
    # the outputs are O(1/n), so the check is relative only
    deg = gb["out_degree"].reshape(-1).float()
    r0 = torch.where(cm["vmask"], 1.0 / pg.n_global, 0.0)
    x = torch.where(deg > 0, r0 / deg.clamp(min=1.0), 0.0).contiguous()
    nbr, ones = cm["nbr"], mega.unit_weights(cm)
    got = semiring_spmv_cuda(x, nbr, ones, "plus_times")
    want = semiring_spmv_ref(x, nbr, ones, "plus_times")
    k1_err = compare("plus_times", got, want, "K1 at the main path",
                     rtol=1e-5, atol=0.0)
    k1_ms = cuda_ms(lambda: semiring_spmv_cuda(x, nbr, ones, "plus_times"))
    k1_plain = cuda_ms(lambda: semiring_spmv_ref(x, nbr, ones, "plus_times"))
    ok = nbr >= 0
    rows = torch.arange(n, device=dev).repeat_interleave(ok.sum(1))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[ok].long()]), ones[ok],
        (n, n)).coalesce().to_sparse_csr()
    xcol = x.reshape(-1, 1)
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, xcol))
    k1_bytes = n * d * 8 + n * 8
    k1_ops = 2 * n * d
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S) * 1e3

    # K3 at CC's first superstep (the widest: every vertex is in the
    # frontier and the fixpoint runs its longest). max_first reads no edge
    # weights, so the bound counts none
    st = SemiringProgram(semiring="max_first",
                         init_fn=init_max_vertex).init(gb)
    xs, ch, fr = (st[k].reshape(-1).contiguous()
                  for k in ("x", "changed_v", "frontier"))
    got = mega.megastep_semiring_cuda(xs, ch, fr, cm, "max_first")
    want = mega.megastep_semiring_ref(xs, ch, fr, cm, "max_first")
    torch.cuda.synchronize()
    k3_err = compare("max_first", got[0], want[0], "K3 at the main path x2")
    for a, b, what in zip(got[1:], want[1:],
                          ("changed2", "frontier_left", "liters")):
        compare("bool" if what != "liters" else "max_first", a, b,
                f"K3 at the main path {what}")
    sweeps = int(got[3].max())
    k3_ms = cuda_ms(lambda: mega.megastep_semiring_cuda(
        xs, ch, fr, cm, "max_first"), reps=3)
    k3_plain = cuda_ms(lambda: mega.megastep_semiring_ref(
        xs, ch, fr, cm, "max_first"), reps=3)
    m_lo = cm["lo_src"].shape[1]
    m_hi = cm["hub_src"].shape[1]
    hub_rows = int(cm["hub_row_ok"].sum())
    # a sweep reads every lane's index (n·D·4) and each row's x (4), writes
    # x and f (4 + 1) and reads vmask (1); gathered x and f sit in L2
    per_sweep = n * d * 4 + n * 10
    once = (n * m_lo * 5 + hub_rows * (4 + m_hi * 5)  # lo maps, hub rows
                                                     # (src 4 + ok 1 a lane)
            + n * (4 + 1 + 1 + 1 + 1)            # x, changed, frontier,
                                                 # vmask, hub_row_ok
            + n * (4 + 1 + 1) + 4 * pg.num_parts)  # outputs
    k3_bytes = once + sweeps * per_sweep
    k3_ops = sweeps * n * d * 2
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_OPS_PER_S) * 1e3
    log(f"K3 at CC superstep 0: n={n} D={d} sweeps={sweeps} "
        f"bytes/sweep={per_sweep} bound/sweep "
        f"{per_sweep / HBM_BYTES_PER_S * 1e3:.4f} ms, kernel "
        f"{k3_ms / max(sweeps, 1):.4f} ms/sweep")

    return {"kernels": [
        {"name": "semiring_spmv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/semiring_spmv.cu",
         "replaces": "src/repro/kernels/semiring_spmv.py:125",
         "launches": path_launches["semiring_spmv"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": lib_ms},
        {"name": "megastep_semiring", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/megastep.cu",
         "replaces": "src/repro/kernels/megastep.py:622",
         "launches": path_launches["megastep_semiring"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": "bytes", "library_ms": None},
    ]}


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    dev = environment()
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build(verbose=True)       # prints ptxas' registers and spills
    _build.library()
    log(f"build: {time.perf_counter() - t:.1f}s")
    check_k1(dev)
    check_k3(dev)
    pg, path_launches = main_path(dev)
    kernels = kernel_times(dev, pg, path_launches)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
