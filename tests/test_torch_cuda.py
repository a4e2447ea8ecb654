"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Min/max results are bit-equal; plus_times is allclose (rtol=1e-6,
atol=1e-7) because the kernel sums lanes in another order.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import algorithms
from repro_torch.core import (GopherEngine, PhasedTierPlan, SemiringProgram,
                              Telemetry, graph_block, init_max_vertex,
                              make_sssp_init)
from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                              powerlaw_social, road_grid)
from repro_torch.gofs.formats import PAD
from repro_torch.kernels import _build
from repro_torch.kernels import megastep as mega
from repro_torch.kernels.outbox_compact import (k5_layout,
                                                outbox_compact_plan_cuda,
                                                outbox_pack_cuda)
from repro_torch.kernels.ref import (outbox_compact_plan_ref, outbox_pack_ref,
                                     semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import (semiring_spmv_cuda,
                                               semiring_spmv_frontier_cuda)
from _patched_versions import patched_versions, resume_all

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("semiring", ["min_plus", "max_first", "plus_times"])
def test_k1_semiring_spmv_matches_plain(cuda_device, semiring):
    rng = np.random.default_rng(2)
    v, d = 5000, 8
    nbr = rng.integers(0, v, (v, d)).astype(np.int32)
    nbr[rng.random((v, d)) < 0.3] = PAD
    nbr[:40] = PAD                                   # all-PAD rows
    wgt = rng.uniform(0.1, 2.0, (v, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, v).astype(np.float32)
    x[::97] = np.inf
    x[::89] = -np.inf
    x, nbr, wgt = (torch.from_numpy(a).to(cuda_device) for a in (x, nbr, wgt))
    before = _build.launches["semiring_spmv"]
    got = semiring_spmv_cuda(x, nbr, wgt, semiring)
    want = semiring_spmv_ref(x, nbr, wgt, semiring)
    torch.cuda.synchronize()
    assert _build.launches["semiring_spmv"] == before + 1
    if semiring == "plus_times":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("semiring", ["max_first", "min_plus"])
def test_k3_megastep_matches_plain(cuda_device, semiring, unroll):
    """Every superstep of a run on a graph with hub feed rows."""
    g = powerlaw_social(3000, m=5, seed=2)
    pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    assert bool(cm["hub_row_ok"].any())
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
    x, ch, fr = (st[k].reshape(-1).contiguous()
                 for k in ("x", "changed_v", "frontier"))
    for _ in range(50):
        got = mega.megastep_semiring_cuda(x, ch, fr, cm, semiring, unroll)
        want = mega.megastep_semiring_ref(x, ch, fr, cm, semiring, unroll)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        x, ch, fr = got[:3]
        if not bool(ch.any()):
            break
    assert not bool(ch.any())


def _frontier_sizes(cm, x, ch, fr, semiring):
    """The plain superstep's frontier size per partition at each sweep of
    its fixpoint, from the state (x, ch, fr): a list of (P,) arrays."""
    from repro_torch.kernels import flat
    sizes = []

    def sweep(xc, f, nbr, wgt, sr):
        sizes.append(f.reshape(cm["num_parts"], -1).sum(dim=1).cpu().numpy())
        return semiring_spmv_frontier_ref(xc, f, nbr, wgt, sr)

    combine = flat.idempotent_combine(semiring)
    vm = cm["vmask"]
    inbox = mega.deliver_flat(x, ch, cm, combine, semiring == "min_plus")
    x1 = flat.combine_ew(combine, x, inbox)
    flat.local_fixpoint(x1, fr | ((x1 != x) & vm), cm, vm, cm["num_parts"],
                        semiring, sweep=sweep)
    return sizes


# (name, graph, P, semirings, K3_DENSE_FRONTIER or None, unroll)
K3_CLUSTER_CASES = [
    ("one partition", lambda: road_grid(80, 80, seed=1, weighted=True), 1,
     ("max_first", "min_plus"), None, 1),
    ("clusters loop over 40 partitions",
     lambda: road_grid(300, 300, seed=1, weighted=True), 40,
     ("max_first", "min_plus"), None, 1),
    ("every sweep dense", lambda: road_grid(120, 120, seed=4, weighted=True),
     6, ("max_first", "min_plus"), 0.0, 1),
    ("every sweep by work list",
     lambda: road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), 2.0, 1),
    ("the walks switch mid-fixpoint",
     lambda: road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), 0.05, 1),
    ("unroll 3", lambda: road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), None, 3),
    ("unreachable rows stay +inf",
     lambda: road_grid(120, 120, drop_frac=0.35, seed=4, weighted=True), 6,
     ("min_plus",), None, 1),
    ("hub rows by work list", lambda: powerlaw_social(3000, m=5, seed=2), 4,
     ("max_first", "min_plus"), 2.0, 1),
]


@pytest.mark.parametrize("case", range(len(K3_CLUSTER_CASES)),
                         ids=[c[0] for c in K3_CLUSTER_CASES])
def test_k3_cluster_cases_match_plain(cuda_device, monkeypatch, case):
    """Every superstep of a run, bit for bit against the plain version,
    with one K3 launch a call: one partition, more partitions than the
    clusters the card holds, each walk forced through the wrapper's
    constant and a switch between them inside a fixpoint, unroll 3, and
    SSSP rows no path reaches. (P = 12 at the main path's 1.96M vertices
    is checked by chip_smoke.py.)"""
    name, make, P, semirings, frac, unroll = K3_CLUSTER_CASES[case]
    if frac is not None:
        monkeypatch.setattr(mega, "K3_DENSE_FRONTIER", frac)
    g = make()
    pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    for semiring in semirings:
        shape = mega.k3_cluster_shape(P, semiring, cuda_device)
        assert 1 <= shape["clusters"] <= P
        if P == 40:
            assert shape["clusters"] < P        # clusters take turns
        init = (init_max_vertex if semiring == "max_first"
                else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
        st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
        x, ch, fr = (st[k].reshape(-1).contiguous()
                     for k in ("x", "changed_v", "frontier"))
        if name == "the walks switch mid-fixpoint":
            rows = mega.k3_dense_rows(cm["v_max"])
            sizes = np.stack(_frontier_sizes(cm, x, ch, fr, semiring))
            assert ((sizes >= rows).any(axis=0)
                    & ((sizes > 0) & (sizes < rows)).any(axis=0)).any()
        steps = 0
        while bool(ch.any()):
            before = _build.launches["megastep_semiring"]
            got = mega.megastep_semiring_cuda(x, ch, fr, cm, semiring, unroll)
            want = mega.megastep_semiring_ref(x, ch, fr, cm, semiring, unroll)
            torch.cuda.synchronize()
            assert _build.launches["megastep_semiring"] == before + 1
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_), (semiring, steps)
            x, ch, fr = got[:3]
            steps += 1
            assert steps < 4096
        if name == "unreachable rows stay +inf":
            assert bool(torch.isinf(x[cm["vmask"]]).any())


@pytest.mark.parametrize("max_steps", [4096, 2])
@pytest.mark.parametrize("semiring", ["max_first", "min_plus"])
def test_k4_resident_megastep_matches_plain(cuda_device, semiring,
                                            max_steps):
    """K4 from the init state and after one K3 superstep, on a graph with
    hub feed rows; ``max_steps=2`` cuts the loop before it quiesces."""
    g = powerlaw_social(3000, m=5, seed=2)
    pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
    x, ch, fr = (st[k].reshape(-1).contiguous()
                 for k in ("x", "changed_v", "frontier"))
    after = mega.megastep_semiring_cuda(x, ch, fr, cm, semiring)[:3]
    for start, (x, ch, fr) in enumerate(((x, ch, fr), after)):
        before = _build.launches["resident_megastep"]
        got = mega.resident_megastep_cuda(x, ch, fr, cm, semiring, max_steps)
        want = mega.resident_megastep_ref(x, ch, fr, cm, semiring, max_steps)
        torch.cuda.synchronize()
        assert _build.launches["resident_megastep"] == before + 1
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        rounds, quiet = int(got[3]), not bool(got[1].any())
        assert rounds <= max_steps and (rounds == max_steps or quiet)
        if max_steps == 2 and start == 0:
            assert rounds == 2 and not quiet      # the cut from init
        if max_steps > 2:
            assert quiet


# (name, graph, P, semirings, K4_DENSE_FRONTIER or None)
K4_CASES = [
    ("one partition", lambda: road_grid(80, 80, seed=1, weighted=True), 1,
     ("max_first", "min_plus"), None),
    ("40 partitions", lambda: road_grid(300, 300, seed=1, weighted=True), 40,
     ("max_first", "min_plus"), None),
    ("every sweep dense", lambda: road_grid(120, 120, seed=4, weighted=True),
     6, ("max_first", "min_plus"), 0.0),
    ("every sweep by work list",
     lambda: road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), 2.0),
    ("the walks switch mid-run",
     lambda: road_grid(120, 120, seed=4, weighted=True), 6,
     ("max_first", "min_plus"), None),
    ("hub feed rows", lambda: powerlaw_social(3000, m=5, seed=2), 4,
     ("max_first", "min_plus"), None),
    ("hub feed rows by work list", lambda: powerlaw_social(3000, m=5, seed=2),
     4, ("max_first", "min_plus"), 2.0),
    ("unreachable rows stay +inf",
     lambda: road_grid(120, 120, drop_frac=0.35, seed=4, weighted=True), 6,
     ("min_plus",), None),
]


def _resident_frontier_sizes(cm, x, ch, fr, semiring):
    """The plain resident loop's frontier size after each round's
    delivery, from the state (x, ch, fr): an array, one entry a round."""
    from repro_torch.kernels import flat
    combine = flat.idempotent_combine(semiring)
    sizes = []
    while bool(ch.any()):
        inbox = mega.deliver_flat(x, ch, cm, combine, semiring == "min_plus")
        x1 = flat.combine_ew(combine, x, inbox)
        sizes.append(int((fr | ((x1 != x) & cm["vmask"])).sum()))
        x, ch, fr, _ = mega.resident_step_semiring(x, ch, fr, cm, semiring)
    return np.array(sizes)


@pytest.mark.parametrize("case", range(len(K4_CASES)),
                         ids=[c[0] for c in K4_CASES])
def test_k4_cases_match_plain(cuda_device, monkeypatch, case):
    """K4 against the plain loop at every exit — max_steps 0, 1, 2, 7, one
    round short of quiescence, at it, and 4096 — from the init state and
    after one K3 superstep, one K4 launch a call: one partition, 40
    partitions, each of its two walks forced through the wrapper's
    constant and the constant at which they switch mid-run, hub feed rows
    (also by work list), and SSSP rows no path reaches. (P = 12 at the main
    path's 1.96M vertices is checked by chip_smoke.py.)"""
    name, make, P, semirings, frac = K4_CASES[case]
    if frac is not None:
        monkeypatch.setattr(mega, "K4_DENSE_FRONTIER", frac)
    g = make()
    pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    if name.startswith("hub"):
        assert bool(cm["hub_row_ok"][mega.feed_rows(cm).long()].any())
    rows = mega.k4_dense_rows(cm["n"])
    for semiring in semirings:
        init = (init_max_vertex if semiring == "max_first"
                else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
        st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
        start = tuple(st[k].reshape(-1).contiguous()
                      for k in ("x", "changed_v", "frontier"))
        after = mega.megastep_semiring_cuda(*start, cm, semiring)[:3]
        for begin, state in (("init", start), ("after one K3", after)):
            if name == "the walks switch mid-run" and begin == "init":
                sizes = _resident_frontier_sizes(cm, *state, semiring)
                assert (sizes >= rows).any()
                assert ((sizes > 0) & (sizes < rows)).any()
            rounds = int(mega.resident_megastep_ref(*state, cm, semiring,
                                                    4096)[3])
            for max_steps in sorted({0, 1, 2, 7, max(rounds - 1, 0), rounds,
                                     4096}):
                before = _build.launches["resident_megastep"]
                got = mega.resident_megastep_cuda(*state, cm, semiring,
                                                  max_steps)
                want = mega.resident_megastep_ref(*state, cm, semiring,
                                                  max_steps)
                torch.cuda.synchronize()
                assert _build.launches["resident_megastep"] == before + 1
                for g_, w_ in zip(got, want):
                    assert torch.equal(g_, w_), (semiring, begin, max_steps)
                assert int(got[3]) == min(max_steps, rounds)
            if name == "unreachable rows stay +inf":
                assert bool(torch.isinf(got[0][cm["vmask"]]).any())


@pytest.mark.parametrize("semiring", ["max_first", "min_plus"])
def test_k4_feed_row_outside_vmask_matches_plain(cuda_device, semiring):
    """A feed row outside vmask that its neighbours list: a delivery that
    changes it reaches no frontier, so no sweep rewrites it, and K4 writes
    it into both of its (x, stamp) arrays."""
    g = road_grid(120, 120, seed=4, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 6, seed=0), 6)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    feed = mega.feed_rows(dict(cm))
    v = int(feed[torch.isin(feed, cm["nbr"])][0])
    cm["nbr"], cm["vmask"] = cm["nbr"].clone(), cm["vmask"].clone()
    cm["nbr"][v], cm["vmask"][v] = PAD, False
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(gb)
    x, ch, fr = (st[k].reshape(-1).contiguous()
                 for k in ("x", "changed_v", "frontier"))
    for max_steps in (1, 7, 4096):
        got = mega.resident_megastep_cuda(x, ch, fr, cm, semiring, max_steps)
        want = mega.resident_megastep_ref(x, ch, fr, cm, semiring, max_steps)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), max_steps
    assert bool(got[0][v] != x[v])


def test_k4_phase_timer_reports_each_phase(cuda_device):
    """``phase_ns`` receives K4's own timing of its set-up, deliveries and
    sweeps (tools/k4_rounds.py reads it), and leaves the results alone."""
    g = road_grid(120, 120, seed=4, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 6, seed=0), 6)
    gb = graph_block(pg, cuda_device)
    cm = mega.compose_mailbox(gb)
    st = SemiringProgram(semiring="max_first",
                         init_fn=init_max_vertex).init(gb)
    x, ch, fr = (st[k].reshape(-1).contiguous()
                 for k in ("x", "changed_v", "frontier"))
    phase = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    got = mega.resident_megastep_cuda(x, ch, fr, cm, "max_first", 4096,
                                      phase_ns=phase)
    end.record()
    torch.cuda.synchronize()
    want = mega.resident_megastep_cuda(x, ch, fr, cm, "max_first", 4096)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    ns = phase.cpu().numpy()
    assert (ns > 0).all()
    assert ns.sum() / 1e6 <= start.elapsed_time(end)


@pytest.mark.parametrize("semiring", ["max_first", "min_plus"])
def test_engine_resident_mode_is_one_k4_launch(cuda_device, semiring):
    """exchange='megastep' with a PhasedTierPlan that fits the resident
    gate: the whole run is ONE K4 launch, with the CPU run's results,
    supersteps and sweeps."""
    g = powerlaw_social(3000, m=5, seed=2)
    pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    prog = SemiringProgram(semiring=semiring, init_fn=init)
    plan = PhasedTierPlan.from_graph(pg)
    _build.reset_launches()
    s, t = GopherEngine(pg, prog, exchange="megastep", tier_plan=plan,
                        device=cuda_device).run()
    assert _build.launches["resident_megastep"] == 1
    assert _build.launches["megastep_semiring"] == 0
    sc, tc = GopherEngine(pg, prog, exchange="megastep", tier_plan=plan,
                          device="cpu").run()
    assert np.array_equal(s["x"], sc["x"])
    assert t.supersteps == tc.supersteps
    assert np.array_equal(t.local_iters, tc.local_iters)


# ---------------- resumed runs on patched blocks (K3, K4) ----------------

PATCHED_GRAPHS = {
    "road": (lambda: road_grid(60, 60, seed=4, weighted=True), 6),
    "powerlaw": (lambda: powerlaw_social(3000, m=5, seed=2), 4),
}
_PATCHED = {}


def _patched_reference(graph, route):
    """The versions of one graph, the CPU's resumes of them on ``route``
    and its cold CC and SSSP runs on each version, made once a module."""
    if graph not in _PATCHED:
        make, P = PATCHED_GRAPHS[graph]
        versions = patched_versions(make(), P)
        colds = [r for res in versions[1:] for r in (
            algorithms.connected_components(res.pg, device="cpu")[0],
            algorithms.sssp(res.pg, 0, device="cpu")[0])]
        _PATCHED[graph] = (versions, colds)
    versions, colds = _PATCHED[graph]
    if (graph, route) not in _PATCHED:
        _PATCHED[graph, route] = resume_all(
            *versions, "cpu", exchange="megastep", resident=route == "k4")
    return versions, _PATCHED[graph, route], colds


@pytest.mark.parametrize("walk", [None, "dense", "list"])
@pytest.mark.parametrize("route", ["k3", "k4"])
@pytest.mark.parametrize("graph", sorted(PATCHED_GRAPHS))
def test_incremental_resume_on_patched_blocks_matches_cpu(
        cuda_device, monkeypatch, graph, route, walk):
    """Resumed CC and SSSP on the card, on blocks patched with mid-row PAD
    holes, a hub promotion and a grown cap, equal the port's CPU run of the
    same resumes (results, supersteps, local_iters) and cold runs on each
    version: through K3 (one launch a superstep) or, with the resident
    plan, K4 (one launch a run), each walk forced through the wrapper's
    constant or left to it."""
    frac = {None: None, "dense": 0.0, "list": 2.0}[walk]
    if frac is not None:
        monkeypatch.setattr(
            mega, "K3_DENSE_FRONTIER" if route == "k3" else
            "K4_DENSE_FRONTIER", frac)
    versions, want, colds = _patched_reference(graph, route)
    _build.reset_launches()
    got = resume_all(*versions, cuda_device, exchange="megastep",
                      resident=route == "k4")
    for i, ((x, t), (xw, tw)) in enumerate(zip(got, want)):
        assert np.array_equal(x, xw), i
        assert np.array_equal(x, colds[i]), i
        assert t.supersteps == tw.supersteps, i
        assert np.array_equal(t.local_iters, tw.local_iters), i
    resumes = 4
    if route == "k3":
        assert _build.launches["resident_megastep"] == 0
        assert _build.launches["megastep_semiring"] >= resumes
    else:
        # the cold runs on version 0 take K3; each resume one K4 launch
        assert _build.launches["resident_megastep"] == resumes


@pytest.mark.parametrize("route", ["k3", "k4"])
def test_quiesced_resume_runs_no_sweep_on_the_card(cuda_device, route):
    """A fixpoint resumed with an empty seed: one launch, no partition
    sweeps, the state unchanged, and one superstep, as the CPU run counts:
    K4 runs no round, and the engine counts the resident stretch it
    entered as one."""
    g = road_grid(120, 120, seed=4, weighted=True)
    pg = partition_graph(g, bfs_grow_partition(g, 6, seed=0), 6)
    d = algorithms.sssp(pg, 0, device=cuda_device)[0]
    plan = PhasedTierPlan.from_graph(pg) if route == "k4" else None
    extra = {"x0": np.where(pg.vmask, d, np.inf).astype(np.float32),
             "frontier0": np.zeros_like(pg.vmask)}
    prog = SemiringProgram("min_plus", resume=True)
    _build.reset_launches()
    s, t = GopherEngine(pg, prog, exchange="megastep", tier_plan=plan,
                        device=cuda_device).run(extra=extra)
    sc, tc = GopherEngine(pg, prog, exchange="megastep", tier_plan=plan,
                          device="cpu").run(extra=extra)
    key = "megastep_semiring" if route == "k3" else "resident_megastep"
    assert _build.launches[key] == 1
    assert np.array_equal(s["x"], extra["x0"])
    assert np.array_equal(sc["x"], extra["x0"])
    assert t.local_iters.sum() == tc.local_iters.sum() == 0
    assert t.supersteps == tc.supersteps == 1


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("semiring", ["min_plus", "max_first"])
def test_k2_semiring_spmv_frontier_matches_plain(cuda_device, semiring,
                                                 density):
    rng = np.random.default_rng(3)
    v, d = 5000, 8
    nbr = rng.integers(0, v, (v, d)).astype(np.int32)
    nbr[rng.random((v, d)) < 0.3] = PAD
    nbr[:40] = PAD                                   # all-PAD rows
    wgt = rng.uniform(0.1, 2.0, (v, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, v).astype(np.float32)
    x[::97] = np.inf
    x[::89] = -np.inf
    f = rng.random(v) < density
    x, f, nbr, wgt = (torch.from_numpy(a).to(cuda_device)
                      for a in (x, f, nbr, wgt))
    before = _build.launches["semiring_spmv_frontier"]
    y, act = semiring_spmv_frontier_cuda(x, f, nbr, wgt, semiring)
    wy, wact = semiring_spmv_frontier_ref(x, f, nbr, wgt, semiring)
    torch.cuda.synchronize()
    assert _build.launches["semiring_spmv_frontier"] == before + 1
    assert torch.equal(y, wy) and torch.equal(act, wact)


def _k5_cap(x):
    """An int, or "tile" / "tile+1": a whole tile of the build's layout
    (``k5_layout``) and one slot more, a carry into a second tile."""
    if isinstance(x, int):
        return x
    lay = k5_layout()
    return lay["threads"] * lay["slots"] + (1 if x == "tile+1" else 0)


@pytest.mark.parametrize("rows,cap,density,limit", [
    (7, 1, 0.5, "mixed"), (33, 969, 0.05, "full"), (64, 300, 1.0, "low"),
    (16, 1500, 0.5, "mixed"), (5, 64, 0.0, "full"),
    (4096, 1, 0.5, "mixed"), (3, 20011, 0.5, "mixed"),
    (3, 20011, 1.0, "low"), (40, 1023, 0.5, "mixed"),
    (20, "tile", 0.7, "mixed"), (20, "tile+1", 0.7, "mixed")])
def test_k5_k6_outbox_pack_matches_plain(cuda_device, rows, cap, density,
                                         limit):
    cap = _k5_cap(cap)
    rng = np.random.default_rng(rows + cap)
    active = rng.random((rows, cap)) < density
    vals = rng.uniform(-5.0, 5.0, (rows, cap)).astype(np.float32)
    vals[rng.random((rows, cap)) < 0.1] = np.inf
    vals[rng.random((rows, cap)) < 0.1] = -np.inf
    lim = {"full": np.full(rows, cap), "low": np.full(rows, cap // 3),
           "mixed": rng.integers(0, cap + 3, rows)}[limit].astype(np.int32)
    vals, active, lim = (torch.from_numpy(a).to(cuda_device)
                         for a in (vals, active, lim))
    for ident in (float("inf"), float("-inf")):
        before = _build.launches["outbox_pack"]
        got = outbox_pack_cuda(vals, active, lim, ident)
        want = outbox_pack_ref(vals, active, lim, ident)
        torch.cuda.synchronize()
        assert _build.launches["outbox_pack"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = outbox_compact_plan_cuda(active)
    want = outbox_compact_plan_ref(active)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows,cap,q", [(144, 969, 8), (4096, 1023, 1)])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_k5_query_batched_pack_matches_plain(cuda_device, rows, cap, q,
                                            density):
    """K5 with (R, cap, Q) values — its plan over zero values, then one
    masked scatter of the Q-vectors — bit-equal to the plain version, at
    the serving path's batched compact shape (P² rows of the RN graph's
    cap, Q 8) and at 4096 rows of a long cap, one launch a call."""
    rng = np.random.default_rng(rows + cap + q)
    active = rng.random((rows, cap)) < density
    vals = rng.uniform(-5.0, 5.0, (rows, cap, q)).astype(np.float32)
    vals[rng.random((rows, cap, q)) < 0.1] = np.inf
    lim = rng.integers(0, cap + 3, rows).astype(np.int32)
    lim[::2] = cap
    vals, active, lim = (torch.from_numpy(a).to(cuda_device)
                         for a in (vals, active, lim))
    for ident in (float("inf"), float("-inf")):
        before = _build.launches["outbox_pack"]
        got = outbox_pack_cuda(vals, active, lim, ident)
        want = outbox_pack_ref(vals, active, lim, ident)
        torch.cuda.synchronize()
        assert _build.launches["outbox_pack"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _serving_graph():
    """A road grid with unit weights (BFS) in 6 partitions, and its
    weighted build (SSSP) on the same partition."""
    g = road_grid(60, 60, drop_frac=0.05, seed=2)
    assign = bfs_grow_partition(g, 6, seed=0)
    wg = road_grid(60, 60, drop_frac=0.05, seed=2, weighted=True)
    return partition_graph(g, assign, 6), partition_graph(wg, assign, 6)


@pytest.mark.parametrize("exchange",
                         ["megastep", "dense", "compact", "tiered", "phased"])
def test_run_queries_on_the_card_matches_the_cpu(cuda_device, exchange):
    """A BFS and an SSSP batch through ``run_queries`` on the card equal
    the CPU's run (state, supersteps, query_supersteps, local_iters,
    count_hist); the staged packs launch K5, the fused route no kernel."""
    from repro_torch import serving
    for pg, srcs in zip(_serving_graph(), ([0, 77, 1800, 3000],
                                           [5, 2500])):
        prog = serving.BatchedSemiringProgram("min_plus", len(srcs))
        extra = {"qinit": serving.sssp_query_init(pg, srcs)}
        _build.reset_launches()
        s, t = GopherEngine(pg, prog, exchange=exchange,
                            device=cuda_device).run_queries(extra=extra)
        launches = dict(_build.launches)
        sc, tc = GopherEngine(pg, prog, exchange=exchange,
                              device="cpu").run_queries(extra=extra)
        for k in s:
            assert np.array_equal(s[k], sc[k]), k
        for k in ("supersteps", "query_supersteps", "local_iters",
                  "count_hist", "messages_sent", "wire_slots"):
            assert np.array_equal(np.asarray(getattr(t, k)),
                                  np.asarray(getattr(tc, k))), k
        packs = launches["outbox_pack"]
        assert packs > 0 if exchange in ("compact", "tiered", "phased") \
            else packs == 0
        assert launches["megastep_semiring"] == 0


def test_serving_on_the_card_matches_the_cpu(cuda_device):
    """One stream through ``GraphQueryService`` on the card and on the CPU:
    the same responses (PPR allclose), batches, hits and rejections, and
    the landmark refresh after ``apply_delta`` equal on both."""
    from repro_torch import serving
    from repro_torch.gofs import EdgeDelta
    upg, wpg = _serving_graph()
    stream = [("bfs", "u", 0), ("bfs", "u", 900), ("reach", "u", (5, 6)),
              ("sssp", "w", 17), ("sssp", "w", 3000), ("ppr", "w", 40),
              ("ppr", "w", 41), ("bfs", "u", 900), ("sssp", "w", 10 ** 7)]
    outs, lms = [], []
    for dev in (cuda_device, "cpu"):
        svc = serving.GraphQueryService({"u": upg, "w": wpg}, device=dev)
        for kind, g, s in stream:
            svc.submit(kind, g, s)
        out = svc.drain()
        out[-1] = svc.query("sssp", "w", 17)
        svc.enable_landmarks("w", 4)
        svc.apply_delta("w", EdgeDelta.inserts([0, 7], [1500, 2900],
                                               [0.5, 0.5]),
                        rebuild_landmarks=True)
        outs.append((out, svc.stats.summary()))
        lms.append(svc.landmark_caches["w"].dist)
    (gpu, gs), (cpu, cs) = outs
    for k in ("served", "cache_hits", "rejected", "batches"):
        assert gs[k] == cs[k], k
    assert gpu[-1].cached
    for t, r in cpu.items():
        g = gpu[t]
        assert (g.error, g.cached, g.supersteps) == (r.error, r.cached,
                                                      r.supersteps), t
        if r.result is None:
            assert g.result is None
        elif r.query.kind == "ppr":
            np.testing.assert_allclose(g.result, r.result, rtol=1e-5,
                                       atol=1e-9)
        else:
            assert np.array_equal(g.result, r.result), t
    assert np.array_equal(lms[0], lms[1])


def _ck_program(algo, pg):
    from repro_torch.core import PageRankProgram
    if algo == "cc":
        return SemiringProgram("max_first", init_max_vertex)
    if algo == "sssp":
        return SemiringProgram("min_plus", make_sssp_init(
            int(pg.part_of[0]), int(pg.local_of[0])))
    return PageRankProgram(n_global=pg.n_global, num_iters=30)


def _same_state(a, b, algo):
    assert sorted(a) == sorted(b)
    for k in a:
        if algo == "pagerank":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=0)
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("algo", ["cc", "sssp", "pagerank"])
def test_checkpointed_runs_on_the_card_match(cuda_device, tmp_path, algo):
    """A checkpointed run on 'compact' on the card equals the card's
    uncheckpointed run (PageRank allclose) and the CPU's checkpointed run,
    with the CPU's telemetry; it launches K2 (CC, SSSP) or K1 (PageRank)
    and K5, and a snapshot written from the card restores on the CPU and
    resumes there to the same end."""
    from repro_torch.training.checkpoint import Checkpointer
    pg = _serving_graph()[1]
    prog = _ck_program(algo, pg)
    plain, _ = GopherEngine(pg, prog, exchange="compact",
                            device=cuda_device).run()
    _build.reset_launches()
    s, t = GopherEngine(pg, prog, exchange="compact", device=cuda_device) \
        .run(checkpointer=Checkpointer(str(tmp_path / "gpu")),
             checkpoint_every=3)
    launches = dict(_build.launches)
    sweep = "semiring_spmv" if algo == "pagerank" \
        else "semiring_spmv_frontier"
    assert launches[sweep] > 0 and launches["outbox_pack"] == t.supersteps + 1
    sc, tc = GopherEngine(pg, prog, exchange="compact", device="cpu").run(
        checkpointer=Checkpointer(str(tmp_path / "cpu")), checkpoint_every=3)
    _same_state(plain, s, algo)
    _same_state(sc, s, algo)
    for k in ("supersteps", "local_iters", "changed_hist", "count_hist",
              "messages_sent", "wire_slots", "bytes_on_wire"):
        assert np.array_equal(np.asarray(getattr(t, k)),
                              np.asarray(getattr(tc, k))), k
    # the card's snapshots, cut after 4 supersteps, resumed on the CPU
    d = str(tmp_path / "cut")
    GopherEngine(pg, prog, exchange="compact", device=cuda_device).run(
        checkpointer=Checkpointer(d), checkpoint_every=2, superstep_budget=4)
    sr, tr = GopherEngine(pg, prog, exchange="compact", device="cpu").run(
        checkpointer=Checkpointer(d), checkpoint_every=2, resume=True)
    _same_state(sc, sr, algo)
    assert tr.supersteps == tc.supersteps


def test_recovery_of_a_crash_on_the_card(cuda_device, tmp_path):
    """A crash at superstep 5 of a checkpointed SSSP on the card, recovered
    by ``run_with_recovery`` from step 4, ends bit-equal to the fused
    route's run on the card."""
    from repro_torch.resilience import faults, run_with_recovery
    from repro_torch.training.checkpoint import Checkpointer
    pg = _serving_graph()[1]
    prog = _ck_program("sssp", pg)
    ref, tref = GopherEngine(pg, prog, device=cuda_device).run()
    plan = faults.FaultPlan(
        [faults.FaultSpec("engine.superstep", "crash", at=5)])
    eng = GopherEngine(pg, prog, exchange="megastep", device=cuda_device)
    with faults.inject(plan):
        s, t, rep = run_with_recovery(eng, Checkpointer(str(tmp_path)),
                                      every=2)
    assert rep.restarts == 1 and rep.resumed_steps == [4]
    assert np.array_equal(s["x"], ref["x"])
    assert t.supersteps == tref.supersteps


def test_rebalance_migration_resumes_on_the_card(cuda_device, tmp_path):
    """A migration after 2 supersteps of a checkpointed CC on the card
    (``migrate_and_resume``, the engine rebuilt on the patched block on
    the card) resumes to the CPU's migration-free result in global order."""
    from repro_torch.resilience.balance import (migrate_and_resume,
                                                plan_migration, to_global)
    from repro_torch.training.checkpoint import Checkpointer
    rows, cols = 6, 12
    g = road_grid(rows, cols, drop_frac=0.0, seed=0, weighted=True)
    strip = (np.arange(rows * cols) % cols) // 2
    pg = partition_graph(g, np.asarray([0, 1, 2, 0, 3, 3],
                                       np.int32)[strip], 4)
    for algo in ("cc", "sssp"):
        prog = _ck_program(algo, pg)
        ref, _ = GopherEngine(pg, prog, exchange="dense", device="cpu").run()
        eng = GopherEngine(pg, prog, exchange="compact", device=cuda_device)
        ck = Checkpointer(str(tmp_path / algo))
        eng.run(checkpointer=ck, checkpoint_every=1, superstep_budget=2)
        eng2, res, at = migrate_and_resume(
            eng, ck, plan_migration(pg, src=0, budget=12, dst=2))
        assert at == 2 and eng2.device.type == "cuda"
        s, _ = eng2.run(checkpointer=ck, checkpoint_every=1, resume=True)
        for k in ref:
            assert np.array_equal(to_global(s, res.pg)[k],
                                  to_global(ref, pg)[k]), (algo, k)


_TELEMETRY = ("supersteps", "local_iters", "changed_hist", "count_hist",
              "messages_sent", "wire_hist", "wire_slots", "pair_slots")


@pytest.mark.parametrize("exchange", ["megastep", "compact"])
def test_traced_runs_on_the_card_match(cuda_device, exchange):
    """A traced CC with ``boundary_sync`` on the card equals the card's
    untraced run (state and every Telemetry field but part_seconds) and
    the CPU's traced run (state and telemetry); it launches K3 once a
    superstep on the fused route and K2 and K5 on the compact one, and
    every span lies inside its parent."""
    from repro_torch.obs import Tracer, validate_chrome_trace
    pg = _serving_graph()[1]
    prog = _ck_program("cc", pg)
    s0, t0 = GopherEngine(pg, prog, exchange=exchange,
                          device=cuda_device).run()
    tr = Tracer(boundary_sync=True)
    _build.reset_launches()
    s, t = GopherEngine(pg, prog, exchange=exchange, tracer=tr,
                        device=cuda_device).run()
    launches = dict(_build.launches)
    ctr = Tracer()
    sc, tc = GopherEngine(pg, prog, exchange=exchange, tracer=ctr,
                          device="cpu").run()
    _same_state(s0, s, "cc")
    _same_state(sc, s, "cc")
    for f in Telemetry.__dataclass_fields__:
        if f != "part_seconds":
            a, b = getattr(t0, f), getattr(t, f)
            assert (a is None and b is None) or np.array_equal(
                np.asarray(a), np.asarray(b)), f
    for f in _TELEMETRY:
        assert np.array_equal(np.asarray(getattr(tc, f)),
                              np.asarray(getattr(t, f))), f
    if exchange == "megastep":
        assert launches["megastep_semiring"] == t.supersteps
        assert launches["resident_megastep"] == 0
    else:
        assert launches["semiring_spmv_frontier"] > 0
        assert launches["outbox_pack"] == t.supersteps + 1
    assert t.part_seconds.shape == (pg.num_parts,)
    assert tr.counts == ctr.counts and tr.balanced
    validate_chrome_trace(tr.chrome_trace())
    spans = sorted(tr.spans, key=lambda x: (x.t0_ns, -x.dur_ns))
    stack = []
    for sp in spans:
        while stack and stack[-1].depth >= sp.depth:
            stack.pop()
        if stack:
            parent = stack[-1]
            assert parent.depth == sp.depth - 1
            assert parent.t0_ns <= sp.t0_ns
            assert sp.t0_ns + sp.dur_ns <= parent.t0_ns + parent.dur_ns
        stack.append(sp)


def test_traced_profiler_dir_and_metrics_on_the_card(cuda_device, tmp_path):
    """A traced fused CC under ``profiler_dir`` writes a trace holding
    K3's kernel once a superstep (the profiler has been seen to lose a
    window's first launches, so a run is traced up to three times); an
    untraced run with ``metrics=`` launches K3 as often as one without and
    feeds the run's supersteps."""
    from repro_torch.obs import MetricsRegistry, Tracer
    pg = _serving_graph()[1]
    prog = _ck_program("cc", pg)
    tr = Tracer(profiler_dir=str(tmp_path))
    seen = []
    for _ in range(3):
        _, t = GopherEngine(pg, prog, tracer=tr, device=cuda_device).run()
        with open(tr.profiles[-1]) as f:
            events = json.load(f)["traceEvents"]
        seen.append(sum(1 for e in events if e.get("cat") == "kernel"
                        and "megastep_kernel" in e.get("name", "")))
        if seen[-1] == t.supersteps:
            break
    assert seen[-1] == t.supersteps, (seen, t.supersteps)
    _build.reset_launches()
    GopherEngine(pg, prog, device=cuda_device).run()
    plain = dict(_build.launches)
    reg = MetricsRegistry()
    _build.reset_launches()
    _, t = GopherEngine(pg, prog, metrics=reg, device=cuda_device).run()
    assert dict(_build.launches) == plain
    assert reg.snapshot()["counters"][
        "engine_supersteps_total{backend=local,exchange=megastep}"] \
        == t.supersteps


# (B, Sq, Sk, H, KV, dh, causal, window, q_offset). bf16 at dh 64, 80,
# 128 and 256 runs the tensor-core kernel, the rest the SIMT one.
K7_CUDA_CASES = [
    (2, 130, 130, 8, 2, 128, True, None, 0),     # llama3's group, ragged Sq
    (1, 200, 200, 8, 4, 256, True, 64, 0),       # gemma3's local layers
    (2, 45, 300, 4, 4, 64, True, None, 255),     # continuation, Sq < Sk
    (1, 77, 77, 6, 2, 32, False, None, 0),       # g = 3: a 63-row tile
    (3, 33, 50, 4, 1, 16, True, 9, 17),          # the reduced configs' dh
    (1, 20, 20, 2, 2, 64, True, None, -8),       # rows with no visible key
    (1, 300, 300, 32, 8, 80, True, 100, 0),      # h2o-danube's dh and group
    (2, 190, 230, 4, 2, 64, True, None, 40),     # ragged Sq and Sk, dh 64
    (1, 257, 321, 8, 2, 128, True, None, 64),    # ragged Sq and Sk, dh 128
    (1, 190, 700, 16, 8, 128, True, None, 510),  # continuation, Sq < Sk
    (1, 150, 150, 64, 8, 128, True, None, 0),    # g = 8 (qwen1.5-110b)
    (2, 200, 200, 4, 4, 128, False, None, 0),    # g = 1, not causal
    (1, 150, 150, 8, 2, 128, True, 40, -70),     # no visible key, 2 groups
    (1, 130, 260, 4, 2, 80, False, 50, 100),     # a window, not causal
    (1, 70, 333, 8, 4, 256, True, 100, 263),     # dh 256 continuation
    (2, 640, 640, 32, 8, 64, True, None, 0),     # 320 tiles: > 2 per SM
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(K7_CUDA_CASES)))
def test_k7_flash_attention_matches_plain(cuda_device, case, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    B, Sq, Sk, H, KV, dh, causal, window, q_offset = K7_CUDA_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(case)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    before = _build.launches["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    if q_offset < 0:
        assert not got[:, :-q_offset].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(K7_CUDA_CASES)))
def test_k7_lse_matches_plain(cuda_device, case, dtype):
    """K7's ``return_lse``: the same output as without it, and each row's
    log-sum-exp against the plain version's (rtol 1e-5; atol 1e-5 for
    rows whose lse is near 0), +inf on the rows with no visible key."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    B, Sq, Sk, H, KV, dh, causal, window, q_offset = K7_CUDA_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(case)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    got, want = lse.cpu(), want.cpu()
    empty = torch.isinf(want)
    assert torch.equal(torch.isinf(got), empty) and (got[empty] > 0).all()
    np.testing.assert_allclose(got[~empty].numpy(), want[~empty].numpy(),
                               rtol=1e-5, atol=1e-5)
    if q_offset < 0:
        assert empty[:, :, :-q_offset].all()


@pytest.mark.parametrize("dtype,dh,instantiation", [
    (torch.bfloat16, 128, "flash_kernel_sm90"),
    (torch.bfloat16, 80, "flash_kernel_sm90"),
    (torch.bfloat16, 32, "flash_kernel<"),
    (torch.float32, 128, "flash_kernel<"),
])
def test_k7_picks_its_instantiation(cuda_device, dtype, dh, instantiation):
    """bf16 at dh 64-256 runs the tensor-core kernel, the rest the SIMT
    one: by the kernel names the profiler records (a trace in which the
    profiler lost the launch is taken again, up to 5 times)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn((1, 64, 4, dh), device=cuda_device).to(dtype)
    k = torch.randn((1, 64, 2, dh), device=cuda_device).to(dtype)
    flash_attention_cuda(q, k, k)
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_cuda(q, k, k)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if "flash_kernel" in e.key]
        if names:
            break
    assert len(names) == 1 and instantiation in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,N", [(2, 300, 200, 16), (1, 64, 64, 4),
                                     (3, 17, 130, 8)])
def test_k8_mamba_scan_matches_plain(cuda_device, B, L, D, N, dtype):
    from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    x = (torch.randn((B, L, D), generator=gen, device=cuda_device) * 0.5)
    dt = torch.rand((B, L, D), generator=gen, device=cuda_device) * 0.5 + 0.01
    bv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    cv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    a = -(torch.rand((D, N), generator=gen, device=cuda_device) * 1.5 + 0.5)
    x, dt, bv, cv = (t.to(dtype) for t in (x, dt, bv, cv))
    before = _build.launches["mamba1_scan"]
    got = mamba1_scan_cuda(x, dt, bv, cv, a)
    want = mamba1_scan_ref(x, dt, bv, cv, a)
    torch.cuda.synchronize()
    assert _build.launches["mamba1_scan"] == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    wide = torch.zeros((B, L, 17), dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="at most 16"):
        mamba1_scan_cuda(x, dt, wide, wide,
                         torch.zeros((D, 17), device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,N", [(2, 64, 96, 16), (3, 131, 70, 8)])
def test_k8_from_a_state_matches_plain(cuda_device, B, L, D, N, dtype):
    """The ssm path's call form: a nonzero h0, ``return_state`` and a
    float32 y (and y in the inputs' dtype), at L one chunk of 64 steps and
    at L not a multiple of it."""
    from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
    gen = torch.Generator(device=cuda_device).manual_seed(L + D)
    x = torch.randn((B, L, D), generator=gen, device=cuda_device) * 0.5
    dt = torch.rand((B, L, D), generator=gen, device=cuda_device) * 0.5 + 0.01
    bv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    cv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    a = -(torch.rand((D, N), generator=gen, device=cuda_device) * 1.5 + 0.5)
    h0 = torch.randn((B, D, N), generator=gen, device=cuda_device)
    x, dt, bv, cv = (t.to(dtype) for t in (x, dt, bv, cv))
    before = _build.launches["mamba1_scan"]
    y, h = mamba1_scan_cuda(x, dt, bv, cv, a, h0, return_state=True,
                            y_dtype=torch.float32)
    wy, wh = mamba1_scan_ref(x, dt, bv, cv, a, h0, return_state=True,
                             y_dtype=torch.float32)
    yn = mamba1_scan_cuda(x, dt, bv, cv, a, h0)
    torch.cuda.synchronize()
    assert _build.launches["mamba1_scan"] == before + 2
    assert y.dtype == h.dtype == torch.float32 and yn.dtype == dtype
    # the same float32 recurrence, each product and sum rounded on its own
    # in both (test_k8_lanes_match_plain_bitwise holds the bits); y in the
    # inputs' dtype is K8's float32 y rounded once
    for got, want in ((y, wy), (h, wh)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(yn, y.to(dtype))


@pytest.mark.parametrize("L_at", ["1", "chunk-1", "chunk", "chunk+1", "2049"])
@pytest.mark.parametrize("N", [1, 5, 8, 16])
def test_k8_lanes_match_plain_bitwise(cuda_device, N, L_at):
    """K8's y and final state equal the plain version's bit for bit: every
    state count it pads (N 1, 5, 8) or fills (16), L at the edges of its
    chunk of steps, D not a multiple of a block's channels (aligned rows
    staged by cp.async, odd rows by plain loads), B 1 and 4, from h = 0 and
    from a given h0, y in float32 and in the inputs' dtype, float32 and
    bf16 inputs."""
    from repro_torch.kernels.mamba_scan import (k8_layout, mamba1_scan_cuda,
                                                mamba1_scan_ref)
    lay = k8_layout()
    chunk, ch = lay["steps"], lay["channels"]
    L = {"1": 1, "chunk-1": chunk - 1, "chunk": chunk, "chunk+1": chunk + 1,
         "2049": 2049}[L_at]
    B = 4 if N in (5, 16) else 1
    D = ch + 24 if L_at in ("1", "chunk", "2049") else 2 * ch + 5
    assert D % ch
    gen = torch.Generator(device=cuda_device).manual_seed(N * 10000 + L)
    x = torch.randn((B, L, D), generator=gen, device=cuda_device) * 0.5
    dt = torch.rand((B, L, D), generator=gen, device=cuda_device) * 0.5 + 0.01
    bv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    cv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    a = -(torch.rand((D, N), generator=gen, device=cuda_device) * 1.5 + 0.5)
    h0 = torch.randn((B, D, N), generator=gen, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        args = tuple(t.to(dtype) for t in (x, dt, bv, cv)) + (a,)
        for state in (None, h0):
            y, h = mamba1_scan_cuda(*args, state, return_state=True,
                                    y_dtype=torch.float32)
            wy, wh = mamba1_scan_ref(*args, state, return_state=True,
                                     y_dtype=torch.float32)
            yn = mamba1_scan_cuda(*args, state)
            wyn = mamba1_scan_ref(*args, state)
            torch.cuda.synchronize()
            what = (dtype, state is not None, B, L, D, N)
            assert y.dtype == torch.float32 and yn.dtype == dtype, what
            assert torch.equal(y, wy), what
            assert torch.equal(h, wh), what
            assert torch.equal(yn, wyn), what


@pytest.mark.parametrize("K,N", [(8192, 288), (8192, 4096)])
def test_ssm_deep_projections_are_row_count_invariant(cuda_device, K, N):
    """falcon-mamba-7b's x_proj and out_proj shapes: a call of a few rows
    through ``ops.batch_invariant_matmul`` gives the bits of the same rows
    in a call of 8,320 (which is what lets a decode step reproduce the
    teacher-forced forward)."""
    from repro_torch.kernels.ops import batch_invariant_matmul
    gen = torch.Generator(device=cuda_device).manual_seed(N)
    w = (torch.randn((K, N), generator=gen, device=cuda_device)
         * K ** -0.5).bfloat16()
    a = torch.randn((8320, K), generator=gen, device=cuda_device).bfloat16()
    ref = a @ w
    for m in (1, 4, 32, 511, 512):
        assert torch.equal(batch_invariant_matmul(a[:m], w), ref[:m]), m
    got = batch_invariant_matmul(a[:8].reshape(4, 2, K), w)
    assert torch.equal(got, ref[:8].reshape(4, 2, N))


def test_ssm_serving_on_the_card_matches_the_cpu(cuda_device):
    """Reduced falcon-mamba-7b with the same weights on the card (K8 in
    every prefill layer) and on the CPU (K8's plain version): prefill
    logits and both cache tensors, then 4 decode steps (no K8)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    cfg = get_config("falcon-mamba-7b").reduced()
    model = S.init_params(cfg, seed=0, device=cuda_device)
    cpu_model = copy.deepcopy(model).to("cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    _build.reset_launches()
    gl, gc, _ = S.prefill(model, toks.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert _build.launches["mamba1_scan"] == cfg.n_layers
    wl, wc, _ = S.prefill(cpu_model, toks, cfg)
    np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(), rtol=1e-4,
                               atol=1e-4)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(gc[key].cpu().numpy(), wc[key].numpy(),
                                   rtol=1e-4, atol=1e-4)
    tok = torch.argmax(wl[:, -1], -1)
    for _ in range(4):
        gl, gc = S.decode_step(model, tok.to(cuda_device), gc, cfg)
        wl, wc = S.decode_step(cpu_model, tok, wc, cfg)
        np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(), rtol=1e-4,
                                   atol=1e-4)
        tok = torch.argmax(wl, -1)
    assert gc["len"] == wc["len"] == 16
    assert _build.launches["mamba1_scan"] == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-4b",
                                  "h2o-danube-1.8b"])
def test_lm_serving_on_the_card_matches_the_cpu(cuda_device, arch):
    """A reduced dense model with the same weights on the card (K7 in every
    prefill layer) and on the CPU (K7's plain version). h2o-danube keeps
    its full-width head width of 80 (2560 / 32)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    if arch == "h2o-danube-1.8b":
        cfg = dataclasses.replace(cfg, d_head=80)
    model = T.init_params(cfg, seed=0, device=cuda_device)
    cpu_model = copy.deepcopy(model).to("cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    _build.reset_launches()
    gl, gc, _ = T.prefill(model, toks.to(cuda_device), cfg, max_seq=16)
    assert _build.launches["flash_attention"] == cfg.n_layers
    wl, wc, _ = T.prefill(cpu_model, toks, cfg, max_seq=16)
    np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(), rtol=1e-4,
                               atol=1e-4)
    tok = torch.argmax(wl[:, -1], -1)
    for _ in range(4):
        gl, gc = T.decode_step(model, tok.to(cuda_device), gc, cfg)
        wl, wc = T.decode_step(cpu_model, tok, wc, cfg)
        np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(), rtol=1e-4,
                                   atol=1e-4)
        tok = torch.argmax(wl, -1)
    assert _build.launches["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b"])
def test_lm_mesh_one_nccl_rank_equals_unsharded(cuda_device, tmp_path,
                                                arch):
    """One NCCL rank serves ``arch`` at full width, its depth cut to 2
    layers (bf16), through the mesh path on a (1, 1) ('data', 'model')
    mesh (``init_params(mesh=)``, the serve steps with ``mesh=``): the
    tokens of the prefill and 8 decode steps equal the unsharded run's
    with the same seeded weights, K7 (dense) or K8 (ssm) is launched once
    a prefill layer and never in decode, as unsharded, and the mesh path
    issued its collectives over NCCL where the unsharded one issued
    none."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    op = "flash_attention" if cfg.family == "dense" else "mamba1_scan"
    prompts = torch.randint(0, cfg.vocab, (4, 256), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))

    def serve(mesh):
        model = M.init_params(cfg, seed=0, device=cuda_device, mesh=mesh)
        prefill = make_prefill_step(cfg, max_seq=264, mesh=mesh)
        decode = make_decode_step(cfg, mesh=mesh)
        _build.reset_launches()
        sh.reset_collectives()
        tok, cache = prefill(model, {"inputs": prompts.to(cuda_device)})
        torch.cuda.synchronize()
        pre = (_build.launches[op], sum(sh.collectives().values()))
        toks = [tok]
        for _ in range(8):
            tok, cache = decode(model, tok, cache)
            toks.append(tok)
        torch.cuda.synchronize()
        return (torch.stack(toks, 1).cpu(), pre,
                _build.launches[op] - pre[0])

    want = serve(None)
    _nccl_world(tmp_path)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        assert dist.get_backend(mesh.get_group("model")) == "nccl"
        got = serve(mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[0], want[0])
    assert got[1][0] == want[1][0] == cfg.n_layers
    assert got[2] == want[2] == 0
    assert want[1][1] == 0 and got[1][1] > 0


def test_mesh_one_nccl_rank_equals_local(cuda_device, tmp_path):
    """``backend='shard_map'`` on a world of one NCCL rank (the card
    machine's one card): its collectives run (the all_to_all, the halt
    vote's and PageRank's all_reduces, the gathers) and every staged
    exchange is bit-equal to 'local' on the card ('auto' resolving to
    'dense'), with equal Telemetry and K2/K5 (K1 for PageRank) launch
    counts; a checkpointed compact CC likewise. A CPU engine on the NCCL
    mesh and a CPU mesh over NCCL are refused."""
    import torch.distributed as dist

    from repro_torch.core import PageRankProgram, TierPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.checkpoint import Checkpointer
    pg = _serving_graph()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh((1,), ("parts",), device="cuda")
        cases = [(algo, ex) for algo in ("cc", "sssp")
                 for ex in ("dense", "compact", "tiered", "phased", "auto")]
        cases += [("pagerank", "dense"), ("cc", "checkpointed")]
        for algo, ex in cases:
            prog = _ck_program(algo, pg)
            kw = {"max_supersteps": 64} if algo == "pagerank" else {}
            if ex in ("tiered", "phased"):
                kw["tier_plan"] = TierPlan.from_graph(pg)
            runs = []
            for backend in ("local", "shard_map"):
                _build.reset_launches()
                eng = GopherEngine(
                    pg, prog, backend=backend,
                    mesh=mesh if backend == "shard_map" else None,
                    exchange={"auto": "dense" if backend == "local" else
                              "auto", "checkpointed": "compact"}.get(ex, ex),
                    device=cuda_device, **kw)
                if ex == "checkpointed":
                    out = eng.run(checkpointer=Checkpointer(
                        str(tmp_path / backend)), checkpoint_every=2)
                else:
                    out = eng.run()
                runs.append(out + (dict(_build.launches),))
            (sl, tl, ll), (sm, tm, lm) = runs
            _same_state(sl, sm, algo)
            assert tm.exchange == tl.exchange, (algo, ex)
            for f in Telemetry.__dataclass_fields__:
                if f != "part_seconds":
                    a, b = getattr(tl, f), getattr(tm, f)
                    assert (a is None and b is None) or np.array_equal(
                        np.asarray(a), np.asarray(b)), (algo, ex, f)
            assert ll == lm, (algo, ex)
            k = "semiring_spmv" if algo == "pagerank" \
                else "semiring_spmv_frontier"
            assert lm[k] > 0 and (ex == "dense" or ex == "auto"
                                  or algo == "pagerank"
                                  or lm["outbox_pack"] > 0), (algo, ex)
        with pytest.raises(ValueError, match="cuda mesh"):
            GopherEngine(pg, _ck_program("cc", pg), backend="shard_map",
                         mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="gloo"):
            make_mesh((1,), ("parts",), device="cpu")
    finally:
        dist.destroy_process_group()


def _nccl_world(tmp_path):
    """A world of one NCCL rank on this card (rendezvous through a file)."""
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))


def test_mesh_service_one_nccl_rank_equals_local(cuda_device, tmp_path):
    """``GraphQueryService(backend='shard_map')`` on the mesh
    ``MeshPlan((1,), ('parts',)).make`` builds over an NCCL subgroup of a
    one-rank world: a stream of SSSP, BFS, reachability and PPR queries,
    landmarks refreshed after a delta, ``warm`` and a post-delta query
    equal the 'local' service on the card (min/max bit-equal with the
    queries' supersteps, PPR rtol 1e-5); its pooled engines run 'dense',
    whose batched sweeps are torch ops, and launch what the 'local'
    service's do."""
    import torch.distributed as dist

    from repro_torch.gofs import EdgeDelta
    from repro_torch.launch.elastic import MeshPlan
    from repro_torch.serving import GraphQueryService
    pg = _serving_graph()[1]
    stream = [("sssp", 0), ("bfs", 1700), ("reach", (5, 3000)), ("ppr", 9),
              ("sssp", 2222)]
    delta = EdgeDelta.inserts([0, 7], [3500, 1200], [1.0, 2.0])

    def drive(svc):
        for kind, src in stream:
            svc.submit(kind, "g", src)
        _build.reset_launches()
        res = svc.drain()
        launches = dict(_build.launches)
        svc.enable_landmarks("g", 4)
        svc.apply_delta("g", delta, rebuild_landmarks=True)
        return (res, launches, svc.landmark_caches["g"].dist,
                svc.warm("g"), svc.query("sssp", "g", 2222).result)

    want = drive(GraphQueryService({"g": pg}, device=cuda_device))
    _nccl_world(tmp_path)
    try:
        mesh = MeshPlan((1,), ("parts",)).make(device="cuda")
        assert mesh.get_group() is not dist.group.WORLD
        assert dist.get_backend(mesh.get_group()) == "nccl"
        svc = GraphQueryService({"g": pg}, backend="shard_map", mesh=mesh,
                                device=cuda_device)
        got = drive(svc)
        assert all(e.exchange == "dense" for e in svc._engines.values())
    finally:
        dist.destroy_process_group()
    for t, w in want[0].items():
        r = got[0][t]
        assert (r.error, r.cached, r.supersteps) == (w.error, w.cached,
                                                     w.supersteps), t
        np.testing.assert_allclose(r.result, w.result, rtol=1e-5, atol=0)
        if w.query.kind != "ppr":
            assert np.array_equal(r.result, w.result), t
    assert got[1] == want[1]
    assert np.array_equal(got[2], want[2]) and got[3] == want[3] == 1
    assert np.array_equal(got[4], want[4])


def test_mesh_failover_one_nccl_rank(cuda_device, tmp_path):
    """``run_with_failover`` on a one-NCCL-rank mesh: a crash at superstep
    2 of a checkpointed compact CC and SSSP restarts in place, bit-equal
    to the 'local' recovered run with the same report, launching K2 and
    K5; device loss of the one rank raises ``ValueError`` (every device
    lost)."""
    from repro_torch.launch.elastic import MeshPlan
    from repro_torch.resilience import faults, run_with_failover
    from repro_torch.training.checkpoint import Checkpointer
    pg = _serving_graph()[1]

    def fail_over(algo, kind, d, **kw):
        eng = GopherEngine(pg, _ck_program(algo, pg), exchange="compact",
                           device=cuda_device, **kw)
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.superstep", kind, at=2, payload={"lost": [0]})])
        _build.reset_launches()
        with faults.inject(plan):
            out = run_with_failover(eng, Checkpointer(str(d)), every=1)
        return out + (dict(_build.launches),)

    want = {a: fail_over(a, "crash", tmp_path / f"local_{a}")
            for a in ("cc", "sssp")}
    _nccl_world(tmp_path)
    try:
        mesh = MeshPlan((1,), ("parts",)).make(device="cuda")
        for a in ("cc", "sssp"):
            eng, s, t, rep, launches = fail_over(
                a, "crash", tmp_path / f"mesh_{a}", backend="shard_map",
                mesh=mesh)
            _, ws, wt, wrep, wl = want[a]
            assert eng.mesh is mesh and rep == wrep
            assert rep.restarts == 1 and rep.resumed_steps == [2]
            _same_state(ws, s, a)
            assert t.supersteps == wt.supersteps and launches == wl
            assert launches["semiring_spmv_frontier"] > 0 and launches[
                "outbox_pack"] > 0
        with pytest.raises(ValueError, match="every device"):
            fail_over("cc", "device_loss", tmp_path / "lost",
                      backend="shard_map", mesh=mesh)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _runs_alike(make, check_ops=True):
    """An unvalidated and a validated run of ``make(validate)`` on the
    card: (their states, Telemetries, launch counts, the validated run's
    record)."""
    out = []
    for validate in (False, True):
        eng = make(validate)
        _build.reset_launches()
        state, tele = eng.run()
        torch.cuda.synchronize()
        out.append((state, tele, dict(_build.launches), eng.sentinel))
    (s0, t0, l0, _), (s1, t1, l1, (summary, vs)) = out
    for k in s0:
        assert np.array_equal(s0[k], s1[k]), k
    for f in Telemetry.__dataclass_fields__:
        a, b = getattr(t0, f), getattr(t1, f)
        assert (a is None and b is None) or np.array_equal(
            np.asarray(a), np.asarray(b)), f
    assert l0 == l1
    assert [v for v in vs if v.severity == "error"] == []
    return l1, summary


def test_sentinel_validated_fused_cc_on_the_card(cuda_device):
    """A validated fused CC (K3) and SSSP on the card: bit-equal to the
    unvalidated runs with equal Telemetry and K3 launches, and no
    collective recorded; Passes 2 and 3 report no error or warning."""
    from repro_torch.analysis import REGISTRY, check_semiring, lint_kernels
    pg = _serving_graph()[1]
    for algo in ("cc", "sssp"):
        launches, summary = _runs_alike(lambda v, a=algo: GopherEngine(
            pg, _ck_program(a, pg), validate=v, device=cuda_device))
        assert launches["megastep_semiring"] > 0 and summary.ops == []
    assert [v for v in lint_kernels() if v.severity != "info"] == []
    assert all(check_semiring(n) == [] for n in REGISTRY)


def test_sentinel_validated_one_nccl_rank_compact_cc(cuda_device, tmp_path):
    """On a world of one NCCL rank, a validated compact CC, phased CC and
    30-iteration dense PageRank are bit-equal to the unvalidated runs
    with equal Telemetry and K2/K5/K1 launches; every superstep's
    collectives were recorded and agreed on (one fingerprint gather
    each, and one at the run's end)."""
    from repro_torch.launch.mesh import make_mesh
    pg = _serving_graph()[1]
    _nccl_world(tmp_path)
    try:
        mesh = make_mesh((1,), ("parts",), device="cuda")
        for algo, ex, kernel in (("cc", "compact", "outbox_pack"),
                                 ("cc", "phased", "outbox_pack"),
                                 ("pagerank", "dense", "semiring_spmv")):
            kw = {"max_supersteps": 64} if algo == "pagerank" else {}
            plan = PhasedTierPlan.from_graph(pg) if ex == "phased" else None
            launches, summary = _runs_alike(
                lambda v, a=algo, e=ex, p=plan, k=kw: GopherEngine(
                    pg, _ck_program(a, pg), backend="shard_map", mesh=mesh,
                    exchange=e, tier_plan=p, validate=v, device=cuda_device,
                    **k))
            assert launches[kernel] > 0, (algo, ex)
            steps = summary.per_superstep()
            assert len(steps) == summary.supersteps and all(
                s.get("all_reduce", 0) >= 1 for s in steps), (algo, ex)
            assert summary.end_counts["all_gather"] >= 1
            assert summary.fingerprints == len(summary.ops) + 1
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


def _grads_held(got, want, dtype, what):
    """float32: allclose at rtol 1e-4, atol 1e-5; bf16: a relative L2
    error of at most 1e-2 (each output rounded to bf16 once)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, f"{what}[{i}]"
            continue
        assert g.dtype == w.dtype, f"{what}[{i}]: {g.dtype} {w.dtype}"
        if dtype == torch.float32:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what}[{i}]")
        else:
            assert _rel_l2(g, w) <= 1e-2, (what, i, _rel_l2(g, w))


def _k7b_inputs(cuda_device, case, dtype):
    """q, k, v, do of K7's case ``case``, and o and lse from K7."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, Sq, Sk, H, KV, dh, causal, window, q_offset = K7_CUDA_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(100 + case)
    q, k, v, do = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
                   for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh),
                             (B, Sq, H, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    return q, k, v, do, o, lse, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(K7_CUDA_CASES)))
def test_k7b_flash_attention_bwd_matches_plain(cuda_device, case, dtype):
    """K7b against ``flash_attention_bwd_ref`` on K7's cases, o and lse
    from K7: every head width (16, 32, 64, 80, 128, 256), GQA up to g = 8,
    windows, continuations, rows with no visible key, ragged tiles. bf16
    at dh 64-256 takes the tensor-core route (held given the same lse,
    and refused without one); the rest the SIMT kernel (lse unused)."""
    from repro_torch.kernels.flash_attention import (SM90_HEAD_DIMS,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref)
    q, k, v, do, o, lse, kw = _k7b_inputs(cuda_device, case, dtype)
    sm90 = dtype == torch.bfloat16 and q.shape[3] in SM90_HEAD_DIMS
    before = _build.launches["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse if sm90 else None,
                                   **kw)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_bwd"] == before + 1
    _grads_held(got, want, dtype, f"K7b case {case}")
    if kw["q_offset"] < 0:
        assert not got[0][:, :-kw["q_offset"]].any()
    if sm90:
        with pytest.raises(ValueError, match="lse"):
            flash_attention_bwd_cuda(q, k, v, o, do, **kw)


@pytest.mark.parametrize("case", [6, 10, 14])
def test_k7b_tensor_core_route_is_deterministic_in_dk_dv(cuda_device, case):
    """Two calls of the tensor-core K7b: dk and dv (summed over the group
    in registers) bit-equal, dq (float32 reductions in any order) allclose;
    danube's group (g 4, dh 80), g 8 at dh 128, dh 256 with a window."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do, o, lse, kw = _k7b_inputs(cuda_device, case, torch.bfloat16)
    first = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    second = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    np.testing.assert_allclose(first[0].float().cpu().numpy(),
                               second[0].float().cpu().numpy(),
                               rtol=1e-2, atol=1e-2)


# (B, L, D, N, h0 and dh_last): L 47, 48, 49 sit one under, at and just
# off a multiple of K8b's steps × stages (4 × 3, and 8 × 2); D 130 is off
# a block of channels and not 16-byte aligned in bf16, D 136 is aligned
# but off a block
K8B_CASES = [(2, 300, 200, 16, False), (1, 64, 64, 4, True),
             (3, 17, 130, 8, True), (2, 33, 96, 16, True),
             (1, 48, 64, 16, False), (1, 47, 136, 1, True),
             (2, 49, 130, 16, True), (1, 1, 8, 16, True)]


def _k8b_inputs(cuda_device, B, L, D, N, state, dtype):
    """x, δ, B, C, A, h0 (or None), dy (float32) and dh_last (or None)."""
    gen = torch.Generator(device=cuda_device).manual_seed(L + D)
    x = torch.randn((B, L, D), generator=gen, device=cuda_device) * 0.5
    dt = torch.rand((B, L, D), generator=gen, device=cuda_device) * 0.5 + 0.01
    bv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    cv = torch.randn((B, L, N), generator=gen, device=cuda_device)
    a = -(torch.rand((D, N), generator=gen, device=cuda_device) * 1.5 + 0.5)
    h0 = (torch.randn((B, D, N), generator=gen, device=cuda_device)
          if state else None)
    dh = (torch.randn((B, D, N), generator=gen, device=cuda_device)
          if state else None)
    dy = torch.randn((B, L, D), generator=gen, device=cuda_device)
    x, dt, bv, cv = (t.to(dtype) for t in (x, dt, bv, cv))
    return x, dt, bv, cv, a, h0, dy, dh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,N,state", K8B_CASES)
def test_k8b_mamba_scan_bwd_matches_plain(cuda_device, B, L, D, N, state,
                                          dtype):
    """K8b against ``mamba1_scan_bwd_ref``: N 1, padded (4, 8) and full
    (16), L of 1 and at, off and one under its chunks and ring, D off a
    block of channels and unaligned, B 1 to 3, with and without h0 and
    the final state's gradient, dy float32 (the ssm mixer's form) and in
    the inputs' dtype."""
    from repro_torch.kernels.mamba_scan import (mamba1_scan_bwd_cuda,
                                                mamba1_scan_bwd_ref)
    x, dt, bv, cv, a, h0, dy, dh = _k8b_inputs(cuda_device, B, L, D, N,
                                               state, dtype)
    for dy_in in ([dy] if dtype == torch.float32 else [dy, dy.to(dtype)]):
        before = _build.launches["mamba1_scan_bwd"]
        got = mamba1_scan_bwd_cuda(x, dt, bv, cv, a, h0, dy_in, dh)
        want = mamba1_scan_bwd_ref(x, dt, bv, cv, a, h0, dy_in, dh)
        torch.cuda.synchronize()
        assert _build.launches["mamba1_scan_bwd"] == before + 1
        _grads_held(got, want, dtype, f"K8b dy {dy_in.dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [0, 6])
def test_k8b_two_calls_are_bit_equal(cuda_device, case, dtype):
    """K8b sums dB and dC over the channels and dA over B and L in a fixed
    order, without atomics: two calls give the same bits in all six
    outputs (dh0 with h0, None without)."""
    from repro_torch.kernels.mamba_scan import mamba1_scan_bwd_cuda
    args = _k8b_inputs(cuda_device, *K8B_CASES[case], dtype)
    first = mamba1_scan_bwd_cuda(*args)
    second = mamba1_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert (first[5] is None) == (args[5] is None)
    for i, (f, g) in enumerate(zip(first, second)):
        assert (f is None and g is None) or torch.equal(f, g), i


@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One reduced float32 train step with the same weights and batch on
    the card (K7 and K7b, or K8 and K8b) and on the CPU (the plain
    versions): the loss at rtol 1e-4, every gradient within a relative L2
    error of 1e-3, and the kernels launched twice a layer forward (remat
    recomputes each layer) and once backward."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as S
    cfg = get_config(arch).reduced()
    model = M.init_params(cfg, seed=0, device=cuda_device)
    cpu_model = copy.deepcopy(model).to("cpu")
    opt = O.OptCfg(mixed_precision=False)
    O.init_state(model, opt)
    O.init_state(cpu_model, opt)
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(0))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    _build.reset_launches()
    loss, _ = S.make_loss_fn(cfg)(
        model, {k: t.to(cuda_device) for k, t in batch.items()})
    grads = S._grads(loss, model)
    torch.cuda.synchronize()
    fwd, bwd = (("flash_attention", "flash_attention_bwd")
                if cfg.family == "dense" else
                ("mamba1_scan", "mamba1_scan_bwd"))
    assert _build.launches[fwd] == 2 * cfg.n_layers
    assert _build.launches[bwd] == cfg.n_layers
    want_loss, _ = S.make_loss_fn(cfg)(cpu_model, batch)
    want = S._grads(want_loss, cpu_model)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()),
                               rtol=1e-4)
    for n, g in grads.items():
        assert _rel_l2(g.cpu(), want[n]) <= 1e-3, n
