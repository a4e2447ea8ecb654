"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Min/max results are bit-equal; plus_times is allclose (rtol=1e-6,
atol=1e-7) because the kernel sums lanes in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (GopherEngine, PhasedTierPlan, SemiringProgram,
                              graph_block, init_max_vertex, make_sssp_init)
from repro_torch.gofs import (bfs_grow_partition, partition_graph,
                              powerlaw_social)
from repro_torch.gofs.formats import PAD
from repro_torch.kernels import _build
from repro_torch.kernels import megastep as mega
from repro_torch.kernels.outbox_compact import (outbox_compact_plan_cuda,
                                                outbox_pack_cuda)
from repro_torch.kernels.ref import (outbox_compact_plan_ref, outbox_pack_ref,
                                     semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import (semiring_spmv_cuda,
                                               semiring_spmv_frontier_cuda)

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


@pytest.mark.parametrize("rows,cap,density,limit", [
    (7, 1, 0.5, "mixed"), (33, 969, 0.05, "full"), (64, 300, 1.0, "low"),
    (16, 1500, 0.5, "mixed"), (5, 64, 0.0, "full")])
def test_k5_k6_outbox_pack_matches_plain(cuda_device, rows, cap, density,
                                         limit):
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
        got = outbox_pack_cuda(vals, active, lim, ident)
        want = outbox_pack_ref(vals, active, lim, ident)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = outbox_compact_plan_cuda(active)
    want = outbox_compact_plan_ref(active)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
