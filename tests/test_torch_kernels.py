"""The port's kernel modules against the JAX package's.

Plain versions (CPU) against the JAX oracles and the Pallas kernels in
interpret mode: min/max results are BIT-equal (float32 min/max are
order-independent); plus_times is allclose (rtol=1e-6, atol=1e-7) because
the lane sum may associate differently. The hand-written CUDA kernels run
only on a card, in tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import graph_block as j_graph_block  # noqa: E402
from repro.gofs import bfs_grow_partition, powerlaw_social, road_grid  # noqa: E402
from repro.gofs.formats import PAD, partition_graph  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import init_max_vertex as j_init_max_vertex  # noqa: E402
from repro.core import make_sssp_init as j_make_sssp_init  # noqa: E402
from repro.kernels import megastep as jmega  # noqa: E402
from repro.kernels.ref import semiring_spmv_ref as j_spmv_ref  # noqa: E402
from repro.kernels.semiring_spmv import (  # noqa: E402
    semiring_spmv_frontier_pallas, semiring_spmv_pallas)
from repro.kernels import outbox_compact as joc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import graph_block as t_graph_block  # noqa: E402
from repro_torch.core import SemiringProgram, init_max_vertex, make_sssp_init  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.kernels import flat as tflat  # noqa: E402
from repro_torch.kernels import megastep as tmega  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.outbox_compact import (  # noqa: E402
    outbox_compact_plan_cuda, outbox_pack_cuda)
from repro_torch.kernels.ref import (outbox_compact_plan_ref,  # noqa: E402
                                     outbox_pack_ref,
                                     semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import (  # noqa: E402
    semiring_spmv_cuda, semiring_spmv_frontier_cuda)

SEMIRINGS = ["min_plus", "max_first", "plus_times"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    per process keeps these small CPU tensors from oversubscribing cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_ell(rng, v, d, frac_pad=0.3):
    """Random ELL with PAD lanes, all-PAD rows and ±inf in x."""
    nbr = rng.integers(0, v, (v, d)).astype(np.int32)
    nbr[rng.random((v, d)) < frac_pad] = PAD
    nbr[rng.random(v) < 0.1] = PAD
    wgt = rng.uniform(0.1, 2.0, (v, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, v).astype(np.float32)
    x[rng.random(v) < 0.05] = np.inf
    x[rng.random(v) < 0.05] = -np.inf
    return x, nbr, wgt


def _assert_semiring_equal(semiring, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("v,d", [(100, 16), (257, 8)])
def test_spmv_ref_matches_jax_and_pallas(semiring, v, d):
    rng = np.random.default_rng(v * 31 + d)
    x, nbr, wgt = _random_ell(rng, v, d)
    got = semiring_spmv_ref(torch.from_numpy(x), torch.from_numpy(nbr),
                            torch.from_numpy(wgt), semiring)
    args = (jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(wgt), semiring)
    _assert_semiring_equal(semiring, got, j_spmv_ref(*args))
    _assert_semiring_equal(semiring, got,
                           semiring_spmv_pallas(*args, block_v=64,
                                                interpret=True))
    # the dispatch takes the plain version for a CPU tensor
    _assert_semiring_equal(semiring, ops.semiring_spmv(
        torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(wgt),
        semiring), got)


@pytest.mark.parametrize("semiring", ["min_plus", "max_first"])
def test_spmv_frontier_ref_matches_jax(semiring):
    from repro.kernels.ref import semiring_spmv_frontier_ref as j_front
    rng = np.random.default_rng(3)
    x, nbr, wgt = _random_ell(rng, 120, 8)
    f = rng.random(120) < 0.3
    y, act = semiring_spmv_frontier_ref(
        torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(nbr),
        torch.from_numpy(wgt), semiring)
    jy, jact = j_front(jnp.asarray(x), jnp.asarray(f), jnp.asarray(nbr),
                       jnp.asarray(wgt), semiring)
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert np.array_equal(act.numpy(), np.asarray(jact))


# frontier densities: none, one vertex, a third, every vertex
FRONTIERS = {"empty": 0.0, "single": None, "third": 0.3, "full": 1.0}


@pytest.mark.parametrize("density", sorted(FRONTIERS))
@pytest.mark.parametrize("semiring", ["min_plus", "max_first"])
def test_spmv_frontier_matches_pallas(semiring, density):
    """K2's plain version against the JAX oracle and the Pallas kernel in
    interpret mode, over ragged row blocks, all-PAD rows and ±inf."""
    rng = np.random.default_rng(17)
    v = 300
    x, nbr, wgt = _random_ell(rng, v, 8)
    nbr[:9] = PAD                                   # all-PAD rows
    if FRONTIERS[density] is None:
        f = np.zeros(v, bool)
        f[rng.integers(0, v)] = True
    else:
        f = rng.random(v) < FRONTIERS[density]
    y, act = semiring_spmv_frontier_ref(
        torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(nbr),
        torch.from_numpy(wgt), semiring)
    args = (jnp.asarray(x), jnp.asarray(f), jnp.asarray(nbr),
            jnp.asarray(wgt), semiring)
    for jy, jact in (jref.semiring_spmv_frontier_ref(*args),
                     semiring_spmv_frontier_pallas(*args, block_v=64,
                                                   interpret=True)):
        assert np.array_equal(y.numpy(), np.asarray(jy))
        assert np.array_equal(act.numpy(), np.asarray(jact))
    assert not act[:9].any()
    # the dispatch takes the plain version for a CPU tensor
    oy, oact = ops.semiring_spmv_frontier(
        torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(nbr),
        torch.from_numpy(wgt), semiring)
    assert torch.equal(oy, y) and torch.equal(oact, act)


# (R, cap, active density, limit): "full" = cap, "low" = truncation below
# most rows' counts, "mixed" = per-row budgets from 0 to past cap
PACK_CASES = {
    "cap1_mixed": (5, 1, 0.5, "mixed"),
    "dense_full": (9, 16, 1.0, "full"),
    "empty_full": (7, 16, 0.0, "full"),
    "sparse_low": (13, 40, 0.05, "low"),
    "half_mixed": (16, 33, 0.5, "mixed"),
    "dense_low": (6, 64, 1.0, "low"),
}


def _pack_inputs(case):
    R, cap, density, lim = PACK_CASES[case]
    rng = np.random.default_rng(R * 100 + cap)
    active = rng.random((R, cap)) < density
    vals = rng.uniform(-5.0, 5.0, (R, cap)).astype(np.float32)
    vals[rng.random((R, cap)) < 0.1] = np.inf
    vals[rng.random((R, cap)) < 0.1] = -np.inf
    limit = {"full": np.full(R, cap),
             "low": np.full(R, max(cap // 4, 1)),
             "mixed": rng.integers(0, cap + 3, R)}[lim].astype(np.int32)
    return vals, active, limit


@pytest.mark.parametrize("ident", [float("inf"), float("-inf"), 0.0])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_outbox_pack_matches_jax_and_pallas(case, ident):
    """K5's plain version: all five outputs bit-equal to the JAX oracle and
    to the Pallas kernel in interpret mode; ±inf values survive the pack."""
    vals, active, limit = _pack_inputs(case)
    got = outbox_pack_ref(torch.from_numpy(vals), torch.from_numpy(active),
                          torch.from_numpy(limit), ident)
    jargs = (jnp.asarray(vals), jnp.asarray(active), jnp.asarray(limit),
             ident)
    for want in (jref.outbox_pack_ref(*jargs),
                 joc.outbox_pack_pallas(*jargs, block_r=4, interpret=True)):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3].numpy().tolist() == active.sum(1).tolist()
    for g, w in zip(ops.outbox_pack(torch.from_numpy(vals),
                                    torch.from_numpy(active),
                                    torch.from_numpy(limit), ident), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_outbox_compact_plan_matches_jax_and_pallas(case):
    _, active, _ = _pack_inputs(case)
    got = outbox_compact_plan_ref(torch.from_numpy(active))
    ja = jnp.asarray(active)
    for want in (jref.outbox_compact_plan_ref(ja),
                 joc.outbox_compact_plan_pallas(ja, block_r=4,
                                                interpret=True)):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ops.outbox_compact_plan(torch.from_numpy(active)), got):
        assert torch.equal(g, w)


# Sizes the card's tiling reaches beyond PACK_CASES: a row of several tiles
# with a carry (cap 20011, 3 rows) and rows of one slot (cap 1, 64 rows).
# Held to the jnp oracles only: the Pallas kernel's (block_r, cap, cap)
# one-hot would need gigabytes at cap 20011.
TILING_CASES = {"cap20011": (3, 20011), "cap1": (64, 1)}


def _tiling_inputs(case):
    R, cap = TILING_CASES[case]
    rng = np.random.default_rng(cap)
    active = rng.random((R, cap)) < 0.5
    vals = rng.uniform(-5.0, 5.0, (R, cap)).astype(np.float32)
    vals[rng.random((R, cap)) < 0.1] = np.inf
    vals[rng.random((R, cap)) < 0.1] = -np.inf
    count = active.sum(1)
    # a mixed budget: below, at and past each row's count, and 0
    limit = np.choose(np.arange(R) % 4,
                      [count // 3, count, count + 2, np.zeros(R, int)])
    return vals, active, limit.astype(np.int32)


@pytest.mark.parametrize("ident", [float("inf"), float("-inf")])
@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_outbox_pack_matches_jax_at_tiling_sizes(case, ident):
    vals, active, limit = _tiling_inputs(case)
    got = outbox_pack_ref(torch.from_numpy(vals), torch.from_numpy(active),
                          torch.from_numpy(limit), ident)
    want = jref.outbox_pack_ref(jnp.asarray(vals), jnp.asarray(active),
                                jnp.asarray(limit), ident)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[4].numpy().tolist() == (active.sum(1) > limit).tolist()
    assert np.isinf(got[0].numpy()[got[1].numpy() != PAD]).any()


@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_outbox_compact_plan_matches_jax_at_tiling_sizes(case):
    _, active, _ = _tiling_inputs(case)
    got = outbox_compact_plan_ref(torch.from_numpy(active))
    for g, w in zip(got, jref.outbox_compact_plan_ref(jnp.asarray(active))):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_outbox_pack_refuses_query_batched_values():
    """Query-batched (R, cap, Q) values pack (each slot's Q-vector moves as
    its scalar would); values whose (R, cap) is not the mask's are refused."""
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    active = torch.tensor([[True, False, True], [False, True, True]])
    limit = torch.tensor([3, 1], dtype=torch.int32)
    for fn in (ops.outbox_pack, outbox_pack_ref):
        pv, sids, pinv, counts, over = fn(vals, active, limit, 0.0)
        for q in range(4):
            want = outbox_pack_ref(vals[..., q], active, limit, 0.0)
            assert torch.equal(pv[..., q], want[0])
            for got, w in zip((sids, pinv, counts, over), want[1:]):
                assert torch.equal(got, w)
        with pytest.raises(RuntimeError):
            fn(vals[:, :2], active, limit, 0.0)


# ---------------- the fused superstep ----------------

GRAPHS = {
    # road grids leave the hub branch of delivery dead ...
    "road": lambda: road_grid(10, 11, drop_frac=0.06, seed=3, weighted=True),
    # ... a powerlaw graph has real hub feed rows
    "social": lambda: powerlaw_social(400, m=5, seed=2),
}


@pytest.fixture(scope="module")
def blocks():
    """Per graph: (JAX pg, JAX block, JAX mailbox, port block, port
    mailbox), built from the same partitioned arrays."""
    out = {}
    for name, make in GRAPHS.items():
        g = make()
        pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
        jgb = j_graph_block(pg)
        tpg = partitioned_graph_from_fields(dataclasses.asdict(pg))
        tgb = t_graph_block(tpg, "cpu")
        out[name] = (pg, jgb, _j_compose(jgb), tgb,
                     tmega.compose_mailbox(tgb))
    return out


def _j_compose(jgb):
    """The JAX mailbox, composed under one jit (eager it dispatches many
    small ops); the Python-int statics are re-derived from the shapes, as
    the JAX engine does."""
    arrays = jax.jit(lambda gb: {
        k: v for k, v in jmega.compose_mailbox(gb).items()
        if k not in jmega.MAILBOX_STATICS})(jgb)
    P, v_max = jgb["vmask"].shape
    return {**arrays, "num_parts": P, "v_max": v_max,
            "cap": jgb["ob_inv"].shape[1] // P, "n": P * v_max}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compose_mailbox_matches(blocks, name):
    _, _, jcm, _, tcm = blocks[name]
    for k in ("num_parts", "v_max", "cap", "n"):
        assert tcm[k] == jcm[k], k
    for k in ("vmask", "lo_src", "lo_ok", "lo_w", "hub_src", "hub_ok",
              "hub_w", "hub_row", "hub_row_ok", "vdst", "edge_cnt", "wgt"):
        assert tuple(tcm[k].shape) == jcm[k].shape, k
        assert np.array_equal(tcm[k].numpy(), np.asarray(jcm[k])), k
    # one flat adjacency, PAD lanes kept PAD: JAX's 0-filled nbr where its
    # nbr_ok holds
    assert tuple(tcm["nbr"].shape) == jcm["nbr"].shape
    assert np.array_equal(tcm["nbr"].numpy(),
                          np.where(np.asarray(jcm["nbr_ok"]),
                                   np.asarray(jcm["nbr"]), PAD))
    # PageRank's unit weights are made only when its pull asks
    assert "ones" not in tcm
    assert np.all(tflat.unit_weights(dict(tcm)).numpy() == 1.0)
    if name == "social":
        assert tcm["hub_row_ok"].any()      # the hub branch is live here


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_deliver_flat_and_round_stats_match(blocks, name):
    _, _, jcm, _, tcm = blocks[name]
    rng = np.random.default_rng(11)
    n = tcm["n"]
    vals = rng.uniform(0.0, 9.0, n).astype(np.float32)
    vals[rng.random(n) < 0.05] = np.inf
    live = rng.random(n) < 0.4
    for combine, with_w in (("min", True), ("max", False), ("sum", False)):
        gate = None if combine == "sum" else live
        got = tmega.deliver_flat(torch.from_numpy(vals),
                                 None if gate is None
                                 else torch.from_numpy(gate),
                                 tcm, combine, with_w)
        want = jax.jit(lambda v, g: jmega.deliver_flat(
            v, g, jcm, combine, with_w))(
                jnp.asarray(vals), None if gate is None else jnp.asarray(gate))
        if combine == "sum":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        else:
            assert np.array_equal(got.numpy(), np.asarray(want)), combine
    for ch in (live, None):
        tp, tn = tmega.round_stats(None if ch is None
                                   else torch.from_numpy(ch), tcm)
        jp, jn = jax.jit(lambda c: jmega.round_stats(c, jcm))(
            None if ch is None else jnp.asarray(ch))
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert int(tn) == int(jn)


def _programs(pg):
    sp, sl = int(pg.part_of[0]), int(pg.local_of[0])
    return {
        "cc": (JSemiring(semiring="max_first", init_fn=j_init_max_vertex),
               SemiringProgram(semiring="max_first",
                               init_fn=init_max_vertex)),
        "sssp": (JSemiring(semiring="min_plus",
                           init_fn=j_make_sssp_init(sp, sl)),
                 SemiringProgram(semiring="min_plus",
                                 init_fn=make_sssp_init(sp, sl))),
    }


@pytest.mark.parametrize("prog", ["cc", "sssp"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_megastep_matches_jnp_and_pallas(blocks, name, prog):
    """Walk three supersteps: the plain port, the JAX jnp oracle and the
    Pallas megakernel (interpret mode) agree bit for bit on every output."""
    pg, jgb, jcm, tgb, tcm = blocks[name]
    jprog, tprog = _programs(pg)[prog]
    st = tprog.init(tgb)
    x, ch, fr = (st[k].reshape(-1) for k in ("x", "changed_v", "frontier"))
    jst = jax.vmap(jprog.init)(jgb)
    assert np.array_equal(x.numpy(), np.asarray(jst["x"]).reshape(-1))
    # one compile each, reused across the three supersteps
    jnp_step = jax.jit(lambda *a: jmega.megastep_semiring(
        *a, jcm, tprog.semiring, backend="jnp"))
    pallas_step = jax.jit(lambda *a: jmega.megastep_semiring_pallas(
        *a, jcm, tprog.semiring, interpret=True))
    for _ in range(3):
        got = tmega.megastep_semiring(x, ch, fr, tcm, tprog.semiring)
        jargs = [jnp.asarray(t.numpy()) for t in (x, ch, fr)]
        want = jnp_step(*jargs)
        pallas = pallas_step(*jargs)
        for g, w, p in zip(got, want, pallas):
            assert np.array_equal(g.numpy(), np.asarray(w))
            assert np.array_equal(g.numpy(), np.asarray(p))
        x, ch, fr = got[:3]


def test_megastep_unroll_matches_jnp(blocks):
    """``fixpoint_unroll`` > 1 counts ``unroll`` sweeps per loop trip in
    liters and may sweep past the fixpoint; both packages agree."""
    pg, _, jcm, tgb, tcm = blocks["road"]
    jprog, tprog = _programs(pg)["sssp"]
    st = tprog.init(tgb)
    x, ch, fr = (st[k].reshape(-1) for k in ("x", "changed_v", "frontier"))
    jnp_step = jax.jit(lambda *a: jmega.megastep_semiring(
        *a, jcm, "min_plus", unroll=3, backend="jnp"))
    for _ in range(2):
        got = tmega.megastep_semiring(x, ch, fr, tcm, "min_plus", unroll=3)
        want = jnp_step(*[jnp.asarray(t.numpy()) for t in (x, ch, fr)])
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        x, ch, fr = got[:3]


def test_megastep_pagerank_matches(blocks):
    pg, jgb, jcm, tgb, tcm = blocks["social"]
    rng = np.random.default_rng(5)
    r = rng.uniform(0.0, 2.0 / pg.n_global, tcm["n"]).astype(np.float32)
    deg = tgb["out_degree"].reshape(-1).float()
    got = tmega.megastep_pagerank(torch.from_numpy(r), tcm, deg,
                                  1.0 / pg.n_global, pg.n_global, 0.85, 30, 3)
    want = jax.jit(lambda r_, d_: jmega.megastep_pagerank(
        r_, jcm, d_, 1.0 / pg.n_global, pg.n_global, 0.85, 30, 3))(
            jnp.asarray(r), jnp.asarray(deg.numpy()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert got[2] == bool(want[2])


# ---------------- the wrappers: a CUDA tensor launches or raises ----------

def test_cuda_wrappers_refuse_cpu_tensors(blocks):
    x = torch.zeros(4)
    nbr = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        semiring_spmv_cuda(x, nbr, torch.zeros((4, 8)), "min_plus")
    _, _, _, tgb, tcm = blocks["road"]
    n = tcm["n"]
    with pytest.raises(ValueError, match="CUDA"):
        tmega.megastep_semiring_cuda(torch.zeros(n), torch.zeros(n, dtype=bool),
                                     torch.zeros(n, dtype=bool), tcm,
                                     "min_plus")
    with pytest.raises(ValueError, match="CUDA"):
        semiring_spmv_frontier_cuda(x, torch.zeros(4, dtype=torch.bool), nbr,
                                    torch.zeros((4, 8)), "max_first")
    active = torch.zeros((3, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        outbox_pack_cuda(torch.zeros((3, 5)), active,
                         torch.zeros(3, dtype=torch.int32), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        outbox_compact_plan_cuda(active)
