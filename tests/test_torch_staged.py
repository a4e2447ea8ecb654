"""The port's staged BSP route against the JAX package's.

``exchange='dense'`` and ``'compact'`` runs of CC, SSSP, BFS and MaxVertex
are BIT-identical to the JAX package's runs of the same exchange, with
equal telemetry, and to the port's own fused (megastep) run; PageRank with
``tol`` and BlockRank are allclose (rtol=1e-5, atol=1e-7, the JAX package's
own fused-vs-dense tolerance) with equal supersteps. The mailbox's gather
forms are held against its scatter oracles and against the JAX package's
per-partition functions. The same arrays go to both packages through
``partitioned_graph_from_fields``; the JAX runs are cached per module.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.algorithms as jalg  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import graph_block as j_graph_block  # noqa: E402
from repro.core import init_max_vertex as j_init_max_vertex  # noqa: E402
from repro.core import make_sssp_init as j_make_sssp_init  # noqa: E402
from repro.core import messages as jmsg  # noqa: E402
from repro.gofs import (bfs_grow_partition, hash_partition,  # noqa: E402
                        powerlaw_social, road_grid)
from repro.gofs.formats import Graph, partition_graph  # noqa: E402

import repro_torch.algorithms as talg  # noqa: E402
from repro_torch.core import (GopherEngine, SemiringProgram,  # noqa: E402
                              graph_block, init_max_vertex, make_sssp_init)
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402


def _directed(n: int, seed: int):
    """A random directed graph: MaxVertex's maximum reachable id differs
    from CC's component label there."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    keep = src != dst
    return Graph.from_edges(n, src[keep], dst[keep], directed=True)


GRAPHS = {
    "small": lambda: road_grid(10, 11, drop_frac=0.06, seed=3, weighted=True),
    "mid": lambda: road_grid(40, 40, drop_frac=0.06, seed=3, weighted=True),
    # unit weights: the graphs BFS runs on
    "small_unit": lambda: road_grid(10, 11, drop_frac=0.06, seed=3,
                                    weighted=False),
    "mid_unit": lambda: road_grid(40, 40, drop_frac=0.06, seed=3,
                                  weighted=False),
    # directed: the graphs MaxVertex runs on
    "small_dir": lambda: _directed(110, 4),
    "mid_dir": lambda: _directed(1600, 5),
    # hub feed rows: the hub branch of the inbox combine is live
    "social": lambda: powerlaw_social(400, m=5, seed=2),
}
# algorithm -> (semiring, suffix of the graphs it runs on)
ALGOS = {"cc": ("max_first", ""), "max_vertex": ("max_first", "_dir"),
         "sssp": ("min_plus", ""), "bfs": ("min_plus", "_unit")}
TELEMETRY = ("supersteps", "local_iters", "changed_hist", "messages_sent",
             "wire_slots", "wire_hist", "bytes_on_wire", "count_hist",
             "pair_slots", "pair_rounds", "exchange")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    per process keeps these small CPU tensors from oversubscribing cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, make in GRAPHS.items():
        g = make()
        pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
        out[name] = (g, pg, partitioned_graph_from_fields(
            dataclasses.asdict(pg)))
    return out


def _programs(pg, algo, max_local_iters=None):
    """(JAX program, port program) of one algorithm; SSSP and BFS start at
    global vertex 0."""
    sp, sl = int(pg.part_of[0]), int(pg.local_of[0])
    if ALGOS[algo][0] == "max_first":
        return (JSemiring(semiring="max_first", init_fn=j_init_max_vertex,
                          max_local_iters=max_local_iters),
                SemiringProgram(semiring="max_first", init_fn=init_max_vertex,
                                max_local_iters=max_local_iters))
    return (JSemiring(semiring="min_plus", init_fn=j_make_sssp_init(sp, sl),
                      max_local_iters=max_local_iters),
            SemiringProgram(semiring="min_plus", init_fn=make_sssp_init(sp, sl),
                            max_local_iters=max_local_iters))


@pytest.fixture(scope="module")
def runs(graphs):
    """Lazily computed runs of both packages, keyed (package, graph, algo,
    exchange, max_local_iters) -> (x (P, v_max), Telemetry)."""
    cache = {}

    def get(pkg, name, algo, exchange, mli=None):
        key = (pkg, name, algo, exchange, mli)
        if key not in cache:
            _, pg, tpg = graphs[name]
            jprog, tprog = _programs(pg, algo, mli)
            if pkg == "jax":
                s, t = JEngine(pg, jprog, exchange=exchange).run()
            else:
                s, t = GopherEngine(tpg, tprog, exchange=exchange,
                                    device="cpu").run()
            cache[key] = (np.asarray(s["x"]), t)
        return cache[key]
    return get


def _graph_of(algo, name):
    return name if name == "social" else name + ALGOS[algo][1]


def _assert_same_telemetry(t, jt):
    for field in TELEMETRY:
        a, b = getattr(t, field), getattr(jt, field)
        if b is None:
            assert a is None, field
        else:
            assert np.array_equal(a, b), field


# ---------------- exchange parity with the JAX package ----------------

@pytest.mark.parametrize("exchange", ["dense", "compact"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("name", ["small", "mid"])
def test_staged_bit_identity_and_telemetry(runs, name, algo, exchange):
    name = _graph_of(algo, name)
    x, t = runs("torch", name, algo, exchange)
    jx, jt = runs("jax", name, algo, exchange)
    assert np.array_equal(x, jx)
    _assert_same_telemetry(t, jt)
    if exchange == "compact":
        assert t.wire_slots < runs("torch", name, algo, "dense")[1].wire_slots


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("name", ["small", "mid", "social"])
def test_dense_matches_own_megastep(runs, name, algo):
    """The staged route and the fused route of the port: same bits, same
    supersteps and sweeps; compact's per-round counts are the fused
    route's logical observation."""
    name = _graph_of(algo, name)
    x, t = runs("torch", name, algo, "dense")
    mx, mt = runs("torch", name, algo, "megastep")
    assert np.array_equal(x, mx)
    for field in ("supersteps", "local_iters", "changed_hist",
                  "messages_sent"):
        assert np.array_equal(getattr(t, field), getattr(mt, field)), field
    ct = runs("torch", name, algo, "compact")[1]
    assert np.array_equal(ct.count_hist, mt.count_hist)
    assert np.array_equal(ct.pair_slots, mt.pair_slots)


# ---------------- vertex-centric and bounded fixpoints ----------------

@pytest.mark.parametrize("mli", [1, 3], ids=["vertex", "bounded3"])
@pytest.mark.parametrize("exchange", ["dense", "compact"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_bounded_fixpoints_match_jax(runs, algo, exchange, mli):
    """max_local_iters=1 (mode='vertex', one unmasked K1 sweep) and a
    bounded 3: the leftover frontier carries over, and every partition's
    local_iters equals the JAX package's."""
    name = _graph_of(algo, "small")
    x, t = runs("torch", name, algo, exchange, mli)
    jx, jt = runs("jax", name, algo, exchange, mli)
    assert np.array_equal(x, jx)
    _assert_same_telemetry(t, jt)
    # same fixpoint as the sub-graph centric run, in more supersteps
    sx, st = runs("torch", name, algo, "dense")
    assert np.array_equal(x, sx)
    assert t.supersteps >= st.supersteps


@pytest.mark.parametrize("mli", [None, 3], ids=["fixpoint", "bounded3"])
def test_fixpoint_unroll_matches_jax(graphs, mli):
    """``fixpoint_unroll=2`` counts two sweeps a trip and may overshoot a
    bounded cap by one sweep, in both packages alike."""
    import dataclasses as dc
    _, pg, tpg = graphs["mid"]
    jprog, tprog = _programs(pg, "sssp", mli)
    jprog, tprog = (dc.replace(jprog, fixpoint_unroll=2),
                    dc.replace(tprog, fixpoint_unroll=2))
    s, t = GopherEngine(tpg, tprog, exchange="dense", device="cpu").run()
    js, jt = JEngine(pg, jprog, exchange="dense").run()
    assert np.array_equal(s["x"], np.asarray(js["x"]))
    assert np.array_equal(s["frontier"], np.asarray(js["frontier"]))
    _assert_same_telemetry(t, jt)


@pytest.mark.parametrize("algo", ["cc", "sssp", "bfs", "max_vertex"])
def test_public_functions_vertex_mode_match_jax(graphs, algo):
    name = _graph_of(algo, "mid")
    _, pg, tpg = graphs[name]
    if algo == "cc":
        (x, n, t), (jx, jn, jt) = (
            talg.connected_components(tpg, mode="vertex", device="cpu"),
            jalg.connected_components(pg, mode="vertex"))
        assert n == jn
    elif algo == "max_vertex":
        (x, t), (jx, jt) = (talg.max_vertex(tpg, mode="vertex", device="cpu"),
                            jalg.max_vertex(pg, mode="vertex"))
    else:
        fn = {"sssp": (talg.sssp, jalg.sssp), "bfs": (talg.bfs, jalg.bfs)}
        (x, t), (jx, jt) = (fn[algo][0](tpg, 3, mode="vertex", device="cpu"),
                            fn[algo][1](pg, 3, mode="vertex"))
    assert t.exchange == jt.exchange == "dense"
    assert np.array_equal(x, jx)
    _assert_same_telemetry(t, jt)
    assert np.all(t.local_iters == t.supersteps)   # one sweep a superstep


def test_bounded_public_functions_match_jax(graphs):
    _, pg, tpg = graphs["mid"]
    lab, n, t = talg.connected_components(tpg, max_local_iters=3,
                                          device="cpu")
    jlab, jn, jt = jalg.connected_components(pg, max_local_iters=3)
    assert np.array_equal(lab, jlab) and n == jn
    _assert_same_telemetry(t, jt)
    d, t = talg.sssp(tpg, 5, max_local_iters=3, device="cpu")
    jd, jt = jalg.sssp(pg, 5, max_local_iters=3)
    assert np.array_equal(d, jd)
    _assert_same_telemetry(t, jt)


@pytest.mark.parametrize("algo", ["bfs", "max_vertex"])
@pytest.mark.parametrize("size", ["small", "mid"])
def test_bounded_bfs_and_max_vertex_match_jax_engine(graphs, runs, size,
                                                     algo):
    """bfs/max_vertex(max_local_iters=3) against the JAX engine running the
    same bounded SemiringProgram on the route 'auto' picks for it (dense):
    the JAX functions fix the bound to None or 1, so the reference is its
    engine."""
    name = _graph_of(algo, size)
    _, pg, tpg = graphs[name]
    jx, jt = runs("jax", name, algo, "dense", 3)
    if algo == "bfs":
        x, t = talg.bfs(tpg, 0, max_local_iters=3, device="cpu")
        jx = np.where(pg.vmask, jx, np.inf)
    else:
        x, t = talg.max_vertex(tpg, max_local_iters=3, device="cpu")
        jx = np.where(pg.vmask, jx, -np.inf)
    assert t.exchange == jt.exchange == "dense"
    assert np.array_equal(x, jx)
    _assert_same_telemetry(t, jt)
    assert t.supersteps >= runs("jax", name, algo, "dense")[1].supersteps


def test_superstep_reduction_paper_claim():
    """The port's copy of tests/test_system.py's check of paper Fig 4(c):
    sub-graph centric takes FEWER supersteps than vertex centric, and is
    bounded by the meta-graph diameter (+constant)."""
    from repro_torch.core import meta_diameter, vertex_diameter
    from repro_torch.gofs import bfs_grow_partition as t_bfs_grow
    from repro_torch.gofs import partition_graph as t_partition_graph
    from repro_torch.gofs import road_grid as t_road_grid
    g = t_road_grid(20, 20, drop_frac=0.05, seed=7)
    pg = t_partition_graph(g, t_bfs_grow(g, 4, seed=0), 4)
    _, _, t_sub = talg.connected_components(pg, mode="subgraph",
                                            device="cpu")
    _, _, t_vert = talg.connected_components(pg, mode="vertex", device="cpu")
    assert t_sub.supersteps <= t_vert.supersteps
    assert t_sub.supersteps <= meta_diameter(pg) + 3
    assert t_vert.supersteps <= vertex_diameter(g) + 3
    assert t_vert.supersteps > t_sub.supersteps


def test_subgraph_utilities_match_jax(graphs):
    from repro.core import subgraph as jsub
    from repro_torch.core import subgraph as tsub
    for name in ("mid", "social"):
        g, pg, tpg = graphs[name]
        n, a, m = tsub.meta_graph(tpg)
        jn, ja, jm = jsub.meta_graph(pg)
        assert n == jn and np.array_equal(m, jm)
        assert (a != ja).nnz == 0
        assert tsub.meta_diameter(tpg) == jsub.meta_diameter(pg)
        assert [list(s) for s in tsub.subgraph_sizes(tpg)] == \
            [list(s) for s in jsub.subgraph_sizes(pg)]
    g, _, _ = graphs["mid"]
    assert tsub.graph_diameter(g.undirected_csr()) == \
        jsub.graph_diameter(g.undirected_csr())


# ---------------- PageRank with tol, BlockRank ----------------

def _sink_graph():
    """A directed graph with pure sinks (tests/test_system.py's)."""
    rng = np.random.default_rng(11)
    n, ne = 120, 400
    src = rng.integers(15, n, ne)
    dst = rng.integers(0, n, ne)
    keep = src != dst
    return Graph.from_edges(n, src[keep], dst[keep], directed=True)


@pytest.mark.parametrize("case", ["grid_tol_1e-5", "sinks_tol_1e-7"])
def test_pagerank_tol_allclose_equal_supersteps(graphs, case):
    if case.startswith("grid"):
        _, pg, tpg = graphs["mid"]
        tol = 1e-5
    else:
        g = _sink_graph()
        pg = partition_graph(g, hash_partition(g, 4, seed=0), 4)
        tpg = partitioned_graph_from_fields(dataclasses.asdict(pg))
        tol = 1e-7
    r, t = talg.pagerank(tpg, num_iters=200, tol=tol, device="cpu")
    jr, jt = jalg.pagerank(pg, num_iters=200, tol=tol)
    assert t.exchange == jt.exchange == "dense"
    assert t.supersteps == jt.supersteps < 200
    np.testing.assert_allclose(r, jr, rtol=1e-5, atol=1e-7)
    for field in ("local_iters", "changed_hist", "messages_sent",
                  "wire_slots", "bytes_on_wire"):
        assert np.array_equal(getattr(t, field), getattr(jt, field)), field


def test_pagerank_dense_matches_megastep(graphs):
    """Fixed iterations on the staged route: allclose to the fused route
    with equal supersteps."""
    from repro_torch.core import PageRankProgram
    _, _, tpg = graphs["social"]
    prog = PageRankProgram(n_global=tpg.n_global, num_iters=12)
    s, t = GopherEngine(tpg, prog, exchange="dense", device="cpu").run()
    ms, mt = GopherEngine(tpg, prog, device="cpu").run()
    assert mt.exchange == "megastep" and t.supersteps == mt.supersteps == 12
    np.testing.assert_allclose(s["r"], ms["r"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["small", "social"])
def test_blockrank_matches_jax(graphs, name):
    _, pg, tpg = graphs[name]
    r, t, info = talg.blockrank(tpg, device="cpu")
    jr, jt, jinfo = jalg.blockrank(pg)
    assert info["num_meta"] == jinfo["num_meta"]
    np.testing.assert_allclose(info["blockrank"], jinfo["blockrank"],
                               rtol=1e-12)
    assert t.supersteps == jt.supersteps
    np.testing.assert_allclose(r, jr, rtol=1e-5, atol=1e-7)


def test_local_pagerank_matches_jax(graphs):
    """Phase 1 on a staged engine's block and flat adjacency, which phase 3
    then sweeps: one upload, one adjacency."""
    from repro.algorithms.pagerank import _local_pagerank as j_local
    from repro_torch.algorithms.pagerank import _local_pagerank as t_local
    from repro_torch.core import PageRankProgram
    _, pg, tpg = graphs["social"]
    eng = GopherEngine(tpg, PageRankProgram(n_global=tpg.n_global, tol=1e-7),
                       device="cpu")
    gb = eng._gb_for_staged()
    np.testing.assert_allclose(t_local(gb, 20), j_local(pg, 20), rtol=1e-5,
                               atol=1e-7)
    assert eng._gb_for_staged()["adj"] is gb["adj"]
    assert "ones" in gb["adj"]          # phase 3's pull reuses the weights


def test_blockrank_converges_to_pagerank_fixpoint():
    """The port's copy of tests/test_system.py's BlockRank check."""
    g = road_grid(12, 12, drop_frac=0.05, seed=6)
    pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(pg))
    rb, _, info = talg.blockrank(tpg, tol=1e-9, max_iters=100, device="cpu")
    A = g.csr()
    A.data[:] = 1.0
    outdeg = g.out_degree.astype(np.float64)
    rr = np.full(g.n, 1.0 / g.n)
    for _ in range(200):
        contrib = np.where(outdeg > 0, rr / np.maximum(outdeg, 1), 0)
        rr = 0.15 / g.n + 0.85 * (A @ contrib + rr[outdeg == 0].sum() / g.n)
    got = np.zeros(g.n)
    got[tpg.global_id[tpg.vmask]] = rb[tpg.vmask]
    np.testing.assert_allclose(got, rr, atol=1e-4)
    assert info["num_meta"] >= tpg.num_parts


# ---------------- the mailbox ----------------

@pytest.fixture(scope="module")
def blocks(graphs):
    """Per graph: (JAX pg, JAX block, port block), on the same arrays."""
    return {name: (pg, j_graph_block(pg), graph_block(tpg, "cpu"))
            for name, (_, pg, tpg) in graphs.items()
            if name in ("small", "social")}


def _messages(rng, pg):
    P, r_max = pg.re_src.shape
    vals = rng.uniform(0.0, 9.0, (P, r_max)).astype(np.float32)
    vals[rng.random((P, r_max)) < 0.05] = np.inf
    vals[rng.random((P, r_max)) < 0.05] = -np.inf
    send = rng.random((P, r_max)) < 0.5
    return vals, send


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("name", ["small", "social"])
def test_gather_mailbox_matches_scatter_oracles_and_jax(blocks, name,
                                                         combine):
    pg, jgb, tgb = blocks[name]
    rng = np.random.default_rng(7)
    vals, send = _messages(rng, pg)
    if combine == "sum":
        vals = np.where(np.isfinite(vals), vals, 1.0).astype(np.float32)
    P, cap, v_max = pg.num_parts, pg.mailbox_cap, pg.v_max
    tv, ts = torch.from_numpy(vals), torch.from_numpy(send)
    out = tmsg.build_outbox_gather(tv, ts, tgb["ob_inv"], P, cap, combine)
    ov, oi = tmsg.build_outbox(tv, tgb["re_src"], tgb["re_dst_part"],
                               tgb["re_dst_local"], tgb["re_slot"], ts, P,
                               cap, combine)
    assert np.array_equal(out.numpy(), ov.numpy())
    jout = jax.vmap(lambda v, s, o: jmsg.build_outbox_gather(
        v, s, o, P, cap, combine))(jnp.asarray(vals), jnp.asarray(send),
                                   jgb["ob_inv"])
    assert np.array_equal(out.numpy(), np.asarray(jout))
    jov, joi = jax.vmap(lambda *a: jmsg.build_outbox(*a, P, cap, combine))(
        jnp.asarray(vals), jgb["re_src"], jgb["re_dst_part"],
        jgb["re_dst_local"], jgb["re_slot"], jnp.asarray(send))
    assert np.array_equal(oi.numpy(), np.asarray(joi))

    recv = tmsg.route_local(out)
    inbox = tmsg.combine_inbox_gather(recv, tgb["ib_lo"], tgb["ib_hub_idx"],
                                      tgb["ib_hub"], v_max, combine)
    oracle = tmsg.combine_inbox(recv, tmsg.route_local(oi), v_max, combine)
    jinbox = jax.vmap(lambda iv, lo, hi, h: jmsg.combine_inbox_gather(
        iv, lo, hi, h, v_max, combine))(
            jnp.asarray(recv.contiguous().numpy()), jgb["ib_lo"],
            jgb["ib_hub_idx"], jgb["ib_hub"])
    if combine == "sum":    # the lane sums may associate differently
        np.testing.assert_allclose(inbox.numpy(), oracle.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(inbox.numpy(), np.asarray(jinbox),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(inbox.numpy(), oracle.numpy())
        assert np.array_equal(inbox.numpy(), np.asarray(jinbox))
    if name == "social":
        assert bool((tgb["ib_hub_idx"] != -1).any())   # hub merge is live


@pytest.mark.parametrize("name", ["small", "social"])
def test_compact_pack_and_unpack_match_jax(blocks, name):
    pg, jgb, tgb = blocks[name]
    rng = np.random.default_rng(9)
    vals, send = _messages(rng, pg)
    P, cap = pg.num_parts, pg.mailbox_cap
    tv, ts = torch.from_numpy(vals), torch.from_numpy(send)
    act = tmsg.active_slots(ts, tgb["ob_inv"], P, cap)
    jact = jax.vmap(lambda s, o: jmsg.active_slots(s, o, P, cap))(
        jnp.asarray(send), jgb["ob_inv"])
    assert np.array_equal(act.numpy(), np.asarray(jact))
    pv, pinv, counts = tmsg.build_outbox_compact(tv, ts, tgb["ob_inv"], P,
                                                 cap, "min")
    jpv, jpinv, jcounts = jax.vmap(lambda v, s, o: jmsg.build_outbox_compact(
        v, s, o, P, cap, "min"))(jnp.asarray(vals), jnp.asarray(send),
                                 jgb["ob_inv"])
    for a, b in ((pv, jpv), (pinv, jpinv), (counts, jcounts)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the receiver rebuilds exactly the dense slots
    dense = tmsg.build_outbox_gather(tv, ts, tgb["ob_inv"], P, cap, "min")
    got = tmsg.unpack_slots(tmsg.route_local(pv), tmsg.route_local(pinv),
                            "min")
    assert np.array_equal(got.numpy(), tmsg.route_local(dense).numpy())


def test_unported_routes_name_their_items(tmp_path):
    """The mesh routes are ported (ROADMAP A8.1): on a one-rank gloo world
    ``route_shard_map`` runs its all_to_all and delivers what
    ``route_local`` does, for slot values, int32 slot maps and a query
    batch's trailing Q; 4 gloo ranks are held against the JAX package in
    tests/test_torch_mesh.py."""
    from _mesh_world import one_rank_world
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((3, 3, 5)).astype(np.float32)),
          torch.from_numpy(rng.integers(-1, 5, (3, 3, 5)).astype(np.int32)),
          torch.from_numpy(rng.standard_normal((3, 3, 5, 2))
                           .astype(np.float32))]
    with one_rank_world(tmp_path) as mesh:
        for x in xs:
            got = tmsg.route_shard_map(x, mesh.get_group())
            assert got.dtype == x.dtype
            assert torch.equal(got, tmsg.route_local(x))
