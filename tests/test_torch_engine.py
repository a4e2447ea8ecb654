"""The port's engine and algorithms against the JAX package's and scipy.

CC/SSSP/BFS/MaxVertex are BIT-identical to the JAX ``megastep`` and
``dense`` runs with equal telemetry; PageRank is allclose (rtol=1e-5,
atol=1e-7, the JAX package's own fused-vs-dense tolerance) with equal
supersteps. The JAX runs are cached per module so each compiles once.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.algorithms as jalg  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import init_max_vertex as j_init_max_vertex  # noqa: E402
from repro.core import make_sssp_init as j_make_sssp_init  # noqa: E402
from repro.gofs import bfs_grow_partition, road_grid  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402

import repro_torch.algorithms as talg  # noqa: E402
from repro_torch.core import (GopherEngine, PageRankProgram,  # noqa: E402
                              PhasedTierPlan, SemiringProgram,
                              init_max_vertex)
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serving import (BatchedSemiringProgram,  # noqa: E402
                                 sssp_query_init)
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402

GRAPHS = {
    "small": dict(rows=10, cols=11, drop_frac=0.06, seed=3, weighted=True),
    "mid": dict(rows=40, cols=40, drop_frac=0.06, seed=3, weighted=True),
}
TELEMETRY = ("supersteps", "local_iters", "changed_hist", "pair_slots",
             "count_hist", "messages_sent")


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
    for name, kw in GRAPHS.items():
        g = road_grid(**kw)
        pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
        out[name] = (g, pg, partitioned_graph_from_fields(
            dataclasses.asdict(pg)))
    return out


@pytest.fixture(scope="module")
def jax_runs(graphs):
    """Lazily computed JAX results, keyed (graph, algorithm, exchange)."""
    cache = {}

    def get(name, algo, exchange):
        key = (name, algo, exchange)
        if key not in cache:
            _, pg, _ = graphs[name]
            if exchange == "megastep":     # the public functions run 'auto'
                if algo == "cc":
                    lab, _, t = jalg.connected_components(pg)
                    cache[key] = (lab, t)
                else:
                    cache[key] = jalg.sssp(pg, 0)
            else:
                init = (j_init_max_vertex if algo == "cc" else
                        j_make_sssp_init(int(pg.part_of[0]),
                                         int(pg.local_of[0])))
                prog = JSemiring(semiring="max_first" if algo == "cc"
                                 else "min_plus", init_fn=init)
                s, t = JEngine(pg, prog, exchange=exchange).run()
                x = np.asarray(s["x"])
                if algo == "cc":
                    x = np.where(pg.vmask, x, -1).astype(np.int64)
                else:
                    x = np.where(pg.vmask, x, np.inf)
                cache[key] = (x, t)
        return cache[key]
    return get


def _gather(pg, per_part):
    """(P, v_max) -> (n,) global order."""
    out = np.zeros(pg.n_global, per_part.dtype)
    for p in range(pg.num_parts):
        m = pg.vmask[p]
        out[pg.global_id[p][m]] = per_part[p][m]
    return out


# ---------------- auto resolution and refusals ----------------

def test_auto_resolves_megastep_on_local(graphs):
    _, _, tpg = graphs["small"]
    cc = SemiringProgram(semiring="max_first", init_fn=init_max_vertex)
    assert GopherEngine(tpg, cc, device="cpu").exchange == "megastep"
    pr = PageRankProgram(n_global=tpg.n_global, num_iters=8)
    assert GopherEngine(tpg, pr, device="cpu").exchange == "megastep"
    # programs the JAX engine routes 'dense' take the staged dense route
    bounded = SemiringProgram(semiring="max_first", init_fn=init_max_vertex,
                              max_local_iters=1)
    assert GopherEngine(tpg, bounded, device="cpu").exchange == "dense"
    pr_tol = PageRankProgram(n_global=tpg.n_global, num_iters=8, tol=1e-6)
    assert GopherEngine(tpg, pr_tol, device="cpu").exchange == "dense"
    with pytest.raises(ValueError, match="eligible"):
        GopherEngine(tpg, bounded, exchange="megastep", device="cpu")


def test_default_device_needs_a_card(graphs, monkeypatch):
    _, _, tpg = graphs["small"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talg.connected_components(tpg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GopherEngine(tpg, SemiringProgram(semiring="max_first",
                                          init_fn=init_max_vertex))


def _cc_program():
    return SemiringProgram(semiring="max_first", init_fn=init_max_vertex)


# options of the JAX package, each with what the port's refusal names, or
# None once a slice has ported the option: then it runs
UNSUPPORTED = {
    "cc_vertex_mode": (lambda pg: talg.connected_components(
        pg, mode="vertex", device="cpu"), None),
    "sssp_bounded": (lambda pg: talg.sssp(pg, 0, max_local_iters=2,
                                          device="cpu"), None),
    "max_vertex_vertex_mode": (lambda pg: talg.max_vertex(
        pg, mode="vertex", device="cpu"), None),
    "bfs_spmv_backend": (lambda pg: talg.bfs(pg, 0, spmv_backend="jnp",
                                             device="cpu"), "device"),
    "pagerank_tol": (lambda pg: talg.pagerank(pg, tol=1e-6, device="cpu"),
                     None),
    "blockrank": (lambda pg: talg.blockrank(pg, device="cpu"), None),
    "shard_map": (lambda pg: _one_rank_run(pg), None),
    "dense": (lambda pg: GopherEngine(pg, _cc_program(), exchange="dense",
                                      device="cpu").run(), None),
    "compact": (lambda pg: GopherEngine(pg, _cc_program(),
                                        exchange="compact",
                                        device="cpu").run(), None),
    "tiered": (lambda pg: GopherEngine(pg, _cc_program(), exchange="tiered",
                                       device="cpu").run(), None),
    "phased": (lambda pg: GopherEngine(pg, _cc_program(), exchange="phased",
                                       device="cpu").run(), None),
    "tier_plan": (lambda pg: GopherEngine(
        pg, _cc_program(), tier_plan=PhasedTierPlan.from_graph(pg),
        device="cpu").run(), None),
    "tracer": (lambda pg: GopherEngine(pg, _cc_program(), tracer=Tracer(),
                                       device="cpu").run(), None),
    "checkpointer": (lambda pg: _checkpointed_run(pg), None),
    "extra": (lambda pg: GopherEngine(
        pg, SemiringProgram("max_first", resume=True), device="cpu").run(
        extra={"x0": np.where(pg.vmask, pg.global_id, -np.inf),
               "frontier0": pg.vmask}), None),
    "run_queries": (lambda pg: GopherEngine(
        pg, BatchedSemiringProgram("min_plus", 2), device="cpu").run_queries(
        extra={"qinit": sssp_query_init(pg, [0, 1])}), None),
}


def _one_rank_run(pg):
    """The multi-device backend (ROADMAP A8.1) on a one-rank gloo world,
    equal to the local run; tests/test_torch_mesh.py holds 4 ranks against
    the JAX package."""
    from _mesh_world import one_rank_world
    with tempfile.TemporaryDirectory() as d, one_rank_world(d) as mesh:
        s, t = GopherEngine(pg, _cc_program(), backend="shard_map",
                            mesh=mesh, device="cpu").run()
    sl, tl = GopherEngine(pg, _cc_program(), exchange="dense",
                          device="cpu").run()
    assert np.array_equal(s["x"], sl["x"]) and t.supersteps == tl.supersteps


def _checkpointed_run(pg):
    with tempfile.TemporaryDirectory() as d:
        return GopherEngine(pg, _cc_program(), device="cpu").run(
            checkpointer=Checkpointer(d), checkpoint_every=2)


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_options_raise(graphs, case):
    """An option the port has not ported raises NotImplementedError naming
    its ROADMAP item; one a slice has ported since runs."""
    _, _, tpg = graphs["small"]
    fn, refusal = UNSUPPORTED[case]
    if refusal is None:
        fn(tpg)
    else:
        with pytest.raises(NotImplementedError, match=refusal):
            fn(tpg)


# ---------------- parity with the JAX engine ----------------

@pytest.mark.parametrize("algo", ["cc", "sssp"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_semiring_bit_identity_and_telemetry(graphs, jax_runs, name, algo):
    _, _, tpg = graphs[name]
    if algo == "cc":
        x, _, t = talg.connected_components(tpg, device="cpu")
    else:
        x, t = talg.sssp(tpg, 0, device="cpu")
    jx_mega, jt_mega = jax_runs(name, algo, "megastep")
    jx_dense, jt_dense = jax_runs(name, algo, "dense")
    assert np.array_equal(x, jx_mega)
    assert np.array_equal(x, jx_dense)
    for field in TELEMETRY:
        assert np.array_equal(getattr(t, field), getattr(jt_mega, field)), \
            field
    for field in ("supersteps", "local_iters", "changed_hist"):
        assert np.array_equal(getattr(t, field), getattr(jt_dense, field)), \
            field
    assert t.wire_slots == 0 and t.bytes_on_wire == 0
    assert t.exchange == "megastep"


def test_pagerank_allclose(graphs):
    _, pg, tpg = graphs["small"]
    r, t = talg.pagerank(tpg, num_iters=15, device="cpu")
    jr, jt = jalg.pagerank(pg, num_iters=15)
    assert t.supersteps == jt.supersteps == 15
    np.testing.assert_allclose(r, jr, rtol=1e-5, atol=1e-7)
    for field in ("local_iters", "changed_hist", "pair_slots", "count_hist",
                  "messages_sent"):
        assert np.array_equal(getattr(t, field), getattr(jt, field)), field
    assert t.wire_slots == 0


def test_max_vertex_and_bfs_match_jax(graphs):
    g, pg, tpg = graphs["small"]
    x, t = talg.max_vertex(tpg, device="cpu")
    jx, jt = jalg.max_vertex(pg)
    assert np.array_equal(x, jx) and t.supersteps == jt.supersteps
    # BFS needs unit weights: the unweighted build of the same grid
    ug = road_grid(**{**GRAPHS["small"], "weighted": False})
    upg = partition_graph(ug, bfs_grow_partition(ug, 4, seed=0), 4)
    lvl, t = talg.bfs(partitioned_graph_from_fields(dataclasses.asdict(upg)),
                      5, device="cpu")
    jl, jt = jalg.bfs(upg, 5)
    assert np.array_equal(lvl, jl) and t.supersteps == jt.supersteps
    hops = csgraph.shortest_path(ug.undirected_csr(), unweighted=True,
                                 indices=[5])[0]
    assert np.array_equal(_gather(upg, lvl), hops.astype(np.float32))


# ---------------- the algorithms against scipy ----------------

def test_algorithms_match_scipy(graphs):
    g, pg, tpg = graphs["mid"]
    labels, ncc, _ = talg.connected_components(tpg, device="cpu")
    ncc_true, lab_true = csgraph.connected_components(g.undirected_csr(),
                                                      directed=False)
    assert ncc == ncc_true
    ours = _gather(tpg, labels)
    for c in range(ncc_true):
        assert len(np.unique(ours[lab_true == c])) == 1
    dist, _ = talg.sssp(tpg, 7, device="cpu")
    d_true = csgraph.dijkstra(g.csr().T, indices=[7])[0]    # out-edges
    finite = np.isfinite(d_true)
    got = _gather(tpg, dist)
    np.testing.assert_allclose(got[finite], d_true[finite], rtol=1e-5)
    assert np.array_equal(np.isfinite(got), finite)


def test_pagerank_matches_power_iteration(graphs):
    g, _, tpg = graphs["mid"]
    r, t = talg.pagerank(tpg, num_iters=30, device="cpu")
    A = g.csr()
    A.data[:] = 1.0                    # PageRank ignores the edge weights
    outdeg = g.out_degree.astype(np.float64)
    rr = np.full(g.n, 1.0 / g.n)
    for _ in range(30):
        contrib = np.where(outdeg > 0, rr / np.maximum(outdeg, 1), 0)
        rr = 0.15 / g.n + 0.85 * (A @ contrib + rr[outdeg == 0].sum() / g.n)
    assert t.supersteps == 30
    np.testing.assert_allclose(_gather(tpg, r), rr, rtol=1e-3, atol=1e-6)
