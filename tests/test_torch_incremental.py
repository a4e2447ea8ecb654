"""The port's incremental analytics against the JAX package's, on the CPU
through the plain kernels.

``GopherEngine.run(extra=)`` resumes from a given state and dirty seed on
every exchange of the local backend (megastep, resident, dense, compact,
tiered with its dense rerun, phased), BIT-identical to the JAX package's
dense resume; ``incremental_{connected_components,sssp,bfs}`` after
inserts and after removals are bit-identical to the JAX package's, with
equal supersteps and local_iters, and to the port's cold run on the new
graph, on a block patched by ``apply_delta(block=)`` as on a cold one. The
graphs are ``tests/test_temporal.py``'s: road_grid(22, 22) with 1 %
random inserts, and a weighted road_grid(18, 18) with two inserts and 15
removals. Each JAX run happens once, in a module-scoped fixture.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.algorithms as jalg  # noqa: E402
import repro.gofs as jgofs  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.gofs.formats import partition_graph as j_partition_graph  # noqa: E402

import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.gofs as tgofs  # noqa: E402
from repro_torch.algorithms.incremental import (  # noqa: E402
    _boundary_sources, _meta_reachable)
from repro_torch.core import (GopherEngine, PhasedTierPlan,  # noqa: E402
                              SemiringProgram, TierPlan, device_block,
                              host_graph_block)
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.kernels import megastep as tmega  # noqa: E402
from _patched_versions import patched_versions, resume_all  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _edge_list(g):
    a = g.csr().tocoo()           # row v = dst, col = src
    return a.col, a.row, a.data.astype(np.float32)


def _scenario(name):
    """(JAX pg0, port pg0, JAX delta, port delta, source vertex)."""
    if name == "insert":
        g = jgofs.road_grid(22, 22, drop_frac=0.08, seed=3)
        rng = np.random.default_rng(2)
        num = max(1, (g.nnz // 2) // 100)
        iu, iv = rng.integers(0, g.n, num), rng.integers(0, g.n, num)
        keep = iu != iv
        kw = dict(insert_src=iu[keep], insert_dst=iv[keep])
        src = 3
    else:
        g = jgofs.road_grid(18, 18, drop_frac=0.04, seed=5, weighted=True)
        s0, d0, _ = _edge_list(g)
        und = np.flatnonzero(s0 < d0)
        pick = np.random.default_rng(6).choice(und, 15, replace=False)
        kw = dict(insert_src=[1, 2], insert_dst=[200, 250],
                  insert_wgt=[2.5, 4.0], remove_src=s0[pick],
                  remove_dst=d0[pick])
        src = 0
    jpg = j_partition_graph(g, jgofs.bfs_grow_partition(g, 4, seed=0), 4)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(jpg))
    return jpg, tpg, jgofs.EdgeDelta.of(**kw), tgofs.EdgeDelta.of(**kw), src


@pytest.fixture(scope="module")
def runs():
    """Per scenario: both packages' deltas, the port's cold runs on the old
    and new graphs, and the JAX package's incremental runs from the port's
    old fixpoints (equal to its own: tests/test_torch_engine.py)."""
    out = {}
    for name in ("insert", "removal"):
        jpg0, tpg0, jd, td, src = _scenario(name)
        jres = jgofs.apply_delta(jpg0, jd, directed=False)
        tres = tgofs.apply_delta(tpg0, td, directed=False,
                                 block=host_graph_block(tpg0))
        tpg1 = tres.pg
        r = {"jres": jres, "tres": tres, "tpg0": tpg0, "src": src}
        r["cc_prev"] = talg.connected_components(tpg0, device="cpu")[0]
        r["cc_cold"] = talg.connected_components(tpg1, device="cpu")
        r["cc_jax"] = jalg.incremental_connected_components(
            jres.pg, r["cc_prev"], jres)
        path = "bfs" if name == "insert" else "sssp"
        r["path_prev"] = getattr(talg, path)(tpg0, src, device="cpu")[0]
        r["path_cold"] = getattr(talg, path)(tpg1, src, device="cpu")
        r["path_jax"] = getattr(jalg, f"incremental_{path}")(
            jres.pg, src, r["path_prev"], jres)
        out[name] = r
    return out


def _assert_tele_equal(t, jt):
    assert t.supersteps == jt.supersteps
    assert np.array_equal(t.local_iters, np.asarray(jt.local_iters))


# ---------------- the incremental algorithms ----------------

@pytest.mark.parametrize("scenario", ["insert", "removal"])
def test_incremental_matches_jax_and_cold(scenario, runs):
    """CC and the scenario's path algorithm (BFS after inserts, SSSP after
    removals), each on a cold and on the patched block: bit-equal to the
    JAX package's incremental run, with its supersteps and local_iters,
    and to the port's cold run on the new graph."""
    r = runs[scenario]
    tres = r["tres"]
    pg = tres.pg
    path = "bfs" if scenario == "insert" else "sssp"
    for algo in ("cc", path):
        for block in ("cold", "patched"):
            case = (algo, block)
            gb = device_block(tres.block, "cpu") if block == "patched" \
                else None
            if algo == "cc":
                got, ncc, t = talg.incremental_connected_components(
                    pg, r["cc_prev"], tres, gb=gb, device="cpu")
                want, jncc, jt = r["cc_jax"]
                cold, cold_ncc, ct = r["cc_cold"]
                assert ncc == jncc == cold_ncc, case
            else:
                got, t = getattr(talg, f"incremental_{algo}")(
                    pg, r["src"], r["path_prev"], tres, gb=gb, device="cpu")
                want, jt = r["path_jax"]
                cold, ct = r["path_cold"]
            assert t.exchange == "megastep", case
            assert np.array_equal(got, np.asarray(want)), case
            assert np.array_equal(got, cold), case
            _assert_tele_equal(t, jt)
            if algo == "bfs":   # the resume did less local work than cold
                assert t.local_iters.sum() < ct.local_iters.sum(), case


def test_incremental_refusals(runs, tmp_path):
    """The batched resume runs on a mesh (ROADMAP A8.1: here a one-rank
    gloo world, bit-equal to the local resume with equal Telemetry; a mesh
    is required), and a JAX-only ``spmv_backend`` is refused."""
    from _mesh_world import one_rank_world
    from repro_torch.serving import gather_query_results
    r = runs["removal"]
    srcs = [r["src"], 0]
    prev = gather_query_results(r["tpg0"], np.stack(
        [talg.sssp(r["tpg0"], s, device="cpu")[0] for s in srcs], -1))
    args = (r["tres"].pg, srcs, prev, r["tres"])
    with pytest.raises(ValueError, match="mesh"):
        talg.incremental_sssp_batched(*args, backend="shard_map",
                                      device="cpu")
    want, wt = talg.incremental_sssp_batched(*args, exchange="dense",
                                             device="cpu")
    with one_rank_world(tmp_path) as mesh:
        got, gt = talg.incremental_sssp_batched(
            *args, backend="shard_map", mesh=mesh, device="cpu")
    assert gt.exchange == "dense"       # what 'auto' is on one device
    assert np.array_equal(got, want)
    _assert_tele_equal(gt, wt)
    assert np.array_equal(gt.query_supersteps, wt.query_supersteps)
    r = runs["insert"]
    with pytest.raises(NotImplementedError, match="spmv_backend"):
        talg.incremental_bfs(r["tres"].pg, 3, r["path_prev"], r["tres"],
                             spmv_backend="pallas", device="cpu")


# ---------------- run(extra=) on every exchange ----------------

def _resume_inputs(r):
    """The removal scenario's SSSP resume inputs, as _incremental_run makes
    them: the old distances with the meta-reachable region reset to its cold
    init, the frontier the inserted sources, the reset and its boundary."""
    tres = r["tres"]
    pg = tres.pg
    x0 = np.where(pg.vmask, r["path_prev"], np.inf).astype(np.float32)
    reset = _meta_reachable(pg, tres.dirty_remove)
    init = np.full_like(x0, np.inf)
    init[int(pg.part_of[r["src"]]), int(pg.local_of[r["src"]])] = 0.0
    x0[reset] = init[reset]
    f0 = (tres.dirty_insert | reset | _boundary_sources(pg, reset)) \
        & pg.vmask
    return x0, f0


@pytest.fixture(scope="module")
def dense_resume(runs):
    """The JAX package's dense-route resume of the removal scenario."""
    r = runs["removal"]
    x0, f0 = _resume_inputs(r)
    state, t = JEngine(r["jres"].pg, JSemiring("min_plus", resume=True),
                       exchange="dense").run(
        extra={"x0": x0, "frontier0": f0})
    return np.asarray(state["x"]), t


def _all_cold(pg):
    """The structural tier plan with every carrying pair cut to width 1."""
    base = TierPlan.from_graph(pg)
    t = np.where(base.tiers == ttiers.EXCLUDED, ttiers.EXCLUDED, ttiers.COLD)
    return dataclasses.replace(base, tier_bytes=t.astype(np.int8).tobytes())


EXCHANGES = ["megastep", "resident", "dense", "compact", "tiered",
             "tiered_overflow", "phased"]


def test_run_extra_every_exchange_matches_jax_dense(runs, dense_resume):
    """The removal scenario's SSSP resume on every route of EXCHANGES
    equals the JAX package's dense resume, with its telemetry (the
    resident route aside: it relaxes in rounds from superstep 0)."""
    r = runs["removal"]
    pg = r["tres"].pg
    x0, f0 = _resume_inputs(r)
    want, jt = dense_resume
    for route in EXCHANGES:
        exchange, plan = route, None
        if route == "resident":
            exchange, plan = "megastep", PhasedTierPlan.from_graph(pg)
        elif route == "tiered_overflow":
            exchange, plan = "tiered", _all_cold(pg)
        # the block patched by apply_delta: no init_fn, so a run that lost
        # the resume inputs would fail rather than start cold
        eng = GopherEngine(pg, SemiringProgram("min_plus", resume=True),
                           exchange=exchange, tier_plan=plan,
                           gb=device_block(r["tres"].block, "cpu"),
                           device="cpu")
        extra = {"x0": x0.copy(), "frontier0": f0.copy()}
        state, t = eng.run(extra=extra)
        assert np.array_equal(state["x"], want), route
        assert np.array_equal(extra["x0"], x0), route   # the caller's arrays
        if route == "resident":     # resident from superstep 0: its rounds
            rb = [p.schedule(1).round_bytes(None) for p in plan.phase_plans()]
            assert tmega.resident_enter_round(rb, plan.boundaries) == 0
            assert t.supersteps > jt.supersteps
        else:
            _assert_tele_equal(t, jt)
        if route == "tiered_overflow":
            assert t.spills > 0 and t.retried and t.escalations > 0
        elif route == "tiered":
            assert t.spills == 0 and not t.retried


def test_quiesced_resume_runs_zero_sweeps(runs):
    """A fixpoint resumed with an empty seed halts after one superstep of
    zero local iterations, in every partition, on the fused and the dense
    route."""
    r = runs["insert"]
    pg = r["tpg0"]
    x0 = np.where(pg.vmask, r["path_prev"], np.inf).astype(np.float32)
    for exchange in ("megastep", "dense"):
        eng = GopherEngine(pg, SemiringProgram("min_plus", resume=True),
                           exchange=exchange, device="cpu")
        state, t = eng.run(extra={"x0": x0,
                                  "frontier0": np.zeros_like(pg.vmask)})
        assert t.supersteps == 1, exchange
        assert t.local_iters.sum() == 0, exchange
        assert t.messages_sent == 0, exchange
        assert np.array_equal(state["x"], x0), exchange


def test_engine_cache_survives_resumes(runs):
    """Two resumes through one engine, then a cold run on it: each equals
    a fresh engine's (the extra entries never reach the cached block)."""
    r = runs["removal"]
    pg = r["tres"].pg
    x0, f0 = _resume_inputs(r)
    eng = GopherEngine(pg, SemiringProgram("min_plus", resume=True),
                       device="cpu")
    first, _ = eng.run(extra={"x0": x0, "frontier0": f0})
    quiet, t = eng.run(extra={"x0": first["x"],
                              "frontier0": np.zeros_like(pg.vmask)})
    assert np.array_equal(quiet["x"], first["x"]) and t.supersteps == 1
    assert "x0" not in eng._gb and "x0" not in eng._mega_cm
    assert np.array_equal(first["x"], r["path_cold"][0])


def test_noop_delta_halts_immediately(runs):
    """Re-inserting an existing edge at its weight changes nothing: the
    resume quiesces at once with no real sweep work."""
    r = runs["insert"]
    pg0 = r["tpg0"]
    p, v = np.argwhere(pg0.nbr[:, :, 0] != -1)[0]
    u = int(pg0.global_id[p, pg0.nbr[p, v, 0]])
    res = tgofs.apply_delta(pg0, tgofs.EdgeDelta.inserts(
        [u], [int(pg0.global_id[p, v])], [float(pg0.wgt[p, v, 0])]))
    d, t = talg.incremental_bfs(res.pg, 3, r["path_prev"], res, device="cpu")
    assert np.array_equal(d, r["path_prev"])
    assert t.supersteps <= 2
    assert t.local_iters.sum() <= pg0.num_parts


# ---------------- what the card kernels meet on patched blocks ----------

# smaller cuts of tests/test_torch_cuda.py's PATCHED_GRAPHS
SMALL_GRAPHS = {
    "road": (lambda: tgofs.road_grid(40, 40, seed=4, weighted=True), 4),
    "powerlaw": (lambda: tgofs.powerlaw_social(800, m=5, seed=2), 4),
}


@pytest.mark.parametrize("graph", sorted(SMALL_GRAPHS))
def test_patched_blocks_feed_k3_k4_what_they_need(graph):
    """The versions tests/test_torch_cuda.py resumes on the card, built the
    same way on smaller graphs and run on the CPU: the patched blocks carry PAD holes mid-row in the ELL and the feed
    lists, a promoted hub on both sides and a grown cap; K3's cut lanes
    keep every live lane, K4's feed rows are every row with a feed, each
    version's engine composes its own mailbox at its own cap, and the
    resumes equal cold runs on each version."""
    make, P = SMALL_GRAPHS[graph]
    pg0, res1, res2 = patched_versions(make(), P)
    hb0 = host_graph_block(pg0)
    b1, b2 = res1.block, res2.block
    assert res1.pg.mailbox_cap > pg0.mailbox_cap
    assert b1["ob_inv"].shape[1] == P * res1.pg.mailbox_cap
    for key in ("adj_hub_idx", "ib_hub_idx"):
        assert (b1[key] != -1).sum() > (hb0[key] != -1).sum(), key
    for key in ("nbr", "ib_lo"):
        a = b2[key]
        assert ((a[..., :-1] == -1) & (a[..., 1:] != -1)).any(), key
    for res in (res1, res2):
        gb = device_block(res.block, "cpu")
        eng = GopherEngine(res.pg, SemiringProgram("max_first", resume=True),
                           gb=gb, device="cpu")
        _, cm = eng._gb_for_run()
        assert cm["cap"] == res.pg.mailbox_cap
        nbr, _ = tmega.k3_lanes(cm, "max_first")
        full = cm["nbr"]
        assert torch.equal(nbr, full[:, :nbr.shape[1]])
        assert not bool((full[:, nbr.shape[1]:] != -1).any())
        hb = res.block
        fed = (hb["ib_lo"] != -1).any(2)
        hp, hr = np.nonzero(hb["ib_hub_idx"] != -1)
        fed[hp, hb["ib_hub_idx"][hp, hr]] |= (hb["ib_hub"][hp, hr]
                                              != -1).any(1)
        assert np.array_equal(tmega.feed_rows(cm).numpy(),
                              np.flatnonzero(fed.reshape(-1)))
    got = resume_all(pg0, res1, res2, "cpu")
    for res, (cc, _), (d, _) in ((res1, got[0], got[1]),
                                 (res2, got[2], got[3])):
        assert np.array_equal(cc, talg.connected_components(
            res.pg, device="cpu")[0])
        assert np.array_equal(d, talg.sssp(res.pg, 0, device="cpu")[0])
