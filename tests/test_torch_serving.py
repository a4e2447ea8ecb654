"""The port's query-batched serving path against the JAX package's, on the
CPU through the plain versions.

The two-bin multi-vector sweeps and the multi-bin ELL (``kernels.ops``),
the fused batched superstep (``kernels.megastep``), K5's query-batched
pack and the batched mailbox (``core.messages``), ``run_queries`` on every
local exchange (megastep, dense, compact, tiered with its dense rerun,
phased), the vertex-centric and bounded fixpoints, max_first reachability,
personalized PageRank and ``incremental_sssp_batched``. Min/max results
are BIT-identical with equal supersteps, ``query_supersteps``,
``local_iters`` and ``count_hist``; PageRank is allclose at the JAX
package's own tolerance (rtol=1e-6, atol=1e-9). The graphs are
``tests/test_serving.py``'s, in 4 partitions; each JAX run happens once.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core.engine import graph_block as j_graph_block  # noqa: E402
from repro.core.tiers import TierPlan as JTierPlan  # noqa: E402
from repro.gofs import (bfs_grow_partition, hash_partition,  # noqa: E402
                        powerlaw_social, road_grid)
from repro.gofs.formats import Graph, partition_graph  # noqa: E402
from repro.kernels import megastep as jmega  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.core import messages as jmsg  # noqa: E402
import repro.serving as jsrv  # noqa: E402
from repro.algorithms.incremental import \
    incremental_sssp_batched as j_incremental  # noqa: E402
from repro.core.blocks import host_graph_block as j_host_block  # noqa: E402
from repro.gofs.temporal import EdgeDelta as JDelta  # noqa: E402
from repro.gofs.temporal import apply_delta as j_apply  # noqa: E402

import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.serving as tsrv  # noqa: E402
from repro_torch.core import (GopherEngine, TierPlan,  # noqa: E402
                              device_block, graph_block, host_graph_block)
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.gofs import EdgeDelta, apply_delta  # noqa: E402
from repro_torch.gofs.formats import (PAD,  # noqa: E402
                                      partitioned_graph_from_fields)
from repro_torch.kernels import megastep as tmega  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import outbox_pack_ref  # noqa: E402

SOURCES = [0, 7, 113, 200, 341]          # the social graph's SSSP batch
ROAD_SOURCES = [0, 5, 60, 120]           # the road grid's BFS batch
EXCHANGES = ["megastep", "dense", "compact", "tiered", "phased"]
TELEMETRY = ("supersteps", "local_iters", "changed_hist", "query_supersteps",
             "count_hist", "messages_sent", "wire_slots", "bytes_on_wire",
             "pair_slots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(pg):
    return partitioned_graph_from_fields(dataclasses.asdict(pg))


@pytest.fixture(scope="module")
def graphs():
    """name: (JAX pg, port pg, sources): the social graph weighted (SSSP),
    the road grid with unit weights (BFS)."""
    g = powerlaw_social(600, m=4, seed=2)
    social = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    g = road_grid(14, 14, drop_frac=0.05, seed=1)
    road = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    return {"social": (social, _port(social), SOURCES),
            "road": (road, _port(road), ROAD_SOURCES)}


def _narrow_plans(pg, tpg):
    """A too-narrow tier plan for each package (every pair cold, width 1),
    built from the same structural occupancy: the tiered run spills."""
    occ = np.asarray(j_host_block(pg)["wire_ewma"])
    zero = np.zeros_like(occ)
    return (JTierPlan.build(zero, occ, pg.mailbox_cap),
            TierPlan.build(zero, occ, tpg.mailbox_cap))


def _tele_equal(t, jt, what):
    for k in TELEMETRY:
        a, b = getattr(t, k), getattr(jt, k)
        if b is None:
            assert a is None, (what, k)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), (what, k)


def _gather1(pg, per_part):
    out = np.full(pg.n_global, np.inf, np.float32)
    for p in range(pg.num_parts):
        m = pg.vmask[p]
        out[pg.global_id[p][m]] = per_part[p][m]
    return out


# ---------------- kernels.ops: the serving sweeps, the multi-bin ELL ------

def test_binned_sweeps_match_jax_on_hub_rows():
    """``binned_ell_spmv_multi`` (all three semirings), its frontier form
    and ``bin_rows_by_degree``/``multibin_spmv`` against the JAX package's
    on a star wired into a ring, whose hub rows use the hub bin."""
    n = 400
    star = np.arange(1, 1 + n // 2)
    src = np.concatenate([np.zeros(star.size, np.int64), np.arange(n - 1)])
    dst = np.concatenate([star, np.arange(1, n)])
    g = Graph.from_edges(n, src, dst, directed=False)
    pg = partition_graph(g, hash_partition(g, 4, seed=0), 4)
    hb = j_host_block(pg)
    assert (hb["adj_hub_idx"] != PAD).any(), "the star must make hub rows"
    rng = np.random.default_rng(0)
    Q = 4
    x = rng.uniform(0.0, 5.0, (pg.v_max, Q)).astype(np.float32)
    x[::13, 1] = np.inf
    f = rng.random((pg.v_max, Q)) < 0.3
    keys = ("nbr_lo", "wgt_lo", "adj_hub_idx", "adj_hub_nbr", "adj_hub_wgt")
    for p in range(pg.num_parts):
        arrs = [hb[k][p] for k in keys]
        targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
        for sr in ("min_plus", "max_first", "plus_times"):
            want = np.asarray(jops.binned_ell_spmv_multi(
                jnp.asarray(x), *map(jnp.asarray, arrs), sr))
            got = tops.binned_ell_spmv_multi(torch.from_numpy(x), *targs,
                                             sr).numpy()
            if sr == "plus_times":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                assert np.array_equal(got, want), (p, sr)
                want = np.asarray(jops.binned_ell_spmv_multi_frontier(
                    jnp.asarray(x), jnp.asarray(f),
                    *map(jnp.asarray, arrs), sr))
                got = tops.binned_ell_spmv_multi_frontier(
                    torch.from_numpy(x), torch.from_numpy(f), *targs, sr)
                assert np.array_equal(got.numpy(), want), (p, sr)
    # the multi-bin ELL over partition 0's full ELL, boundaries (2, 8)
    nbr, wgt = pg.nbr[0], pg.wgt[0]
    jbins = jops.bin_rows_by_degree(nbr, wgt, boundaries=(2, 8))
    tbins = tops.bin_rows_by_degree(nbr, wgt, boundaries=(2, 8))
    assert len(tbins) == len(jbins) >= 2
    for tb, jb in zip(tbins, jbins):
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for sr in ("min_plus", "max_first", "plus_times"):
        want = np.asarray(jops.multibin_spmv(jnp.asarray(x[:, 0]), jbins,
                                             pg.v_max, sr, backend="jnp"))
        got = tops.multibin_spmv(torch.from_numpy(x[:, 0]), tbins, pg.v_max,
                                 sr).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if sr != "plus_times":
            assert np.array_equal(got, want), sr


# ---------------- kernels.megastep: the fused batched superstep ----------

def test_batched_superstep_matches_jax(graphs):
    """``compose_mailbox(adjacency='binned')``, ``deliver_flat`` and
    ``round_stats`` on (n, Q) values, ``sweep_flat_batched`` and two
    ``megastep_semiring_batched`` supersteps against the JAX package's."""
    pg, tpg, srcs = graphs["social"]
    jgb = j_graph_block(pg)
    jcm = jmega.compose_mailbox(jgb, adjacency="binned")
    tcm = tmega.compose_mailbox(graph_block(tpg, "cpu", binned=True),
                                adjacency="binned")
    n = tcm["n"]
    ok = np.asarray(jcm["nbr_lo_ok"])
    assert np.array_equal(tcm["nbr_lo"].numpy() != PAD, ok)
    assert np.array_equal(tcm["nbr_lo"].numpy()[ok],
                          np.asarray(jcm["nbr_lo"])[ok])
    assert np.array_equal(
        np.where(tcm["adj_hub_idx"].numpy() == PAD, n,
                 tcm["adj_hub_idx"].numpy()), np.asarray(jcm["ahub_dst"]))
    Q = len(srcs)
    x0 = jsrv.sssp_query_init(pg, srcs).reshape(n, Q)
    seed = np.broadcast_to(pg.vmask.reshape(n, 1), (n, Q)).copy()
    j = (jnp.asarray(x0), jnp.asarray(seed), jnp.asarray(seed))
    t = (torch.from_numpy(x0), torch.from_numpy(seed),
         torch.from_numpy(seed.copy()))
    statics = {k: jcm[k] for k in jmega.MAILBOX_STATICS}
    jstep = jax.jit(lambda x, ch, fr, cm: jmega.megastep_semiring_batched(
        x, ch, fr, {**cm, **statics}, "min_plus", unroll=2))
    arrays = {k: v for k, v in jcm.items() if k not in statics}
    for step in range(2):
        want = jstep(*j, arrays)
        got = tmega.megastep_semiring_batched(*t, tcm, "min_plus", unroll=2)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), step
        for a, b in zip(tmega.round_stats(got[1], tcm),
                        jmega.round_stats(want[1], jcm)):
            assert np.array_equal(a.numpy(), np.asarray(b)), step
        inbox = tmega.deliver_flat(got[0], got[1], tcm, "min", True)
        jin = jmega.deliver_flat(want[0], want[1], jcm, "min", True)
        assert np.array_equal(inbox.numpy(), np.asarray(jin)), step
        j, t = want[:3], got[:3]
    y = tmega.sweep_flat_batched(t[0], t[2] | t[1], tcm, "min_plus")
    jy = jmega.sweep_flat_batched(j[0], j[2] | j[1], jcm, "min_plus")
    assert np.array_equal(y.numpy(), np.asarray(jy))


# ---------------- K5's batched pack and the batched mailbox --------------

def test_batched_pack_and_mailbox_match_jax(graphs):
    """``outbox_pack`` on (R, cap, Q) values against the JAX package's
    plain version and its Pallas kernel in interpret mode (the plan, then
    the masked scatter); the batched gather/compact outbox, the unpack and
    the inbox combine against the JAX package's per partition."""
    rng = np.random.default_rng(4)
    R, cap, Q = 12, 40, 3
    active = rng.random((R, cap)) < 0.4
    vals = rng.uniform(-5.0, 5.0, (R, cap, Q)).astype(np.float32)
    vals[rng.random((R, cap, Q)) < 0.1] = np.inf
    limit = rng.integers(0, cap + 2, R).astype(np.int32)
    got = outbox_pack_ref(torch.from_numpy(vals), torch.from_numpy(active),
                          torch.from_numpy(limit), np.inf)
    args = (jnp.asarray(vals), jnp.asarray(active), jnp.asarray(limit))
    for want in (jref.outbox_pack_ref(*args, np.inf),
                 jops.outbox_pack(*args, np.inf, backend="pallas")):
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    pg, tpg, _ = graphs["social"]
    jgb = j_graph_block(pg)
    tgb = graph_block(tpg, "cpu")
    P, cap, v_max = pg.num_parts, pg.mailbox_cap, pg.v_max
    vals = rng.uniform(0.0, 9.0, (P, pg.r_max, Q)).astype(np.float32)
    send = rng.random((P, pg.r_max, Q)) < 0.5
    tv, ts = torch.from_numpy(vals), torch.from_numpy(send)
    sv = tmsg.build_outbox_gather_batched(tv, ts, tgb["ob_inv"], P, cap, "min")
    pv, pinv, counts = tmsg.build_outbox_compact_batched(
        tv, ts, tgb["ob_inv"], P, cap, "min")
    act = tmsg.active_slots(ts, tgb["ob_inv"], P, cap)
    for p in range(P):
        jargs = (jnp.asarray(vals[p]), jnp.asarray(send[p]), jgb["ob_inv"][p])
        assert np.array_equal(sv[p].numpy(), np.asarray(
            jmsg.build_outbox_gather_batched(*jargs, P, cap, "min")))
        for a, b in zip((pv[p], pinv[p], counts[p]),
                        jmsg.build_outbox_compact_batched(*jargs, P, cap,
                                                          "min")):
            assert np.array_equal(a.numpy(), np.asarray(b)), p
        assert np.array_equal(act[p].numpy(), np.asarray(
            jmsg.active_slots(jargs[1], jargs[2], P, cap)))
    # the receiver rebuilds exactly the dense slots, and both combines agree
    dense = tmsg.route_local(sv)
    assert torch.equal(tmsg.unpack_slots_batched(
        tmsg.route_local(pv), tmsg.route_local(pinv), "min"), dense)
    inbox = tmsg.combine_inbox_gather_batched(
        dense, tgb["ib_lo"], tgb["ib_hub_idx"], tgb["ib_hub"], v_max, cap,
        "min")
    jdense = np.asarray(dense)
    for p in range(P):
        want = jmsg.combine_inbox_gather_batched(
            jnp.asarray(jdense[p]), jgb["ib_lo"][p], jgb["ib_hub_idx"][p],
            jgb["ib_hub"][p], v_max, cap, "min")
        assert np.array_equal(inbox[p].numpy(), np.asarray(want)), p


# ---------------- run_queries on every local exchange --------------------

@pytest.fixture(scope="module")
def jax_runs(graphs):
    """(graph, exchange, plan) -> the JAX package's run_queries (state x,
    Telemetry): the social graph on every exchange, the tiered one also
    with the too-narrow plan (plan 1); the road grid on 'megastep'."""
    out = {}
    for name, (pg, tpg, srcs) in graphs.items():
        x0 = jsrv.sssp_query_init(pg, srcs)
        for ex in EXCHANGES if name == "social" else ["megastep"]:
            plans = [None]
            if ex == "tiered":
                plans.append(_narrow_plans(pg, tpg)[0])
            for k, plan in enumerate(plans):
                prog = jsrv.BatchedSemiringProgram("min_plus", len(srcs))
                st, t = JEngine(pg, prog, exchange=ex,
                                tier_plan=plan).run_queries(
                    extra={"qinit": x0})
                out[name, ex, k] = (np.asarray(st["x"]), t)
    return out


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_run_queries_matches_jax(graphs, jax_runs, exchange):
    """SSSP on the social graph (and on 'megastep', what 'auto' gives, BFS
    on the road grid): every lane bit-equal to the JAX package's with
    equal telemetry; on 'megastep' each lane also equals a scalar run from
    its source, which converged no later than the batch; the too-narrow
    tiered plan spills, reruns dense and escalates as the JAX package's
    does."""
    for name, (pg, tpg, srcs) in graphs.items():
        if (name, exchange, 0) not in jax_runs:
            continue
        plans = [None]
        if exchange == "tiered":
            plans.append(_narrow_plans(pg, tpg)[1])
        for k, plan in enumerate(plans):
            eng = GopherEngine(tpg, tsrv.BatchedSemiringProgram(
                "min_plus", len(srcs)), exchange=exchange, tier_plan=plan,
                device="cpu")
            st, t = eng.run_queries(
                extra={"qinit": tsrv.sssp_query_init(tpg, srcs)})
            jx, jt = jax_runs[name, exchange, k]
            assert t.exchange == jt.exchange == exchange
            assert np.array_equal(st["x"], jx), (name, k)
            _tele_equal(t, jt, (name, k))
            assert (t.retried, t.spills, t.escalations) == (
                jt.retried, jt.spills, jt.escalations)
            if k:
                assert t.retried and t.spills > 0
        if exchange != "megastep":
            continue
        res = tsrv.gather_query_results(tpg, st["x"])
        fn = talg.sssp if name == "social" else talg.bfs
        for q, s in enumerate(srcs):
            d, ts_ = fn(tpg, s, device="cpu")
            assert np.array_equal(res[q], _gather1(tpg, d)), (name, q)
            assert t.query_supersteps[q] <= t.supersteps
            assert ts_.supersteps <= t.supersteps


def test_vertex_mode_reachability_and_ppr_match_jax(graphs):
    """``max_local_iters`` 1 and 3 on 'dense' and 'compact'; max_first
    multi-seed reachability on 'auto'; personalized PageRank (the staged
    dense route 'auto' gives it) allclose at the JAX package's tolerance
    with equal supersteps and query_supersteps."""
    pg, tpg, srcs = graphs["road"]
    x0 = jsrv.sssp_query_init(pg, srcs)
    for mli in (1, 3):
        for ex in ("dense", "compact"):
            jst, jt = JEngine(pg, jsrv.BatchedSemiringProgram(
                "min_plus", len(srcs), max_local_iters=mli),
                exchange=ex).run_queries(extra={"qinit": x0})
            st, t = GopherEngine(tpg, tsrv.BatchedSemiringProgram(
                "min_plus", len(srcs), max_local_iters=mli), exchange=ex,
                device="cpu").run_queries(extra={"qinit": x0})
            assert np.array_equal(st["x"], np.asarray(jst["x"])), (mli, ex)
            _tele_equal(t, jt, (mli, ex))
    seeds = [(0, 77, 150), (5,), (60, 61)]
    xm = np.where(np.isfinite(jsrv.reachability_query_init(pg, seeds)), 1.0,
                  -np.inf).astype(np.float32)
    jst, jt = JEngine(pg, jsrv.BatchedSemiringProgram(
        "max_first", len(seeds))).run_queries(extra={"qinit": xm})
    st, t = GopherEngine(tpg, tsrv.BatchedSemiringProgram(
        "max_first", len(seeds)), device="cpu").run_queries(
        extra={"qinit": xm})
    assert np.array_equal(st["x"], np.asarray(jst["x"]))
    _tele_equal(t, jt, "max_first")
    pg, tpg, _ = graphs["social"]
    srcs, iters = [3, 77, 240], 15
    seed = jsrv.ppr_query_seed(pg, srcs)
    jst, jt = JEngine(pg, jsrv.BatchedPersonalizedPageRank(
        pg.n_global, len(srcs), num_iters=iters),
        max_supersteps=64).run_queries(extra={"qseed": seed})
    st, t = GopherEngine(tpg, tsrv.BatchedPersonalizedPageRank(
        tpg.n_global, len(srcs), num_iters=iters), max_supersteps=64,
        device="cpu").run_queries(extra={"qseed": seed})
    assert t.exchange == jt.exchange == "dense"
    assert t.supersteps == jt.supersteps == iters
    assert np.array_equal(t.query_supersteps, jt.query_supersteps)
    assert t.messages_sent == jt.messages_sent
    np.testing.assert_allclose(st["r"], np.asarray(jst["r"]), rtol=1e-6,
                               atol=1e-9)


def test_incremental_sssp_batched_matches_jax(graphs):
    """After inserts and after a removal: the resumed lanes equal the JAX
    package's with equal telemetry, and a cold batched run on the new
    graph, on the patched block with its binned adjacency."""
    pg, tpg, srcs = graphs["road"]
    Q = len(srcs)
    x0 = jsrv.sssp_query_init(pg, srcs)
    prev = tsrv.gather_query_results(tpg, GopherEngine(
        tpg, tsrv.BatchedSemiringProgram("min_plus", Q),
        device="cpu").run_queries(extra={"qinit": x0})[0]["x"])
    csr = road_grid(14, 14, drop_frac=0.05, seed=1).csr()
    u = 20
    v = int(csr.indices[csr.indptr[u]])
    deltas = {"insert": ([0, 3, 40], [100, 150, 190], None),
              "removal": None}
    for kind, ins in deltas.items():
        if kind == "insert":
            jd, td = JDelta.inserts(*ins), EdgeDelta.inserts(*ins)
        else:
            jd, td = JDelta.removes([u], [v]), EdgeDelta.removes([u], [v])
        jr = j_apply(pg, jd, block=j_host_block(pg))
        tr = apply_delta(tpg, td, block=host_graph_block(tpg))
        jdist, jt = j_incremental(jr.pg, srcs, prev, jr)
        dist, t = talg.incremental_sssp_batched(
            tr.pg, srcs, prev, tr, gb=device_block(tr.block, "cpu",
                                                   binned=True),
            device="cpu")
        assert np.array_equal(dist, jdist), kind
        _tele_equal(t, jt, kind)
        cold, _ = GopherEngine(tr.pg, tsrv.BatchedSemiringProgram(
            "min_plus", Q), device="cpu").run_queries(
            extra={"qinit": tsrv.sssp_query_init(tr.pg, srcs)})
        assert np.array_equal(dist, tsrv.gather_query_results(
            tr.pg, cold["x"])), kind
        if kind == "insert":                  # the shortcuts shorten paths
            assert not np.array_equal(dist, prev)
