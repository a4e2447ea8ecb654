"""The port's tier plans, tiered and phased exchanges and resident mode
against the JAX package's.

The copied ``core/tiers.py`` gives the same plans, tables, bands and taught
profiles; ``route_tiered`` delivers the same slots; ``exchange='tiered'``
and ``'phased'`` runs and ``'megastep'`` runs in resident mode are
BIT-identical for CC/SSSP/BFS/MaxVertex with equal telemetry, and phased
PageRank is allclose (rtol=1e-5, atol=1e-7, the JAX package's fused-vs-dense
tolerance) with equal supersteps. The graph is ``tests/test_phases.py``'s:
road_grid(22, 22, drop_frac=0.08, seed=3), P = 4. Plans cross between the
packages as their plain fields.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core.tiers as jtiers  # noqa: E402
from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import PageRankProgram as JPageRank  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import device_block as j_device_block  # noqa: E402
from repro.core import graph_block as j_graph_block  # noqa: E402
from repro.core import host_graph_block as j_host_graph_block  # noqa: E402
from repro.core import init_max_vertex as j_init_max_vertex  # noqa: E402
from repro.core import make_sssp_init as j_make_sssp_init  # noqa: E402
from repro.core import messages as jmsg  # noqa: E402
from repro.gofs import bfs_grow_partition, road_grid  # noqa: E402
from repro.gofs.formats import Graph, partition_graph  # noqa: E402
from repro.kernels import megastep as jmega  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

import repro_torch.core.tiers as ttiers  # noqa: E402
from repro_torch.core import (GopherEngine, PageRankProgram,  # noqa: E402
                              PhasedTierPlan, SemiringProgram, TierPlan,
                              device_block, graph_block, host_graph_block,
                              init_max_vertex, make_sssp_init)
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.kernels import megastep as tmega  # noqa: E402
from repro_torch.kernels.ref import outbox_pack_ref  # noqa: E402

NO_BOUNDARY = ttiers._NO_BOUNDARY
TELEMETRY = ("supersteps", "local_iters", "changed_hist", "messages_sent",
             "wire_slots", "wire_hist", "bytes_on_wire", "count_hist",
             "pair_slots", "pair_rounds", "exchange", "pair_overflow",
             "spills", "escalations", "retried", "phase_hist",
             "phase_switch_steps", "phase_wire", "phase_pair_slots",
             "dense_retry_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    per process keeps these small CPU tensors from oversubscribing cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _directed(n: int, seed: int):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    keep = src != dst
    return Graph.from_edges(n, src[keep], dst[keep], directed=True)


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX pg, port pg): the road grid, its unit-weight build
    (BFS) and a directed graph (MaxVertex), each in 4 partitions."""
    out = {}
    for name, g in (
            ("road", road_grid(22, 22, drop_frac=0.08, seed=3,
                               weighted=True)),
            ("unit", road_grid(22, 22, drop_frac=0.08, seed=3,
                               weighted=False)),
            ("dir", _directed(484, 5))):
        pg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
        out[name] = (pg, partitioned_graph_from_fields(
            dataclasses.asdict(pg)))
    return out


def _jplan(plan):
    """The JAX package's plan with the same fields as a port plan."""
    cls = (jtiers.PhasedTierPlan if isinstance(plan, PhasedTierPlan)
           else jtiers.TierPlan)
    return cls(**dataclasses.asdict(plan))


def _programs(pg, algo):
    """(JAX program, port program) of ``algo`` on ``pg``."""
    if algo in ("cc", "max_vertex"):
        return (JSemiring(semiring="max_first", init_fn=j_init_max_vertex),
                SemiringProgram("max_first", init_max_vertex))
    if algo == "pagerank":
        return (JPageRank(n_global=pg.n_global, num_iters=12),
                PageRankProgram(n_global=pg.n_global, num_iters=12))
    src = (int(pg.part_of[0]), int(pg.local_of[0]))
    return (JSemiring(semiring="min_plus", init_fn=j_make_sssp_init(*src)),
            SemiringProgram("min_plus", make_sssp_init(*src)))


GRAPH_OF = {"cc": "road", "sssp": "road", "bfs": "unit", "max_vertex": "dir",
            "pagerank": "road"}


def _assert_same_telemetry(t, jt):
    for f in TELEMETRY:
        a, b = getattr(t, f), getattr(jt, f)
        if isinstance(b, (np.ndarray, jax.Array)) or isinstance(
                a, np.ndarray):
            assert a is not None and b is not None, f
            assert np.array_equal(np.asarray(a), np.asarray(b)), f
        else:
            assert a == b, (f, a, b)


@pytest.fixture(scope="module")
def taught(graphs):
    """The road grid's host blocks in both packages, their pair, changed
    and per-band profiles taught by each package's own compact CC run and
    phased CC run: the same observations must teach the same profiles."""
    jpg, tpg = graphs["road"]
    jhb, thb = j_host_graph_block(jpg), host_graph_block(tpg)
    jprog, tprog = _programs(jpg, "cc")
    _, jt = JEngine(jpg, jprog, exchange="compact").run()
    _, tt = GopherEngine(tpg, tprog, exchange="compact", device="cpu").run()
    for hb, t, tiers in ((jhb, jt, jtiers), (thb, tt, ttiers)):
        tiers.update_profile(hb, t.pair_slots, t.pair_rounds)
        tiers.update_changed_profile(hb, t.count_hist)
    return jhb, thb


# ---------------- the copied core/tiers.py ----------------

def _schedule_tables(sched):
    shifts = [(k, g, np.asarray(s), np.asarray(r))
              for tab in (sched.hot_res_shifts, sched.warm_shifts,
                          sched.cold_shifts) for k, g, s, r in tab]
    return ([sched.hot_h, sched.hot_send, sched.hot_recv,
             len(sched.hot_res_shifts), len(sched.warm_shifts),
             len(sched.cold_shifts), sched.round_slots(),
             sched.round_index_slots(), sched.round_bytes(None),
             sched.round_bytes(3), sched.device_round_slots(),
             sorted(sched.kind_byte_budgets(None).items())]
            + [x for sh in shifts for x in sh])


def _assert_same_plan(tp, jp):
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert hash(tp) == hash(jp)
    plans = (zip(tp.phase_plans(), jp.phase_plans())
             if isinstance(tp, PhasedTierPlan) else [(tp, jp)])
    for a, b in plans:
        assert np.array_equal(a.tiers, b.tiers)
        assert np.array_equal(a.limits(), b.limits())
        assert a.counts() == b.counts()
        for D in (1, 2, 4):
            ta, tb = _schedule_tables(a.schedule(D)), _schedule_tables(
                b.schedule(D))
            assert len(ta) == len(tb)
            for x, y in zip(ta, tb):
                if isinstance(x, np.ndarray):
                    assert np.array_equal(x, y)
                else:
                    assert x == y


def test_tier_plans_match_jax(graphs, taught):
    jpg, tpg = graphs["road"]
    jhb, thb = taught
    _assert_same_plan(TierPlan.from_graph(tpg),
                      jtiers.TierPlan.from_graph(jpg))
    _assert_same_plan(TierPlan.from_block(thb),
                      jtiers.TierPlan.from_block(jhb))
    _assert_same_plan(PhasedTierPlan.from_graph(tpg),
                      jtiers.PhasedTierPlan.from_graph(jpg))
    tph = PhasedTierPlan.from_block(thb)
    assert tph.num_phases >= 2
    _assert_same_plan(tph, jtiers.PhasedTierPlan.from_block(jhb))
    _assert_same_plan(PhasedTierPlan.narrow_resume(thb),
                      jtiers.PhasedTierPlan.narrow_resume(jhb))
    _assert_same_plan(PhasedTierPlan.from_tier_plan(TierPlan.from_graph(tpg)),
                      jtiers.PhasedTierPlan.from_tier_plan(
                          jtiers.TierPlan.from_graph(jpg)))
    # escalation: every tier code, an excluded pair jumping to hot
    rng = np.random.default_rng(5)
    P = tpg.num_parts
    codes = rng.integers(0, 4, (P, P)).astype(np.int8)
    base = dataclasses.replace(TierPlan.from_graph(tpg),
                               tier_bytes=codes.tobytes())
    mask = rng.random((P, P)) < 0.5
    up, jup = base.escalate(mask), _jplan(base).escalate(mask)
    _assert_same_plan(up, jup)
    assert up.escalations_from(base) == jup.escalations_from(_jplan(base))
    ph = tph.escalate_phase(tph.num_phases - 1, mask)
    jph = _jplan(tph).escalate_phase(tph.num_phases - 1, mask)
    _assert_same_plan(ph, jph)
    assert ph.escalations_from(tph) == jph.escalations_from(_jplan(tph))


def test_bands_horizon_and_profiles_match_jax(graphs, taught):
    rng = np.random.default_rng(6)
    hists = [None, np.zeros(8), np.array([100.0, 80.0, 30.0, 10.0, 2.0, 0.3]),
             np.array([100.0, 3.0, 90.0, 1.0, 0.0]), rng.random(20) * 50]
    for h in hists:
        for k in (1, 2, 3):
            assert ttiers.phase_bands(h, max_phases=k) == \
                jtiers.phase_bands(h, max_phases=k)
        assert ttiers.expected_horizon(h) == jtiers.expected_horizon(h)
    # the taught blocks agree entry for entry
    jhb, thb = taught
    assert set(jhb) >= set(thb)
    for k in ("wire_ewma", "changed_ewma", "announce_ewma",
              "phase_pair_ewma"):
        assert thb[k].dtype == jhb[k].dtype
        assert np.array_equal(thb[k], jhb[k]), k
    # the three profile folds and the announce on copies of both blocks
    jpg, tpg = graphs["road"]
    jb = {k: np.array(v) for k, v in jhb.items()}
    tb = {k: np.array(v) for k, v in thb.items()}
    P = tpg.num_parts
    obs = rng.integers(0, 40, (P, P))
    pps = rng.integers(0, 40, (3, P, P))
    phist = np.array([0, 0, 1, 1, 1, 2])
    dirty = rng.random(jpg.vmask.shape) < 0.05
    for b, tiers, pg in ((jb, jtiers, jpg), (tb, ttiers, tpg)):
        tiers.announce_frontier(b, pg, dirty)
        tiers.update_phase_profile(b, pps, phist)
        tiers.update_changed_profile(b, [50, 20, 5, 1])
    for k in ("wire_ewma", "changed_ewma", "announce_ewma",
              "phase_pair_ewma"):
        assert np.array_equal(tb[k], jb[k]), k
    _assert_same_plan(PhasedTierPlan.for_resume(tb),
                      jtiers.PhasedTierPlan.for_resume(jb))
    _assert_same_plan(PhasedTierPlan.narrow_resume(tb),
                      jtiers.PhasedTierPlan.narrow_resume(jb))
    _assert_same_plan(PhasedTierPlan.from_block(tb),
                      jtiers.PhasedTierPlan.from_block(jb))
    for b, tiers in ((jb, jtiers), (tb, ttiers)):
        tiers.update_profile(b, obs, 7)
    for k in ("wire_ewma", "announce_ewma"):
        assert np.array_equal(tb[k], jb[k]), k
    assert ttiers.update_profile({}, obs, 3) is None
    assert ttiers.update_changed_profile({}, [1]) is None
    assert ttiers.update_phase_profile({}, pps, phist) is None


def test_device_block_leaves_planning_entries_behind(graphs):
    jpg, tpg = graphs["road"]
    dev = device_block(host_graph_block(tpg), "cpu")
    jdev = j_device_block(j_host_graph_block(jpg))
    assert set(dev) <= set(jdev)      # the binned adjacency is A5's
    assert "wire_ewma" in dev
    for k in ("changed_ewma", "announce_ewma", "phase_pair_ewma"):
        assert k not in dev
    assert np.array_equal(dev["wire_ewma"].numpy(),
                          np.asarray(jdev["wire_ewma"]))


# ---------------- route_tiered ----------------

@pytest.mark.parametrize("plan_kind", ["structural", "random"])
def test_route_tiered_matches_jax(graphs, plan_kind):
    """Random slot values with ±inf, packed with each pair's tier limit,
    routed by both packages: the same received slots, bit for bit, and
    where no pair overflowed, the dense route's."""
    jpg, tpg = graphs["road"]
    P, cap = tpg.num_parts, tpg.mailbox_cap
    plan = TierPlan.from_graph(tpg)
    rng = np.random.default_rng(7)
    if plan_kind == "random":
        codes = rng.integers(0, 4, (P, P)).astype(np.int8)
        plan = dataclasses.replace(plan, tier_bytes=codes.tobytes())
    vals = rng.uniform(-5, 5, (P, P, cap)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = np.inf
    vals[rng.random(vals.shape) < 0.1] = -np.inf
    # active slots are occupied ones, as the engine's send sets make them
    occupied = host_graph_block(tpg)["ob_inv"].reshape(P, P, cap) != -1
    act = (rng.random((P, P, cap)) < 0.3) & occupied
    vals = np.where(act, vals, np.inf).astype(np.float32)
    lim = plan.limits().reshape(-1).astype(np.int32)
    R = P * P
    tv = torch.from_numpy(vals)
    pv, sids, _, _, over = outbox_pack_ref(
        tv.reshape(R, cap), torch.from_numpy(act).reshape(R, cap),
        torch.from_numpy(lim), float("inf"))
    got = tmsg.route_tiered(tv, pv.reshape(P, P, cap),
                            sids.reshape(P, P, cap), plan.schedule(1), "min")
    jpv, jsids, _, _, jover = jops.outbox_pack(
        jnp.asarray(vals).reshape(R, cap), jnp.asarray(act).reshape(R, cap),
        jnp.asarray(lim), float("inf"))
    assert np.array_equal(over.numpy(), np.asarray(jover))
    want = jmsg.route_tiered(
        jnp.asarray(vals)[..., None], jpv.reshape(P, P, cap, 1),
        jsids.reshape(P, P, cap), _jplan(plan).schedule(1), "min")
    assert np.array_equal(got.numpy(), np.asarray(want)[..., 0])
    if plan_kind == "structural":
        assert not over.any()
        # every occupied slot of a routed pair: the dense delivery
        occ = ttiers.occupancy_from_graph(tpg) > 0
        dense = tmsg.route_local(tv).numpy()
        recv = occ.T[:, :, None] & np.ones(cap, bool)
        assert np.array_equal(got.numpy()[recv], dense[recv])
    # over two devices the route needs the mesh's process group (routed
    # over gloo ranks in tests/test_torch_mesh.py); each rank's tables
    # receive exactly its routed pairs, padding into the sink row
    with pytest.raises(ValueError, match="process group"):
        tmsg.route_tiered(tv, pv, sids, plan.schedule(2), "min")
    s2, v = plan.schedule(2), P // 2
    for me in range(2):
        tab = tmsg.tiered_tables(s2, "cpu", me)
        recv = [tab["hot"]] if tab["hot"] is not None else []
        recv += [r for _, r in tab["hot_res"]]
        recv += [r for _, _, r in tab["packed"]]
        got_rows = np.concatenate([r[1].numpy() for r in recv])
        src, dst = np.nonzero(plan.tiers != ttiers.EXCLUDED)
        mine = dst // v == me
        want = (dst[mine] % v) * P + src[mine]
        assert sorted(got_rows[got_rows < v * P]) == sorted(want)


# ---------------- engine runs ----------------

def _run_both(graphs, algo, exchange, plan=None, max_supersteps=4096):
    jpg, tpg = graphs[GRAPH_OF[algo]]
    jprog, tprog = _programs(jpg, algo)
    jeng = JEngine(jpg, jprog, exchange=exchange,
                   tier_plan=None if plan is None else _jplan(plan),
                   max_supersteps=max_supersteps)
    teng = GopherEngine(tpg, tprog, exchange=exchange, tier_plan=plan,
                        max_supersteps=max_supersteps, device="cpu")
    js, jt = jeng.run()
    ts, tt = teng.run()
    return (js, jt, jeng), (ts, tt, teng)


def _key(algo):
    return "r" if algo == "pagerank" else "x"


def _taught_plan(tpg):
    """The phased plan of a port host block taught by a compact CC run."""
    hb = host_graph_block(tpg)
    _, t = GopherEngine(tpg, _programs(tpg, "cc")[1], exchange="compact",
                        device="cpu").run()
    ttiers.update_profile(hb, t.pair_slots, t.pair_rounds)
    ttiers.update_changed_profile(hb, t.count_hist)
    return PhasedTierPlan.from_block(hb)


@pytest.mark.parametrize("exchange", ["tiered", "phased"])
@pytest.mark.parametrize("algo", ["cc", "sssp", "bfs", "max_vertex"])
def test_tiered_and_phased_bit_identity_and_telemetry(graphs, taught, algo,
                                                      exchange):
    """The structural plan on 'tiered'; on 'phased' the plan taught by a
    compact CC run on the graph."""
    plan = None
    if exchange == "phased":
        plan = (PhasedTierPlan.from_block(taught[1])
                if GRAPH_OF[algo] == "road"
                else _taught_plan(graphs[GRAPH_OF[algo]][1]))
    (js, jt, _), (ts, tt, _) = _run_both(graphs, algo, exchange, plan)
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    assert tt.exchange == exchange and not tt.retried
    # bit-equal to the port's dense run, with less wire
    _, tpg = graphs[GRAPH_OF[algo]]
    sd, td = GopherEngine(tpg, _programs(tpg, algo)[1], exchange="dense",
                          device="cpu").run()
    assert np.array_equal(ts["x"], sd["x"])
    assert tt.supersteps == td.supersteps
    assert np.array_equal(tt.local_iters, td.local_iters)
    assert tt.wire_slots < td.wire_slots


def test_phased_pagerank_allclose(graphs, taught):
    plan = PhasedTierPlan.from_block(taught[1])
    (js, jt, _), (ts, tt, _) = _run_both(graphs, "pagerank", "phased", plan)
    np.testing.assert_allclose(ts["r"], np.asarray(js["r"]), rtol=1e-5,
                               atol=1e-7)
    assert tt.supersteps == jt.supersteps == 12
    assert np.array_equal(tt.phase_hist, jt.phase_hist)
    assert tt.wire_slots == jt.wire_slots


def _sabotaged(tpg, phased: bool):
    """The structural plan with the BUSIEST pair demoted to cold: a cold
    SSSP run fires every slot of it in the prime round. Phased: only the
    tail phase is sabotaged, from round 1."""
    base = TierPlan.from_graph(tpg)
    occ = ttiers.occupancy_from_graph(tpg)
    s, d = np.unravel_index(np.argmax(occ), occ.shape)
    assert occ[s, d] > 1
    t = base.tiers.copy()
    t[s, d] = ttiers.COLD
    if not phased:
        return dataclasses.replace(base, tier_bytes=t.tobytes()), (s, d)
    return PhasedTierPlan(num_parts=base.num_parts, cap=base.cap,
                          warm_cap=base.warm_cap,
                          phase_tier_bytes=(base.tier_bytes, t.tobytes()),
                          boundaries=(1, NO_BOUNDARY)), (s, d)


def test_tiered_overflow_reruns_dense_and_escalates(graphs):
    _, tpg = graphs["road"]
    plan, (s, d) = _sabotaged(tpg, phased=False)
    (js, jt, jeng), (ts, tt, teng) = _run_both(graphs, "sssp", "tiered", plan)
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    assert tt.retried and tt.spills > 0 and tt.escalations >= 1
    assert tt.pair_overflow[s, d] > 0
    assert dataclasses.asdict(teng.tier_plan) == \
        dataclasses.asdict(jeng.tier_plan)
    assert teng.tier_plan.tiers[s, d] > ttiers.COLD
    # escalation converges, in step with the JAX engine
    for _ in range(3):
        ts, tt = teng.run()
        js, jt = jeng.run()
        _assert_same_telemetry(tt, jt)
        if not tt.retried:
            break
    assert not tt.retried and tt.spills == 0
    assert np.array_equal(ts["x"], np.asarray(js["x"]))


def test_phased_spill_escalates_only_its_phase(graphs):
    _, tpg = graphs["road"]
    plan, (s, d) = _sabotaged(tpg, phased=True)
    (js, jt, jeng), (ts, tt, teng) = _run_both(graphs, "sssp", "phased", plan)
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    assert not tt.retried
    assert tt.dense_retry_steps > 0 and tt.spills > 0
    assert tt.pair_overflow[s, d] > 0 and tt.escalations >= 1
    new = teng.tier_plan.phase_plans()
    assert new[0] == TierPlan.from_graph(tpg)           # wide phase untouched
    assert new[1].tiers[s, d] > ttiers.COLD             # tail promoted
    assert dataclasses.asdict(teng.tier_plan) == \
        dataclasses.asdict(jeng.tier_plan)


def _two_phase(tpg, boundaries, tail=None):
    base = TierPlan.from_graph(tpg)
    return PhasedTierPlan(num_parts=base.num_parts, cap=base.cap,
                          warm_cap=base.warm_cap,
                          phase_tier_bytes=(base.tier_bytes,
                                            tail or base.tier_bytes),
                          boundaries=boundaries)


def _allcold(tpg):
    base = TierPlan.from_graph(tpg)
    return np.where(base.tiers == ttiers.EXCLUDED, ttiers.EXCLUDED,
                    ttiers.COLD).astype(np.int8).tobytes()


def test_phased_demotion_trigger(graphs):
    """A wildly wrong boundary: the counts fit the next phase's limits for
    DEMOTE_STREAK supersteps, so the segment switches there."""
    _, tpg = graphs["road"]
    plan = _two_phase(tpg, (1000, NO_BOUNDARY))
    (js, jt, _), (ts, tt, _) = _run_both(graphs, "sssp", "phased", plan)
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    assert tt.supersteps > ttiers.DEMOTE_STREAK
    assert np.array_equal(tt.phase_switch_steps, [ttiers.DEMOTE_STREAK])
    assert np.all(tt.phase_hist[:ttiers.DEMOTE_STREAK + 1] == 0)
    assert np.all(tt.phase_hist[ttiers.DEMOTE_STREAK + 1:] == 1)


def test_phased_quiesce_at_boundary(graphs):
    """Boundaries are in ROUND units: a run whose last exchange is round S
    runs no superstep of the next phase when the boundary is S + 1; with S
    its last live superstep crosses into the all-cold phase, and the
    in-loop dense retry keeps it exact."""
    _, tpg = graphs["road"]
    _, tprog = _programs(tpg, "cc")
    _, td = GopherEngine(tpg, tprog, exchange="dense", device="cpu").run()
    S = td.supersteps
    for bound, last_phase in ((S + 1, 0), (S, 1)):
        plan = _two_phase(tpg, (bound, NO_BOUNDARY), _allcold(tpg))
        (js, jt, _), (ts, tt, _) = _run_both(graphs, "cc", "phased", plan)
        assert np.array_equal(ts["x"], np.asarray(js["x"]))
        _assert_same_telemetry(tt, jt)
        assert tt.supersteps == S
        assert tt.phase_hist[-1] == last_phase
        if last_phase == 0:
            assert np.all(tt.phase_hist == 0)
            assert tt.spills == 0 and tt.dense_retry_steps == 0


def test_plan_normalisation(graphs):
    _, tpg = graphs["road"]
    _, cc = _programs(tpg, "cc")
    up = GopherEngine(tpg, cc, exchange="tiered",
                      tier_plan=PhasedTierPlan.from_graph(tpg), device="cpu")
    assert up.exchange == "phased"
    wrapped = GopherEngine(tpg, cc, exchange="phased",
                           tier_plan=TierPlan.from_graph(tpg), device="cpu")
    assert wrapped.tier_plan.num_phases == 1
    assert GopherEngine(tpg, cc, exchange="tiered",
                        device="cpu").tier_plan == TierPlan.from_graph(tpg)
    assert GopherEngine(tpg, cc, exchange="phased", device="cpu") \
        .tier_plan == PhasedTierPlan.from_graph(tpg)
    # auto on local stays megastep and keeps a plan; dense drops it
    mega = GopherEngine(tpg, cc, tier_plan=PhasedTierPlan.from_graph(tpg),
                        device="cpu")
    assert mega.exchange == "megastep" and mega.tier_plan is not None
    assert GopherEngine(tpg, cc, exchange="dense",
                        tier_plan=TierPlan.from_graph(tpg),
                        device="cpu").tier_plan is None
    with pytest.raises(TypeError, match="TierPlan"):
        GopherEngine(tpg, cc, tier_plan=object(), device="cpu")


# ---------------- the resident narrow-phase mode ----------------

@pytest.mark.parametrize("algo", ["cc", "sssp"])
def test_resident_mode_matches_jax(graphs, algo):
    """exchange='megastep' with PhasedTierPlan.from_graph: the plan fits
    the gate, so the run is resident from superstep 0 — on the CPU every
    round folded, in both packages."""
    _, tpg = graphs["road"]
    plan = PhasedTierPlan.from_graph(tpg)
    (js, jt, _), (ts, tt, _) = _run_both(graphs, algo, "megastep", plan)
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    assert tt.wire_slots == 0
    sd, td = GopherEngine(tpg, _programs(tpg, algo)[1], exchange="dense",
                          device="cpu").run()
    assert np.array_equal(ts["x"], sd["x"])
    assert tt.supersteps > td.supersteps      # one hop a round


def test_resident_hand_off_after_bsp_supersteps(graphs, monkeypatch):
    """A lowered gate in both packages: the wide phase does not fit, the
    all-cold tail does, so the run takes BSP supersteps up to the tail's
    boundary and the resident rounds after it."""
    _, tpg = graphs["road"]
    plan = _two_phase(tpg, (2, NO_BOUNDARY), _allcold(tpg))
    budget = plan.phase_plans()[1].schedule(1).round_bytes(None)
    assert plan.phase_plans()[0].schedule(1).round_bytes(None) > budget
    entered = []
    for mod in (jmega, tmega):
        orig = mod.resident_enter_round

        def lowered(rb, bounds, budget_=None, _orig=orig):
            enter = _orig(rb, bounds, budget)
            entered.append(enter)
            return enter
        monkeypatch.setattr(mod, "resident_enter_round", lowered)
    (js, jt, _), (ts, tt, _) = _run_both(graphs, "sssp", "megastep", plan)
    assert entered == [2, 2]
    assert np.array_equal(ts["x"], np.asarray(js["x"]))
    _assert_same_telemetry(tt, jt)
    # the first two supersteps are BSP: the same as the pure fused run's
    _, tprog = _programs(tpg, "sssp")
    _, tb = GopherEngine(tpg, tprog, device="cpu").run()
    assert np.array_equal(tt.changed_hist[:2], tb.changed_hist[:2])
    assert tt.supersteps != tb.supersteps


def test_resident_megastep_ref_matches_pallas(graphs):
    """The plain resident loop against the Pallas kernel in interpret
    mode, from the init state and cut by a small max_steps, after a K3
    superstep."""
    jpg, tpg = graphs["road"]
    for algo in ("cc", "sssp"):
        jprog, tprog = _programs(jpg, algo)
        jgb = j_graph_block(jpg)
        jcm = jmega.compose_mailbox(jgb)
        tcm = tmega.compose_mailbox(graph_block(tpg, "cpu"))
        st = jax.vmap(jprog.init)(jgb)
        x, ch, fr = (torch.from_numpy(np.array(st[k]).reshape(-1))
                     for k in ("x", "changed_v", "frontier"))
        starts = [(x, ch, fr), tmega.megastep_semiring_ref(
            x, ch, fr, tcm, jprog.semiring)[:3]]
        for (x, ch, fr), max_steps in zip(starts * 2, (200, 200, 3, 3)):
            got = tmega.resident_megastep_ref(x, ch, fr, tcm, jprog.semiring,
                                              max_steps)
            want = jmega.resident_megastep_pallas(
                jnp.asarray(x.numpy()), jnp.asarray(ch.numpy()),
                jnp.asarray(fr.numpy()), jcm, jprog.semiring,
                max_steps=max_steps, interpret=True)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b)), algo
            if max_steps == 3:
                assert int(got[3]) == 3 and bool(got[1].any())
            else:
                assert int(got[3]) < 200 and not bool(got[1].any())
    # the dispatcher takes the plain loop for a CPU tensor
    got = tmega.resident_megastep(x, ch, fr, tcm, "min_plus", 5)
    want = tmega.resident_megastep_ref(x, ch, fr, tcm, "min_plus", 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        tmega.resident_megastep_cuda(x, ch, fr, tcm, "min_plus", 5)


def test_resident_enter_round_suffix_rule(monkeypatch):
    B = tmega.RESIDENT_ROUND_BYTES_BUDGET
    assert B == jmega.MEGASTEP_VMEM_BUDGET
    cases = [([B - 1, B // 2], [4], 0), ([B + 1, B // 2], [4], 4),
             ([B // 2, B + 1, B // 2], [3, 7], 7), ([B // 2, B + 1], [5], None)]
    for rb, bounds, want in cases:
        assert tmega.resident_enter_round(rb, bounds) == want
        assert jmega.resident_enter_round(rb, bounds) == want
    # the budget is read at call time
    monkeypatch.setattr(tmega, "RESIDENT_ROUND_BYTES_BUDGET", B // 4)
    assert tmega.resident_enter_round([B // 2, B // 8], [6]) == 6
