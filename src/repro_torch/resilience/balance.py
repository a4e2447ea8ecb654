"""Gopher Balance — skew-healing live sub-graph migration.

The port of the JAX package's ``resilience/balance.py``: the same plans,
the same synthetic delta (host numpy, field for field the JAX package's
``MigrationResult``), the same audit and the same snapshot re-homing, on
the port's engine, checkpointer and block patch; each migration ticks
``rebalance_migrations_total{backend}`` in the engine's metrics
registry.

GoFFish's documented weakness is partition skew: the superstep barrier makes
makespan ∝ the SLOWEST partition while resources ∝ the mean, so one
straggler gates the whole BSP pipeline (paper Fig. 5; the sub-graph-centric
algorithms follow-up attacks exactly this imbalance, and Mizan-style dynamic
migration is the vertex-centric world's standard remedy). This module closes
the telemetry → decision → migration → verify loop around signals that
already exist:

  telemetry   ``Telemetry.part_seconds`` (the host-stepped loops' wall
              clock, where injected straggler stalls land) + the iteration
              channel, scored by ``obs.skew`` / ``SkewTracker``;
  decision    ``launch/elastic.rebalance_hint`` (threshold + hysteresis
              floor) names the victim; :func:`plan_migration` picks WHICH of
              its sub-graphs move WHERE, bounded by a per-step budget;
  migration   :func:`apply_migration` executes the move as a SYNTHETIC DELTA
              through the existing O(|delta|) machinery: only the moved
              sub-graphs' ELL rows and remote-slot entries are rewritten and
              ``core.blocks.patch_host_block`` patches the serving block in
              place — never a full re-partition. Sub-graphs are weakly
              connected components of the LOCAL adjacency, so no local edge
              crosses a sub-graph boundary and a whole sub-graph moves with
              ONLY its cut edges re-routed — the GoFFish representation
              makes migration O(moved sub-graphs' cut), which is the point;
  verify      ``verify_host_block`` audits the patched block BEFORE the new
              engine exists (failed audit = rollback, the pre-migration
              block keeps serving), and :func:`migrate_and_resume` re-homes
              the snapshot so the run resumes BIT-IDENTICAL to the
              unmigrated run for idempotent ⊕ (allclose for PageRank, whose
              ⊕ is a float sum and the move reorders it).

Resume correctness hangs on the cut's PENDING DELIVERIES: the saved inbox
carries messages whose senders changed in the last superstep before the
snapshot and whose receivers only learn of them from the next mailbox. An
edge the migration converts from remote to local loses that channel (local
edges deliver DURING the superstep their source changes — already passed),
so for idempotent ⊕ the resume RE-HOMES the saved inbox (pending news
preserved; double delivery over now-local edges is harmless on a monotone
lattice), while for ⊕ = sum it RECOMPUTES ``route(pack(state))`` on the new
topology (re-homing would double-count converted edges; sum-programs resend
unconditionally, so the recompute is complete and exact).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.launch import elastic
from repro_torch.resilience import faults as _faults


@dataclasses.dataclass(frozen=True)
class BalancePolicy:
    """Knobs of the rebalance actuator. ``threshold``/``floor`` gate
    :func:`elastic.rebalance_hint` (trip above threshold, keep healing until
    below floor — the hysteresis band); ``max_verts_per_step`` bounds one
    migration's live vertices (the per-step budget); ``cooldown_segments``
    idles the actuator after each move so two consecutive decisions never
    react to the same pre-move telemetry (no oscillation); ``check_every``
    is the superstep budget of one run segment between decisions."""
    threshold: float = 1.5
    floor: float = 1.1
    max_verts_per_step: int = 64
    cooldown_segments: int = 1
    check_every: int = 4
    max_migrations: int = 8


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Move the named sub-graphs (ids in ``src``'s CURRENT local numbering)
    from partition ``src`` to partition ``dst``. ``verts`` is the live
    vertex count the plan moves (the spent budget)."""
    src: int
    dst: int
    subgraphs: tuple
    verts: int


@dataclasses.dataclass
class MigrationResult:
    """One executed migration: the new graph version, its patched host
    block (None when no block was passed), and the move record needed to
    re-home a snapshot (old/new local slots of the moved vertices)."""
    pg: object
    block: Optional[dict]
    plan: MigrationPlan
    moved_gids: np.ndarray     # (m,) global ids moved
    old_slots: np.ndarray      # (m,) vacated src-local slots
    new_slots: np.ndarray      # (m,) filled dst-local slots
    stats: dict
    events: Optional[tuple] = None


def plan_migration(pg, src: int, budget: int = 64,
                   load: Optional[np.ndarray] = None,
                   dst: Optional[int] = None) -> Optional[MigrationPlan]:
    """Pick which of ``src``'s sub-graphs to shed and where. Destination
    defaults to the LIGHTEST partition by ``load`` (per-partition seconds or
    iterations; live vertex count when absent) that has free vertex slots —
    v_max never grows under migration, so capacity is a hard constraint.
    Sub-graphs are chosen largest-first while they fit both the budget and
    the destination's free slots (a sub-graph is atomic: local edges never
    cross one, so splitting is not an option). Returns None when nothing
    movable fits — a single sub-graph larger than the budget stays put."""
    vmask = np.asarray(pg.vmask, bool)
    P = pg.num_parts
    src = int(src)
    if not (0 <= src < P) or not vmask[src].any():
        return None
    sg = np.asarray(pg.sg_id[src])
    ids, counts = np.unique(sg[vmask[src]], return_counts=True)
    free = (~vmask).sum(1)
    if dst is None:
        ld = (np.asarray(load, np.float64).reshape(-1) if load is not None
              else vmask.sum(1).astype(np.float64))
        cand = [int(p) for p in np.argsort(ld, kind="stable")
                if int(p) != src and free[p] > 0]
        if not cand:
            return None
        dst = cand[0]
    dst = int(dst)
    if dst == src or not (0 <= dst < P):
        return None
    room = min(int(free[dst]), int(budget))
    pick, verts = [], 0
    for i in np.argsort(-counts, kind="stable"):
        c = int(counts[i])
        if verts + c <= room:
            pick.append(int(ids[i]))
            verts += c
    if not pick:
        return None
    return MigrationPlan(src=src, dst=dst, subgraphs=tuple(sorted(pick)),
                         verts=verts)


def apply_migration(pg, plan: MigrationPlan,
                    host_gb: Optional[dict] = None) -> MigrationResult:
    """Execute a :class:`MigrationPlan` as a synthetic delta: rewrite
    ownership (part_of/local_of/global_id/vmask), the moved sub-graphs' ELL
    rows (local ids remap through a slot LUT — sub-graph closure guarantees
    every local neighbor of a moved vertex also moved), and the remote-slot
    layout (out-edges of moved vertices re-allocate at ``dst``; in-edges
    retarget their stored (dst_part, dst_local) in place; edges with both
    ends landing in ``dst`` CONVERT to local ELL entries). With ``host_gb`` the
    serving block is patched through ``core.blocks.patch_host_block`` using
    the same (touched_rows, rdel, radd) event protocol as
    ``gofs.temporal.apply_delta`` — O(moved cut), no re-bin, no re-pack —
    and the dirty frontier is pre-announced (``core.tiers.announce_frontier``)
    so restart plans give the re-homed pairs width from round 0. Rows and
    remote edges grow, slots recycle and the mailbox cap sticks by the same
    rules as in ``apply_delta``."""
    from repro_torch.gofs.formats import PAD, PartitionedGraph
    from repro_torch.gofs.temporal import (_add_remote_edge, _ell_insert,
                                           _local_subgraphs, _mailbox_cap,
                                           _recycled_slot)

    P, v_max = pg.num_parts, pg.v_max
    src, dst = int(plan.src), int(plan.dst)
    if src == dst:
        raise ValueError(f"a migration from partition {src} to itself")
    vmask = np.asarray(pg.vmask, bool).copy()
    sgid = np.asarray(pg.sg_id)
    moved = vmask[src] & np.isin(sgid[src],
                                 np.asarray(plan.subgraphs, np.int32))
    old_l = np.flatnonzero(moved)
    if not old_l.size:
        raise ValueError("the plan names no live sub-graph vertices")
    free_dst = np.flatnonzero(~vmask[dst])
    if free_dst.size < old_l.size:
        raise ValueError(
            f"partition {dst} has {free_dst.size} free slots for "
            f"{old_l.size} moved vertices (v_max is fixed under migration)")
    new_l = free_dst[:old_l.size].astype(np.int32)
    lut = np.full(v_max, PAD, np.int32)
    lut[old_l] = new_l
    moved_local = np.zeros(v_max, bool)
    moved_local[old_l] = True

    # ---- identity re-home
    gids = np.asarray(pg.global_id)[src, old_l]
    part_of = pg.part_of.copy()
    local_of = pg.local_of.copy()
    part_of[gids] = dst
    local_of[gids] = new_l
    global_id = pg.global_id.copy()
    global_id[dst, new_l] = gids
    global_id[src, old_l] = -1
    vmask[dst, new_l] = True
    vmask[src, old_l] = False
    out_degree = pg.out_degree.copy()
    out_degree[dst, new_l] = out_degree[src, old_l]
    out_degree[src, old_l] = 0
    attrs = {}
    for name, arr in pg.attrs.items():
        a = np.asarray(arr).copy()
        a[dst, new_l] = a[src, old_l]
        a[src, old_l] = 0
        attrs[name] = a

    # ---- local ELL rows (pull in-edges, local ids): remap through the LUT
    nbr = pg.nbr.copy()
    wgt = pg.wgt.copy()
    rows = nbr[src, old_l]
    live_e = rows != PAD
    if not (lut[np.where(live_e, rows, 0)][live_e] != PAD).all():
        raise ValueError("a local edge crosses a sub-graph boundary (a "
                         "broken GoFS invariant)")
    nbr[dst, new_l] = np.where(live_e, lut[np.where(live_e, rows, 0)], PAD)
    wgt[dst, new_l] = wgt[src, old_l]
    nbr[src, old_l] = PAD
    wgt[src, old_l] = 0.0
    touched = np.zeros((P, v_max), bool)
    touched[src, old_l] = True
    touched[dst, new_l] = True

    re_src = pg.re_src.copy()
    re_wgt = pg.re_wgt.copy()
    re_dp = pg.re_dst_part.copy()
    re_dl = pg.re_dst_local.copy()
    re_slot = pg.re_slot.copy()
    remote = [re_src, re_wgt, re_dp, re_dl, re_slot]
    ev_rdel = []               # [(src_p, dst_p, dst_v, slot)]
    ev_radd = []               # [(src_p, dst_p, dst_v, slot, edge_idx)]
    dirty = np.zeros((P, v_max), bool)   # announce by SOURCE vertex
    dirty[dst, new_l] = True
    stats = dict(moved_verts=int(old_l.size), out_moved=0, in_retargeted=0,
                 converted_local=0)

    # ---- out-edges OF moved vertices (stored source-side at src)
    srow = re_src[src]
    out_e = np.flatnonzero((srow != PAD)
                           & moved_local[np.where(srow != PAD, srow, 0)])
    for e in out_e:
        lu = int(re_src[src, e])
        pv = int(re_dp[src, e])
        lv = int(re_dl[src, e])
        w = float(re_wgt[src, e])
        ev_rdel.append((src, pv, lv, int(re_slot[src, e])))
        re_src[src, e] = PAD
        re_wgt[src, e] = 0.0
        nlu = int(lut[lu])
        if pv == dst:                    # both ends now in dst: goes local
            nbr, wgt = _ell_insert(nbr, wgt, dst, lv, nlu, w)
            touched[dst, lv] = True
            stats["converted_local"] += 1
        else:
            slot, e2 = _add_remote_edge(remote, dst, nlu, pv, lv, w)
            re_src, re_wgt, re_dp, re_dl, re_slot = remote
            ev_radd.append((dst, pv, lv, slot, e2))
            stats["out_moved"] += 1

    # ---- in-edges INTO moved vertices (stored at their source partitions)
    for r in range(P):
        if r == src:                     # remote edges never stay in-part
            continue
        rrow = re_src[r]
        hit = np.flatnonzero(
            (rrow != PAD) & (re_dp[r] == src)
            & moved_local[np.where(re_dl[r] >= 0, re_dl[r], 0)]
            & (re_dl[r] >= 0))
        for e in hit:
            lu = int(re_src[r, e])
            lv_old = int(re_dl[r, e])
            w = float(re_wgt[r, e])
            nlv = int(lut[lv_old])
            ev_rdel.append((r, src, lv_old, int(re_slot[r, e])))
            if r == dst:                 # both ends now in dst: goes local
                re_src[r, e] = PAD
                re_wgt[r, e] = 0.0
                nbr, wgt = _ell_insert(nbr, wgt, dst, nlv, lu, w)
                touched[dst, nlv] = True
                stats["converted_local"] += 1
            else:                        # retarget the stored entry in place
                slot = _recycled_slot(remote, r, dst)
                re_dp[r, e] = dst
                re_dl[r, e] = nlv
                re_slot[r, e] = slot
                ev_radd.append((r, dst, nlv, slot, int(e)))
                dirty[r, lu] = True
                stats["in_retargeted"] += 1

    cap = _mailbox_cap(re_src, re_slot, host_gb, P)

    # ---- sub-graph rediscovery on the two touched partitions only
    sg_new = sgid.copy()
    num_sg = pg.num_subgraphs.copy()
    for p, sg_p, n_p in _local_subgraphs(nbr, vmask, [src, dst]):
        sg_new[p], num_sg[p] = sg_p, n_p

    new_pg = PartitionedGraph(
        n_global=pg.n_global, num_parts=P, v_max=v_max,
        nbr=nbr, wgt=wgt, vmask=vmask, out_degree=out_degree,
        global_id=global_id, part_of=part_of, local_of=local_of,
        sg_id=sg_new, num_subgraphs=num_sg,
        re_src=re_src, re_wgt=re_wgt, re_dst_part=re_dp, re_dst_local=re_dl,
        re_slot=re_slot, mailbox_cap=cap, attrs=attrs,
        version=pg.version + 1,
    )
    touched_rows = np.argwhere(touched)
    new_block = None
    if host_gb is not None:
        from repro_torch.core.blocks import patch_host_block
        from repro_torch.core.tiers import announce_frontier
        new_block = patch_host_block(host_gb, new_pg, touched_rows,
                                     ev_rdel, ev_radd)
        # patch carries attr_* keys across untouched; ownership moved, so
        # refresh them from the re-homed attrs
        for name, arr in attrs.items():
            new_block[f"attr_{name}"] = np.asarray(arr)
        announce_frontier(new_block, new_pg, dirty)
    return MigrationResult(pg=new_pg, block=new_block, plan=plan,
                           moved_gids=np.asarray(gids),
                           old_slots=old_l.astype(np.int64),
                           new_slots=new_l.astype(np.int64), stats=stats,
                           events=(touched_rows, ev_rdel, ev_radd))


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def remap_state(state, res: MigrationResult, num_parts: int, v_max: int):
    """Re-home a snapshot's state (a nest of arrays or tensors) onto the
    migrated layout: every (P, v_max, ...)-leading leaf copies the moved
    vertices' values from their old src slots to their new dst slots
    (vacated slots keep stale values — every consumer masks by vmask).
    Other leaves pass through. Leaves come back as numpy arrays."""
    src, dst = res.plan.src, res.plan.dst
    old_l, new_l = res.old_slots, res.new_slots

    def leaf(x):
        a = _as_numpy(x)
        if a.ndim >= 2 and a.shape[0] == num_parts and a.shape[1] == v_max:
            out = a.copy()
            out[dst, new_l] = a[src, old_l]
            return out
        return a
    return _tree_map(leaf, state)


def to_global(state, pg):
    """Scatter (P, v_max, ...)-leading state leaves into global vertex order
    — the layout-independent view two runs with different partition layouts
    are compared in (raw leaf equality is meaningless after a migration)."""
    gid = np.asarray(pg.global_id)
    m = np.asarray(pg.vmask, bool)

    def leaf(x):
        a = _as_numpy(x)
        if (a.ndim >= 2 and a.shape[0] == pg.num_parts
                and a.shape[1] == pg.v_max):
            out = np.zeros((pg.n_global,) + a.shape[2:], a.dtype)
            out[gid[m]] = a[m]
            return out
        return a
    return _tree_map(leaf, state)


def migrate_and_resume(engine, checkpointer, plan: MigrationPlan,
                       host_gb: Optional[dict] = None,
                       extra: Optional[dict] = None):
    """The live-migration step: patch graph + block, AUDIT, rebuild the
    engine on the patched block with a narrow restart plan, re-home the
    newest good snapshot and recompute its inbox on the new topology, and
    re-commit it at the SAME superstep so ``engine.run(resume=True)``
    continues the run bit-identical to the unmigrated execution.

    Raises :class:`faults.BlockCorruptionFault` BEFORE anything is
    installed when the patched block fails ``verify_host_block`` — the
    caller's engine, block, and snapshot are untouched (rollback is free).
    Returns ``(new_engine, MigrationResult, resumed_step)``."""
    from repro_torch.core import (GopherEngine, PhasedTierPlan, TierPlan,
                                  host_graph_block)
    from repro_torch.core.blocks import device_block, verify_host_block

    pg = engine.pg
    hb = host_gb if host_gb is not None else host_graph_block(pg)
    res = apply_migration(pg, plan, host_gb=hb)
    problems = verify_host_block(res.block)
    if problems:
        raise _faults.BlockCorruptionFault(
            "blocks.patch", "corrupt_block", -1,
            {"migration": True},
            {"problems": "; ".join(problems[:3])})

    tier_plan = engine.tier_plan
    if isinstance(tier_plan, PhasedTierPlan):
        tier_plan = PhasedTierPlan.for_resume(res.block)
    elif isinstance(tier_plan, TierPlan):
        tier_plan = TierPlan.from_block(res.block)
    ne = GopherEngine(
        res.pg, engine.program, backend=engine.backend, mesh=engine.mesh,
        max_supersteps=engine.max_supersteps,
        gb=device_block(res.block, engine.device),
        exchange=engine.exchange_requested, tier_plan=tier_plan,
        tracer=engine._tracer, metrics=engine._metrics,
        validate=engine.validate, device=engine.device)

    # re-home the snapshot: restore → remap state → re-home or recompute the
    # inbox (see below) → re-commit at the same step
    ck = checkpointer
    good = ck.latest_good_step()
    if good is None:
        raise ValueError("migration needs a committed snapshot to re-home")
    P_, v_max = pg.num_parts, pg.v_max
    gb = ne._layer(ne._gb_for_staged(), extra)
    # the restore reads only the structure: its leaves' paths
    snap_like = {"state": ne.program.init(gb), "inbox": torch.empty(0)}
    snap, step = ck.restore(snap_like, step=good, device="cpu")
    state = remap_state(snap["state"], res, P_, v_max)
    # The saved inbox carries the cut's PENDING DELIVERIES — messages whose
    # senders changed in the last superstep and whose receivers only learn
    # of them from the next mailbox. An edge the migration converted from
    # remote to local loses that channel (local edges deliver DURING the
    # superstep their source changes — which has passed), so the pending
    # news must survive the move:
    #   idempotent ⊕ (min/max): RE-HOME the saved inbox — moved rows copy
    #     to their new slots, everything pending is preserved, and the
    #     double delivery over now-local edges (inbox now + local pull
    #     later) is harmless on a monotone lattice;
    #   ⊕ = sum (PageRank): re-homing would DOUBLE-COUNT converted edges,
    #     but these programs resend unconditionally every superstep, so
    #     recomputing route(pack(state)) on the new topology is complete
    #     AND exact.
    if getattr(ne.program, "combine", None) in ("min", "max"):
        inbox = snap["inbox"].numpy().copy()
        inbox[res.plan.dst, res.new_slots] = \
            inbox[res.plan.src, res.old_slots]
    else:
        # the checkpointed loop's own drop of the fused and tier routes
        mode = ne.exchange if ne.exchange in ("dense", "compact") \
            else "compact"
        pack, route = ne.make_exchange_stages(gb, mode=mode)
        rows = ne._ranks.rows                 # a mesh rank's partitions
        st = {k: torch.from_numpy(v[rows]).to(ne.device)
              for k, v in state.items()}
        inbox = ne._ranks.gather(route(pack(st)[0])[0]).cpu().numpy()
    ck.save({"state": state, "inbox": inbox}, int(step),
            group=ne._ranks.group)
    ne.metrics.counter("rebalance_migrations_total",
                       labels={"backend": ne.backend}).inc()
    return ne, res, int(step)


@dataclasses.dataclass
class RebalanceReport:
    """What the actuator did across one run: every migration (step, route,
    sub-graphs, vertex count), the skew score when it first tripped and at
    the end, and any audited-and-rolled-back patches."""
    migrations: list = dataclasses.field(default_factory=list)
    rollbacks: int = 0
    segments: int = 0
    imbalance_before: float = 0.0
    imbalance_after: float = 0.0
    final_step: Optional[int] = None
    faults: list = dataclasses.field(default_factory=list)

    def moved_verts(self) -> int:
        return sum(m["verts"] for m in self.migrations)


def _segment_score(skew: dict) -> float:
    return max(float(skew.get("imbalance", 0.0)),
               float(skew.get("time_imbalance", 0.0)))


def run_with_rebalance(engine, checkpointer, every: int = 1,
                       policy: Optional[BalancePolicy] = None,
                       extra: Optional[dict] = None,
                       host_gb: Optional[dict] = None):
    """Run checkpointed in ``policy.check_every``-superstep segments; after
    each segment read the skew report, ask ``elastic.rebalance_hint``
    (threshold to trip, hysteresis floor while acting, cooldown after every
    move), and heal stragglers by migrating sub-graphs off the victim
    partition through :func:`migrate_and_resume` — the mirror of
    ``run_with_failover``, driven by telemetry instead of failure.

    Returns ``(engine, state, telemetry, RebalanceReport)`` — the ENGINE is
    returned because every migration rebuilds it (new graph version, new
    block, new plans); callers must keep serving from the returned engine.
    A patch that fails its ``verify_host_block`` audit rolls back for free
    (nothing was installed) and is counted in ``report.rollbacks``."""
    from repro_torch.core import host_graph_block

    pol = policy or BalancePolicy()
    report = RebalanceReport()
    hb = host_gb
    cooldown = 0
    acting = False
    resume = False
    state = tele = None
    while True:
        report.segments += 1
        state, tele = engine.run(checkpointer=checkpointer,
                                 checkpoint_every=every, resume=resume,
                                 extra=extra,
                                 superstep_budget=pol.check_every)
        resume = True
        step = int(tele.supersteps)
        converged = (tele.changed_hist.size > 0
                     and int(tele.changed_hist[-1]) == 0)
        skew = tele.skew()
        if converged or step >= engine.max_supersteps:
            report.final_step = step
            report.imbalance_after = _segment_score(skew)
            return engine, state, tele, report
        if cooldown > 0:
            cooldown -= 1
            continue
        hint = elastic.rebalance_hint(skew, threshold=pol.threshold,
                                      floor=pol.floor, acting=acting)
        if hint is None or len(report.migrations) >= pol.max_migrations:
            acting = False
            continue
        load = (tele.part_seconds
                if tele.part_seconds is not None
                and np.any(np.asarray(tele.part_seconds) > 0)
                else tele.local_iters)
        plan = plan_migration(engine.pg, src=int(hint["migrate_from"]),
                              budget=pol.max_verts_per_step, load=load)
        if plan is None:
            acting = False
            continue
        if not report.migrations:
            report.imbalance_before = float(hint["imbalance"])
        if hb is None:
            hb = host_graph_block(engine.pg)
        try:
            engine, res, at = migrate_and_resume(engine, checkpointer, plan,
                                                 host_gb=hb, extra=extra)
        except _faults.BlockCorruptionFault as e:
            # failed patch audit: nothing was installed — the pre-migration
            # engine/block/snapshot keep running untouched
            report.rollbacks += 1
            report.faults.append(dict(site=e.site, kind=e.kind,
                                      visit=e.visit))
            acting = False
            cooldown = pol.cooldown_segments
            continue
        hb = res.block
        acting = True
        cooldown = pol.cooldown_segments
        report.migrations.append(dict(
            step=at, src=plan.src, dst=plan.dst,
            subgraphs=[int(g) for g in plan.subgraphs],
            verts=int(plan.verts), signal=hint.get("signal", ""),
            imbalance=float(hint["imbalance"])))
