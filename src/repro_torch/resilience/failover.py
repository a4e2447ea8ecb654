"""Gopher Shield — mesh-shrink failover for the shard_map backend.

The port of the JAX package's ``resilience/failover.py``. Device loss on a
'parts' mesh is survivable WITHOUT repartitioning: GoFS virtual
partitions are decoupled from devices, so the surviving ranks re-tile the
SAME P partitions over a smaller mesh (P % D must still hold — the shrink
clamps to a divisor of P). The lost ranks' partitions are treated as a
SYNTHETIC MIGRATION through the block-patch machinery's announce path:
their rows are marked dirty and pre-announced into the block's traffic
profile (``core.tiers.announce_frontier``), the tier plans are rebuilt for
the surviving mesh, and the run resumes from the newest checksum-verified
snapshot. The math never saw the mesh — only the tiling changed — so the
recovered fixpoint is bit-identical to the uninterrupted run for
idempotent ⊕ (allclose for PageRank).

Where the JAX package has one controller, the port is SPMD: every rank
calls :func:`run_with_failover` with the same engine, checkpointer and
fault plan, so a ``DeviceLossFault`` fires on every rank at the same
superstep, before that superstep's first collective. From there on a lost
rank, and a survivor that the divisor clamp leaves out, take no further
collective on any group and return ``(None, None, None, report)``; the
survivors build a group of their own (``launch.mesh.sub_mesh``, which
only its members enter) and never touch the old group, mesh or engine
again. Every rank's report holds the same mesh-change record.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.launch import elastic
from repro_torch.launch.mesh import mesh_ranks, sub_mesh
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.recovery import (RecoveryExhausted,
                                             RecoveryReport, _latest_good)


def _largest_divisor_at_most(p: int, d: int) -> int:
    for k in range(min(p, max(d, 1)), 0, -1):
        if p % k == 0:
            return k
    return 1


def _shrunk_ranks(ranks: Sequence[int], lost: Sequence[int],
                  num_parts: int) -> list:
    """The default group's ranks of the mesh that survives losing the
    device INDICES ``lost`` of a mesh over ``ranks``:
    ``elastic.shrink_after_failure`` sizes it, clamped down to the largest
    divisor of ``num_parts``; survivors keep their order, so partition
    rows re-tile contiguously."""
    lost_set = set(int(i) for i in lost)
    survivors = [r for i, r in enumerate(ranks) if i not in lost_set]
    if not survivors:
        raise ValueError("every device was lost; nothing to fail over to")
    plan = elastic.MeshPlan((len(ranks),), ("parts",))
    shrunk = elastic.shrink_after_failure(plan, len(ranks) - len(survivors))
    return survivors[:_largest_divisor_at_most(num_parts, shrunk.shape[0])]


def shrink_parts_mesh(mesh, lost: Sequence[int], num_parts: int,
                      axis_name: str = "parts"):
    """Rebuild a 1-axis 'parts' mesh after losing the device INDICES in
    ``lost`` (see :func:`_shrunk_ranks`). Returns the new mesh, or None on
    a rank that is not in it (a lost one, or one the clamp left out),
    which enters no collective here."""
    return sub_mesh(_shrunk_ranks(mesh_ranks(mesh), lost, num_parts),
                    (axis_name,), device=mesh.device_type)


@dataclasses.dataclass
class FailoverReport(RecoveryReport):
    """RecoveryReport plus the mesh-change record."""
    lost_devices: list = dataclasses.field(default_factory=list)
    lost_partitions: list = dataclasses.field(default_factory=list)
    old_num_devices: Optional[int] = None
    new_num_devices: Optional[int] = None


def run_with_failover(engine, checkpointer, every: int = 1,
                      extra: Optional[dict] = None,
                      host_gb: Optional[dict] = None,
                      max_restarts: int = 2):
    """Run checkpointed on a shard_map engine; on an injected device loss,
    shrink the mesh, re-announce the lost partitions into ``host_gb`` (the
    graph's host block; one is built when None), rebuild the tier plans,
    and resume from the newest good snapshot.

    Returns ``(engine, state, telemetry, FailoverReport)`` — the ENGINE is
    returned because failover rebuilds it (new mesh, new plans); callers
    must serve subsequent runs from the returned engine, not the one they
    passed in. A rank that is not on the shrunk mesh gets ``(None, None,
    None, report)`` with ``final_step`` None. Plain crashes restart the
    current engine in place. Device loss on a 'local' engine, or of every
    device, raises ``ValueError``."""
    from repro_torch.core import (GopherEngine, PhasedTierPlan, TierPlan,
                                  host_graph_block)
    from repro_torch.core.tiers import announce_frontier

    report = FailoverReport()
    last = None
    for attempt in range(max_restarts + 1):
        report.attempts = attempt + 1
        try:
            state, tele = engine.run(checkpointer=checkpointer,
                                     checkpoint_every=every,
                                     resume=attempt > 0, extra=extra)
            report.final_step = int(tele.supersteps)
            return engine, state, tele, report
        except _faults.CrashFault as e:
            last = e
            report.restarts += 1
            report.faults.append(dict(site=e.site, kind=e.kind,
                                      visit=e.visit))
            report.resumed_steps.append(_latest_good(checkpointer))
        except _faults.DeviceLossFault as e:
            last = e
            report.restarts += 1
            report.faults.append(dict(site=e.site, kind=e.kind,
                                      visit=e.visit))
            report.resumed_steps.append(_latest_good(checkpointer))
            if engine.backend != "shard_map":
                raise ValueError("device-loss failover needs a shard_map "
                                 "mesh") from e
            pg = engine.pg
            P = pg.num_parts
            ranks = mesh_ranks(engine.mesh)
            D = len(ranks)
            lost = e.payload.get("lost", 1)
            lost = ([int(lost)] if np.isscalar(lost)
                    else [int(i) for i in lost])
            # block sharding of the leading (P,) axis: device d owns the
            # contiguous partition rows [d*P/D, (d+1)*P/D)
            per = P // D
            lost_parts = [p for d in lost
                          for p in range(d * per, (d + 1) * per)]
            report.lost_devices = lost
            report.lost_partitions = lost_parts
            report.old_num_devices = D
            new_ranks = _shrunk_ranks(ranks, lost, P)
            report.new_num_devices = len(new_ranks)
            new_mesh = sub_mesh(new_ranks, ("parts",),
                                device=engine.mesh.device_type)
            if new_mesh is None:
                # lost, or left out by the clamp: this rank is done
                return None, None, None, report
            # synthetic migration of the lost rows: announce their live
            # vertices as the dirty frontier so rebuilt plans give the
            # re-homed partitions' pairs enough width from round 0
            hb = host_gb if host_gb is not None else host_graph_block(pg)
            dirty = np.zeros((P, pg.v_max), bool)
            dirty[lost_parts] = np.asarray(hb["vmask"], bool)[lost_parts]
            announce_frontier(hb, pg, dirty)
            plan = engine.tier_plan
            if isinstance(plan, PhasedTierPlan):
                plan = PhasedTierPlan.for_resume(hb)
            elif isinstance(plan, TierPlan):
                plan = TierPlan.from_block(hb)
            engine.metrics.counter(
                "failover_events_total",
                labels={"backend": engine.backend}).inc()
            engine = GopherEngine(
                pg, engine.program, backend="shard_map", mesh=new_mesh,
                max_supersteps=engine.max_supersteps,
                exchange=engine.exchange_requested, tier_plan=plan,
                tracer=engine._tracer, metrics=engine._metrics,
                validate=engine.validate, device=engine.device)
    raise RecoveryExhausted(report, last)
