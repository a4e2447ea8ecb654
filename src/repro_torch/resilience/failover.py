"""Gopher Shield — failover of a checkpointed run.

The port of the JAX package's ``resilience/failover.py``. In the JAX
package, device loss on a 'parts' mesh is survivable WITHOUT
repartitioning: the surviving devices re-tile the SAME P partitions over a
smaller mesh, the lost partitions are announced as a synthetic migration,
and the run resumes from the newest checksum-verified snapshot. That half
is ROADMAP A8.2: a ``DeviceLossFault`` raises ``NotImplementedError``
naming it, and so does :func:`shrink_parts_mesh`. A plain crash restarts the engine in
place through :func:`repro_torch.resilience.recovery.run_with_recovery`;
its ``RecoveryExhausted`` carries that loop's ``RecoveryReport``, and its
restarts tick ``recovery_restarts_total``. The JAX package's
``failover_events_total`` counter sits on the device-loss branch, so it
comes with that branch (ROADMAP A8.2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.resilience import faults as _faults
from repro_torch.resilience.recovery import (RecoveryReport,
                                             run_with_recovery)

_NEEDS_MESH = ("device-loss failover is not ported yet: ROADMAP A8.2 (the "
               "multi-device backend's service and device-loss half)")


def _largest_divisor_at_most(p: int, d: int) -> int:
    for k in range(min(p, max(d, 1)), 0, -1):
        if p % k == 0:
            return k
    return 1


def shrink_parts_mesh(mesh, lost: Sequence[int], num_parts: int,
                      axis_name: str = "parts"):
    """Rebuild a 1-axis 'parts' mesh after losing the device INDICES in
    ``lost`` (the JAX package's; ROADMAP A8.2)."""
    raise NotImplementedError(_NEEDS_MESH)


@dataclasses.dataclass
class FailoverReport(RecoveryReport):
    """RecoveryReport plus the mesh-change record."""
    lost_devices: list = dataclasses.field(default_factory=list)
    lost_partitions: list = dataclasses.field(default_factory=list)
    old_num_devices: Optional[int] = None
    new_num_devices: Optional[int] = None


def run_with_failover(engine, checkpointer, every: int = 1,
                      extra: Optional[dict] = None, max_restarts: int = 2):
    """Run checkpointed; on a crash, restart in place from the newest good
    snapshot, through :func:`run_with_recovery`. Returns ``(engine, state,
    telemetry, FailoverReport)`` — the engine is returned because the JAX
    package's device-loss path rebuilds it; here it is always the one passed
    in. A ``DeviceLossFault`` raises ``NotImplementedError`` naming ROADMAP
    A8.2."""
    try:
        state, tele, rep = run_with_recovery(engine, checkpointer,
                                             every=every, extra=extra,
                                             max_restarts=max_restarts)
    except _faults.DeviceLossFault as e:
        raise NotImplementedError(_NEEDS_MESH) from e
    return engine, state, tele, FailoverReport(**rep.as_dict())
