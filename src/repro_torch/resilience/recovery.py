"""Gopher Shield — superstep checkpoint/replay recovery loops.

The port of the JAX package's ``resilience/recovery.py``. BSP makes the
recovery line trivial: the superstep barrier IS a consistent cut (the
paper's §4.2 synchronization points), so a snapshot of (state, inbox,
superstep) replayed through the same staged stages finishes bit-identical
to the uninterrupted run. These wrap GopherEngine's checkpointed
loop with restart-on-fault: a crash rolls back to the newest snapshot that
passes checksum verification (``Checkpointer.latest_good_step`` — a
corrupt latest snapshot falls back one further) and replays forward.

Device loss is NOT handled here — that is a mesh change, not a replay; see
:mod:`repro_torch.resilience.failover`. Each restart ticks
``recovery_restarts_total{backend}`` in the engine's metrics registry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.resilience import faults as _faults


@dataclasses.dataclass
class RecoveryReport:
    """What the restart loop actually did, for assertions and chaos logs."""
    attempts: int = 0
    restarts: int = 0
    resumed_steps: list = dataclasses.field(default_factory=list)
    faults: list = dataclasses.field(default_factory=list)
    final_step: Optional[int] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class RecoveryExhausted(RuntimeError):
    """Every allowed restart was consumed and the run still faulted."""

    def __init__(self, report: RecoveryReport, last: BaseException):
        super().__init__(
            f"recovery exhausted after {report.attempts} attempts "
            f"({report.restarts} restarts): {last}")
        self.report = report
        self.last_error = last


def recover(engine, checkpointer, every: int = 1, extra: Optional[dict] = None
            ) -> Tuple[object, object]:
    """One restore-and-continue: resume from the newest GOOD snapshot and
    run to quiescence. Returns (state, telemetry) — bit-identical to what
    the interrupted run would have produced."""
    return engine.run(checkpointer=checkpointer, checkpoint_every=every,
                      resume=True, extra=extra)


def run_with_recovery(engine, checkpointer, every: int = 1,
                      extra: Optional[dict] = None, max_restarts: int = 3,
                      recoverable: tuple = (_faults.CrashFault,)):
    """Run checkpointed; on a recoverable fault, roll back and replay.

    The first attempt starts cold. Each restart resumes from the newest
    checksum-verified snapshot (none yet: a cold start). Returns
    ``(state, telemetry, RecoveryReport)``; raises
    :class:`RecoveryExhausted` when ``max_restarts`` is spent.
    ``DeviceLossFault`` is deliberately NOT recoverable here — pass the
    engine to :func:`repro_torch.resilience.failover.run_with_failover`
    instead."""
    report = RecoveryReport()
    last: Optional[BaseException] = None
    for attempt in range(max_restarts + 1):
        report.attempts = attempt + 1
        try:
            state, tele = engine.run(checkpointer=checkpointer,
                                     checkpoint_every=every,
                                     resume=attempt > 0, extra=extra)
            report.final_step = int(tele.supersteps)
            return state, tele, report
        except recoverable as e:
            last = e
            report.restarts += 1
            if isinstance(e, _faults.InjectedFault):
                report.faults.append(dict(site=e.site, kind=e.kind,
                                          visit=e.visit))
            report.resumed_steps.append(checkpointer.latest_good_step())
            engine.metrics.counter(
                "recovery_restarts_total",
                labels={"backend": engine.backend}).inc()
    raise RecoveryExhausted(report, last)
