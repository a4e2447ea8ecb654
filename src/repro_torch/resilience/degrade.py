"""Gopher Shield — graceful-degradation primitives for the serving loop.

The port's copy of the JAX package's ``resilience/degrade.py`` (no JAX in
it). ``serving.GraphQueryService`` passes every batch run and every delta
apply through it.

:class:`CircuitBreaker` is the standard three-state machine, per graph:

    CLOSED     normal serving; consecutive failures are counted
    OPEN       after ``threshold`` consecutive failures: engine runs are
               refused for ``cooldown_s`` — queries fall back to
               caches/landmarks (stale-serving) or are rejected cheaply
               instead of burning retries on a broken graph
    HALF_OPEN  cooldown elapsed: ONE trial batch is admitted; success
               closes the breaker, failure re-opens it

The clock is injectable so tests drive the cooldown deterministically
instead of sleeping.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.state = CLOSED
        self.failures = 0          # consecutive failures while CLOSED
        self.opens = 0             # lifetime open transitions
        self._opened_at = 0.0

    def allow(self) -> bool:
        """May an engine run be attempted right now? An OPEN breaker whose
        cooldown elapsed moves to HALF_OPEN and admits the one trial."""
        if self.state == OPEN:
            if self.clock() - self._opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                return True
            return False
        return True

    def record_ok(self) -> None:
        self.state = CLOSED
        self.failures = 0

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._open()
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self._open()

    def _open(self) -> None:
        self.state = OPEN
        self.opens += 1
        self.failures = 0
        self._opened_at = self.clock()


def backoff_delays(base_s: float, retries: int,
                   cap_s: float = 5.0) -> Sequence[float]:
    """Exponential backoff schedule: base, 2·base, 4·base, ... capped."""
    return [min(base_s * (2 ** i), cap_s) for i in range(max(retries, 0))]
