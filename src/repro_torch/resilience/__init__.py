"""Gopher Shield, the part the serving loop runs: the circuit breaker and
the backoff schedule (``degrade``) and the corrupted-block fault
(``faults``). Fault injection, recovery, failover and migration wait for
ROADMAP A6."""
from repro_torch.resilience.degrade import CircuitBreaker, backoff_delays
from repro_torch.resilience.faults import BlockCorruptionFault

__all__ = ["CircuitBreaker", "backoff_delays", "BlockCorruptionFault"]
