"""Gopher Shield — the robustness layer (fault injection, checkpoint/replay
recovery, failover, serving degradation) and Gopher Balance's live
migration.

Leaf modules (:mod:`.faults`, :mod:`.degrade`) import eagerly — the engine
and serving hooks depend on them. The run wrappers (:mod:`.recovery`,
:mod:`.failover`, :mod:`.balance`) import :mod:`repro_torch.core` and load
lazily so the package stays importable from inside core modules without a
cycle.
"""
from repro_torch.resilience import faults
from repro_torch.resilience.degrade import CircuitBreaker, backoff_delays
from repro_torch.resilience.faults import (
    BlockCorruptionFault,
    CrashFault,
    DeltaApplyFault,
    DeviceLossFault,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    PoisonedQueryFault,
)

__all__ = [
    "BlockCorruptionFault", "CircuitBreaker", "CrashFault",
    "DeltaApplyFault", "DeviceLossFault", "FaultPlan", "FaultSpec",
    "InjectedFault", "PoisonedQueryFault", "backoff_delays", "faults",
    "recover", "run_with_recovery", "run_with_failover", "shrink_parts_mesh",
    "RecoveryExhausted", "RecoveryReport",
    "BalancePolicy", "MigrationPlan", "MigrationResult", "RebalanceReport",
    "apply_migration", "migrate_and_resume", "plan_migration",
    "run_with_rebalance", "to_global",
]

_LAZY = {
    "recover": "recovery", "run_with_recovery": "recovery",
    "RecoveryExhausted": "recovery", "RecoveryReport": "recovery",
    "run_with_failover": "failover", "shrink_parts_mesh": "failover",
    "BalancePolicy": "balance", "MigrationPlan": "balance",
    "MigrationResult": "balance", "RebalanceReport": "balance",
    "apply_migration": "balance", "migrate_and_resume": "balance",
    "plan_migration": "balance", "run_with_rebalance": "balance",
    "to_global": "balance",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f"repro_torch.resilience.{mod}"),
                   name)
