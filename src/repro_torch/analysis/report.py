"""Gopher Sentinel: shared finding/report types.

The port of the JAX package's ``analysis/report.py``, field for field, so a
report written by either package reads the same. Every pass (collectives,
semiring, kernels) reports through one :class:`Violation` record, so the
CLI merges them into one machine-readable report and the engine hook
raises one :class:`SentinelError` naming every offending site, plan field,
law or kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: ``code`` is the stable machine id, ``where`` the locus
    (file:line / kernel name / plan field / configuration), ``detail`` the
    actionable sentence."""
    pass_name: str               # 'collectives' | 'semiring' | 'kernels'
    code: str                    # e.g. 'COLLECTIVE_MISMATCH'
    where: str
    detail: str
    severity: str = ERROR        # 'error' | 'warning' | 'info'

    def __str__(self) -> str:
        return (f"[{self.pass_name}:{self.code}] ({self.severity}) "
                f"{self.where}: {self.detail}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def errors(violations) -> List[Violation]:
    return [v for v in violations if v.severity == ERROR]


def split_severity(violations) -> Tuple[List[Violation], List[Violation]]:
    errs = errors(violations)
    rest = [v for v in violations if v.severity != ERROR]
    return errs, rest


class SentinelError(RuntimeError):
    """Raised by ``GopherEngine(validate=True)`` / ``assert_clean`` when a
    pass finds error-severity violations. Carries the structured
    findings."""

    def __init__(self, violations):
        self.violations = list(violations)
        lines = [str(v) for v in self.violations]
        super().__init__(
            "Gopher Sentinel found %d violation(s):\n  %s"
            % (len(lines), "\n  ".join(lines)))


def assert_clean(violations) -> None:
    """Raise :class:`SentinelError` if any error-severity violation exists
    (warnings and infos pass)."""
    errs = errors(violations)
    if errs:
        raise SentinelError(errs)
