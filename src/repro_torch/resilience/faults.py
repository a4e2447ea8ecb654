"""The fault the serving loop raises and handles itself.

The JAX package's ``resilience/faults.py`` injects faults at named sites
from a seeded plan; the port has no injector yet (ROADMAP A6). What the
serving loop already needs is the fault it raises when a patched graph
block fails its audit, :class:`BlockCorruptionFault`, with the JAX
package's constructor and message.
"""
from __future__ import annotations


class BlockCorruptionFault(RuntimeError):
    """The patched graph block is corrupt/truncated and must not be trusted;
    carries the site and the fire context."""

    def __init__(self, site: str, kind: str, visit: int, payload: dict,
                 ctx: dict):
        super().__init__(f"injected {kind} at {site} (visit {visit})")
        self.site = site
        self.kind = kind
        self.visit = visit
        self.payload = dict(payload)
        self.ctx = dict(ctx)
