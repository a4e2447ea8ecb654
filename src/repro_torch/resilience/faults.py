"""Gopher Shield — deterministic fault injection.

The port of the JAX package's ``resilience/faults.py`` (numpy only). A
:class:`FaultPlan` is a seeded, replayable schedule of faults fired at
NAMED SITES — host-side hook points the engine's checkpointed loop, the
block patcher, and the serving loop pass through:

    engine.superstep    once per superstep of the checkpointed BSP loop and
                        of a traced run, before the sweep
    exchange.route      once per mailbox routing round of those loops,
                        before the route
    blocks.patch        on entry to core.blocks.patch_host_block
    svc.apply_delta     on entry of a GraphQueryService delta-apply attempt
    svc.query           on entry of a GraphQueryService batch run attempt

Hooks are a single function call into :func:`fire`, which is a no-op unless
a plan is actively injected (``with faults.inject(plan): ...``). Every site
is on the host, between kernel launches, never inside one, so the math and
the kernels are untouched.

Determinism: a spec either names the exact visit index it fires at (``at=``)
or draws per-visit Bernoulli trials from its own ``np.random.default_rng``
stream derived from ``(plan.seed, spec index)`` — two runs of the same plan
against the same workload fire the same faults at the same visits, which is
what makes chaos scenarios assertable (recovered state must be bit-identical
to the fault-free run). The draws are numpy's, so a plan fires at the same
visits here as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

SITES = ("engine.superstep", "exchange.route", "blocks.patch",
         "svc.apply_delta", "svc.query")

#: fault kind -> exception raised (straggler sleeps instead of raising)
KINDS = ("device_loss", "corrupt_block", "failed_delta", "straggler",
         "poisoned_query", "crash")


class InjectedFault(RuntimeError):
    """Base of every injected failure; carries the site and fire context."""

    def __init__(self, site: str, kind: str, visit: int, payload: dict,
                 ctx: dict):
        super().__init__(f"injected {kind} at {site} (visit {visit})")
        self.site = site
        self.kind = kind
        self.visit = visit
        self.payload = dict(payload)
        self.ctx = dict(ctx)


class DeviceLossFault(InjectedFault):
    """A device (or several: ``payload['lost']``) dropped out of the mesh."""


class BlockCorruptionFault(InjectedFault):
    """The patched graph block is corrupt/truncated and must not be trusted.
    The serving loop also raises it itself when a patched block fails its
    ``verify_host_block`` audit."""


class DeltaApplyFault(InjectedFault):
    """A delta-apply attempt failed before the new version was installed."""


class PoisonedQueryFault(InjectedFault):
    """A query batch poisoned its engine run (malformed input, OOM, ...)."""


class CrashFault(InjectedFault):
    """Generic process crash at a superstep boundary (checkpoint/replay
    scenarios that are not device loss)."""


_RAISES = {
    "device_loss": DeviceLossFault,
    "corrupt_block": BlockCorruptionFault,
    "failed_delta": DeltaApplyFault,
    "poisoned_query": PoisonedQueryFault,
    "crash": CrashFault,
}


def _straggler_stalls(spec: "FaultSpec", ctx: dict) -> list:
    """Sleep out one straggler firing and return its [(part, seconds)]
    attribution. Targeted specs (payload ``part``/``device``) stall
    ``delay_s`` per live vertex of each targeted partition — read from the
    ``part_verts`` tuple in the fire context (the checkpointed loop passes
    it; ``num_devices`` maps a device target onto its contiguous partition
    rows, the same P//D tiling failover uses). Untargeted specs, or sites
    that don't carry ``part_verts``, keep the flat sleep attributed to no
    partition (part -1)."""
    pv = ctx.get("part_verts")
    t_part = spec.payload.get("part")
    t_dev = spec.payload.get("device")
    if pv is None or (t_part is None and t_dev is None):
        time.sleep(spec.delay_s)
        return [(-1, float(spec.delay_s))]
    P = len(pv)
    if t_part is not None:
        parts = [int(t_part) % P]
    else:
        D = max(int(ctx.get("num_devices", 1)), 1)
        per = max(P // D, 1)
        d = int(t_dev) % D
        parts = list(range(d * per, min((d + 1) * per, P)))
    stalls = [(p, float(spec.delay_s) * float(pv[p])) for p in parts]
    time.sleep(sum(s for _, s in stalls))
    return stalls


@dataclasses.dataclass
class FaultSpec:
    """One fault to fire: WHERE (site), WHAT (kind), WHEN (at= exact visit
    index, else per-visit probability), and HOW OFTEN (times, then the spec
    disarms). ``delay_s`` is the stall for straggler faults; ``payload``
    rides on the raised exception (e.g. ``lost=1`` devices).

    Straggler payloads may target ``{"part": p}`` (one partition) or
    ``{"device": d}`` (that device's contiguous partition rows). A targeted
    straggler's stall is LOAD-PROPORTIONAL — ``delay_s`` seconds PER LIVE
    VERTEX on the targeted partitions — so migrating sub-graphs off the
    victim shrinks the injected delay, the way a real per-device slowdown
    would respond. An untargeted straggler sleeps a flat ``delay_s``."""
    site: str
    kind: str
    at: Optional[int] = None
    prob: float = 0.0
    times: int = 1
    delay_s: float = 0.0
    payload: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A seeded schedule of :class:`FaultSpec`s plus the record of what
    actually fired (``plan.fired``). Replayable: visit counters reset with
    :meth:`reset`, so the same plan object drives the reference and the
    chaos run of a scenario."""

    def __init__(self, specs, seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        self._visits = {s: 0 for s in SITES}
        self._remaining = [s.times for s in self.specs]
        self._rngs = [np.random.default_rng((self.seed, i))
                      for i in range(len(self.specs))]
        self.fired: list = []

    def visits(self, site: str) -> int:
        return self._visits[site]

    def fire(self, site: str, **ctx) -> Optional[dict]:
        """One visit to `site`: decide per armed spec whether it fires.
        Stragglers sleep; every other kind raises its typed fault (the
        FIRST matching spec wins the raise; its shot is spent either way).

        Returns an EFFECTS dict for non-raising faults so the host loop
        can account for them — ``{"stalls": [(part, seconds), ...]}`` with
        ``part == -1`` for an untargeted stall — or None when nothing
        non-raising fired. The stall record is what makes injected skew
        visible to the time channel of ``obs.skew`` (Gopher Balance)."""
        visit = self._visits[site]
        self._visits[site] = visit + 1
        effects: Optional[dict] = None
        for i, spec in enumerate(self.specs):
            if spec.site != site or self._remaining[i] <= 0:
                continue
            if spec.at is not None:
                hit = visit == spec.at
            else:
                hit = (spec.prob > 0.0
                       and float(self._rngs[i].random()) < spec.prob)
            if not hit:
                continue
            self._remaining[i] -= 1
            rec = dict(site=site, kind=spec.kind, visit=visit,
                       payload=dict(spec.payload),
                       ctx={k: v for k, v in ctx.items()
                            if isinstance(v, (int, float, str, bool))})
            self.fired.append(rec)
            if spec.kind == "straggler":
                stalls = _straggler_stalls(spec, ctx)
                rec["stall_s"] = round(sum(s for _, s in stalls), 6)
                if effects is None:
                    effects = {"stalls": []}
                effects["stalls"].extend(stalls)
                continue
            raise _RAISES[spec.kind](site, spec.kind, visit, spec.payload,
                                     ctx)
        return effects

    def record(self) -> list:
        """What fired so far, JSON-serializable."""
        return list(self.fired)


# ---------------------------------------------------------------- injection
_local = threading.local()


def active() -> Optional[FaultPlan]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def inject(plan: Optional[FaultPlan]):
    """Arm `plan` for the dynamic extent of the block. Nestable (innermost
    plan wins); ``inject(None)`` is a no-op pass-through so scenario code
    can take an optional plan."""
    if plan is None:
        yield None
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(plan)
    try:
        yield plan
    finally:
        stack.pop()


def fire(site: str, **ctx) -> Optional[dict]:
    """The hook entry: sites call this unconditionally; it returns at once
    unless a FaultPlan is active on this thread. Forwards the plan's effects
    dict (straggler stall attributions) so the host loop can charge
    injected delay to the right partition's time channel."""
    plan = active()
    if plan is not None:
        return plan.fire(site, **ctx)
    return None
