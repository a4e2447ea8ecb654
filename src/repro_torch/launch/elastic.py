"""Elastic scaling: re-derive the mesh from the surviving device count, and
Gopher Scope's rebalance hint.

The port of the JAX package's ``launch/elastic.py``, its host half:
:func:`plan_mesh`, :func:`shrink_after_failure` and :func:`rebalance_hint`
are pure Python, with the same answers. Building a mesh from a plan
(``MeshPlan.make``) and re-sharding a checkpoint onto it (:func:`restart`)
wait for ROADMAP A8.2 (the mesh's device-loss half) and raise naming it.

Policy: keep TP ('model') fixed at the per-arch value (it is matched to
head / expert divisibility), shrink/grow DP ('data'); the pod axis absorbs
whole-pod losses. Partitions-per-device for the graph engine re-balance
because the GoFS partition count is decoupled from the device count
(virtual partitions).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_NEEDS_MESH = ("re-deriving a mesh after device loss is not ported yet: "
               "ROADMAP A8.2 (the multi-device backend's service and "
               "device-loss half)")


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def make(self):
        raise NotImplementedError(_NEEDS_MESH)


def plan_mesh(n_chips: int, model_parallel: int = 16,
              pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) mesh that fits n_chips with fixed TP."""
    per_pod = n_chips // pods
    data = max(per_pod // model_parallel, 1)
    if pods > 1:
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    return MeshPlan((data, model_parallel), ("data", "model"))


def shrink_after_failure(old: MeshPlan, lost_chips: int) -> MeshPlan:
    """Drop whole DP rows to cover the loss — TP groups stay intact, so
    parameter shards remain co-resident and restore is a pure re-shard.

    A 1-axis ``('parts',)`` mesh (the graph engine's) shrinks to the
    surviving device count directly: GoFS virtual partitions are decoupled
    from devices, so ANY surviving count re-tiles the same partitions."""
    if old.axes == ("parts",):
        return MeshPlan((max(old.shape[0] - lost_chips, 1),), ("parts",))
    shape = dict(zip(old.axes, old.shape))
    model = shape.get("model", 1)
    pods = shape.get("pod", 1)
    total = 1
    for s in old.shape:
        total *= s
    survivors = total - lost_chips
    rows_needed = -(-lost_chips // (model))
    data = shape.get("data", 1) - rows_needed
    if data < 1:
        # fall back to fewer pods
        pods = max(pods - 1, 1)
        data = max(survivors // (pods * model), 1)
    if pods > 1:
        return MeshPlan((pods, data, model), ("pod", "data", "model"))
    return MeshPlan((data, model), ("data", "model"))


def rebalance_hint(skew: dict, threshold: float = 1.5,
                   floor: float = 1.1,
                   acting: bool = False) -> Optional[dict]:
    """Gopher Scope feedback for the elastic layer: given a live skew report
    (``Telemetry.skew()`` / ``SkewTracker.report()``), decide whether the
    virtual-partition layout is worth re-balancing and which partition to
    shed load FROM. Acting on the hint is a migration, not a mesh change.

    Two load signals are read and the WORSE one wins: the iteration channel
    (``imbalance``/``straggler`` — structural compute skew) and the wall-
    clock channel (``time_imbalance``/``time_straggler`` — a slow device
    shows up here even when iteration counts stay flat).

    Hysteresis so an actuator driven by this hint cannot oscillate: an IDLE
    caller trips only above ``threshold``; a caller that is already
    migrating (``acting=True``) keeps getting a hint until the score falls
    to the ``floor``. On a balanced mesh (score at or below the floor) the
    hint is ALWAYS ``None``."""
    imb_it = float(skew.get("imbalance", 0.0))
    imb_t = float(skew.get("time_imbalance", 0.0))
    use_time = imb_t > imb_it
    imb = imb_t if use_time else imb_it
    gate = max(float(floor), 1.0) if acting else max(float(threshold),
                                                     float(floor))
    if imb <= gate:
        return None
    src = int(skew.get("time_straggler", -1) if use_time
              else skew.get("straggler", -1))
    if src < 0:
        return None
    return dict(migrate_from=src, imbalance=imb,
                signal="time" if use_time else "iters",
                wasted_speedup_pct=round((1.0 - 1.0 / imb) * 100.0, 1))


def restart(checkpointer, state_like, plan: MeshPlan, pspecs):
    """Re-shard the last committed checkpoint onto the new mesh."""
    raise NotImplementedError(_NEEDS_MESH)
