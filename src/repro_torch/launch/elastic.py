"""Elastic scaling: re-derive the mesh from the surviving device count, and
Gopher Scope's rebalance hint.

The port of the JAX package's ``launch/elastic.py``.
:func:`plan_mesh`, :func:`shrink_after_failure` and :func:`rebalance_hint`
are pure Python, with the same answers. ``MeshPlan.make`` builds a
one-axis plan's mesh over the first ranks of the default process group
(``launch.mesh.sub_mesh``), as the JAX package takes the first devices;
:func:`restart` re-shards a snapshot onto it, each rank restoring its
rows. The (pod, data, model) meshes and the pspecs that name their axes
are the LM half's (ROADMAP A8.3) and raise naming it.

Policy: keep TP ('model') fixed at the per-arch value (it is matched to
head / expert divisibility), shrink/grow DP ('data'); the pod axis absorbs
whole-pod losses. Partitions-per-device for the graph engine re-balance
because the GoFS partition count is decoupled from the device count
(virtual partitions).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.launch.mesh import sub_mesh

_NEEDS_LM = ("meshes and pspecs over the ('pod', 'data', 'model') axes are "
             "not ported yet: ROADMAP A8.3 (the LM half of the multi-device "
             "backend: models/sharding.py, training/shardspec.py)")


class PartitionSpec(tuple):
    """How a leaf lies on a mesh, as far as :func:`restart` reads the JAX
    package's ``PartitionSpec``: one entry per leading dimension, an axis
    name or None (not split); the empty spec is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def make(self, device="cuda"):
        """The plan's mesh over the first ``prod(shape)`` ranks of the
        default group; None on the ranks after them (which take no part).
        One axis only: the LM meshes are ROADMAP A8.3."""
        if len(self.axes) != 1:
            raise NotImplementedError(_NEEDS_LM)
        n = math.prod(self.shape)
        if n > dist.get_world_size():
            raise ValueError(f"a mesh of {n} ranks in a world of "
                             f"{dist.get_world_size()}")
        return sub_mesh(range(n), self.axes, device)


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


def _spec_leaves(like, spec) -> list:
    """The pspec of each leaf of ``like``, in the checkpoint's leaf order:
    ``spec`` has ``like``'s structure down to a PartitionSpec (or None,
    replicated), which holds for every leaf under it."""
    from repro_torch.training.checkpoint import _leaves_with_paths
    if spec is None or isinstance(spec, PartitionSpec):
        return [spec or PartitionSpec()] * len(_leaves_with_paths(like))
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _spec_leaves(like[k],
                                                              spec[k])]
    if isinstance(like, (list, tuple)):
        return [s for v, sp in zip(like, spec) for s in _spec_leaves(v, sp)]
    raise TypeError(f"a pspec leaf is a PartitionSpec or None, got {spec!r}")


def restart(checkpointer, state_like, plan: MeshPlan, pspecs,
            device="cuda"):
    """Re-shard the last committed checkpoint onto the plan's mesh.
    Returns ``(mesh, state, step)``: each leaf whose pspec splits its
    leading axis over ``'parts'`` holds this rank's rows of it
    (``Checkpointer.restore(rows=)``), a replicated leaf is whole. A rank
    outside the mesh gets ``(None, None, None)``."""
    from repro_torch.training.checkpoint import (_leaves_with_paths,
                                                 _rebuild)
    specs = _spec_leaves(state_like, pspecs)
    if plan.axes != ("parts",) or any(a not in (None, "parts")
                                      for s in specs for a in s):
        raise NotImplementedError(_NEEDS_LM)
    if any(a is not None for s in specs for a in s[1:]):
        raise ValueError("only a leaf's leading axis splits over 'parts'")
    split = [bool(s) and s[0] == "parts" for s in specs]
    leaves = [leaf for _, leaf in _leaves_with_paths(state_like)]
    sizes = {int(x.shape[0]) for x, sp in zip(leaves, split) if sp}
    mesh = plan.make(device)
    if mesh is None:
        return None, None, None
    D, me = mesh.size(), mesh.get_local_rank()
    if len(sizes) > 1 or any(n % D for n in sizes):
        raise ValueError(f"leading axes {sorted(sizes)} do not tile a mesh "
                         f"of {D}")
    step = checkpointer.latest_step()
    picked = {}
    for sp in (True, False):     # each restore reads only its own leaves
        if sp not in split:
            continue
        like = _rebuild(state_like, iter(x if s == sp else None
                                         for x, s in zip(leaves, split)))
        v = sizes.pop() // D if sp else None
        got, _ = checkpointer.restore(
            like, step=step, device=device,
            rows=slice(me * v, (me + 1) * v) if sp else None)
        picked[sp] = iter([x for _, x in _leaves_with_paths(got)])
    state = _rebuild(state_like, (next(picked[sp]) for sp in split))
    return mesh, state, step
