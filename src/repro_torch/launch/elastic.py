"""Elastic scaling: re-derive the mesh from the surviving device count, and
Gopher Scope's rebalance hint.

The port of the JAX package's ``launch/elastic.py``.
:func:`plan_mesh`, :func:`shrink_after_failure` and :func:`rebalance_hint`
are pure Python, with the same answers. ``MeshPlan.make`` builds the
plan's mesh (the graph engine's ``('parts',)``, or the LM's ``('data',
'model')`` and ``('pod', 'data', 'model')``) over the first ranks of the
default process group (``launch.mesh.sub_mesh``), as the JAX package
takes the first devices; :func:`restart` re-shards a snapshot onto it,
each rank restoring its block of every leaf by the leaf's pspec
(``training.shardspec.local_index``).

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
from repro_torch.models.sharding import PartitionSpec, axes_of

__all__ = ["MeshPlan", "PartitionSpec", "plan_mesh", "rebalance_hint",
           "restart", "shrink_after_failure"]


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def make(self, device="cuda"):
        """The plan's mesh over the first ``prod(shape)`` ranks of the
        default group, row-major; None on the ranks after them (which take
        no part)."""
        n = math.prod(self.shape)
        if n > dist.get_world_size():
            raise ValueError(f"a mesh of {n} ranks in a world of "
                             f"{dist.get_world_size()}")
        return sub_mesh(range(n), self.axes, device, shape=self.shape)


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
    Returns ``(mesh, state, step)``: each leaf holds this rank's block by
    its pspec (``shardspec.local_index``: the rows of a ``('parts',)``
    leaf, an LM parameter's FSDP x TP block, Mamba1's in_proj by its
    channels), read from the snapshot one block a leaf
    (``Checkpointer.restore(index=)``); a replicated leaf is whole. A rank
    outside the mesh gets ``(None, None, None)``. A pspec naming an axis
    the plan lacks, or a split that does not divide, raises
    ``ValueError`` before any rank builds the mesh."""
    from repro_torch.training.checkpoint import _leaves_with_paths
    from repro_torch.training.shardspec import leaf_names, local_index
    specs = _spec_leaves(state_like, pspecs)
    names = leaf_names(state_like)
    shapes = [tuple(getattr(x, "shape", ()))
              for _, x in _leaves_with_paths(state_like)]
    sizes = dict(zip(plan.axes, plan.shape))
    for name, spec, shape in zip(names, specs, shapes):
        for d, entry in enumerate(spec):
            axes = axes_of(entry)
            if any(a not in sizes for a in axes):
                raise ValueError(f"{name}: pspec {spec} names an axis "
                                 f"outside the plan's {plan.axes}")
            k = math.prod(sizes[a] for a in axes)
            if d >= len(shape) or shape[d] % k:
                raise ValueError(f"{name}: pspec {spec} does not tile its "
                                 f"shape {shape} on the mesh {plan.shape}")
    mesh = plan.make(device)
    if mesh is None:
        return None, None, None
    step = checkpointer.latest_step()
    index = [local_index(n, sp, shape, mesh) if sp else None
             for n, sp, shape in zip(names, specs, shapes)]
    state, _ = checkpointer.restore(state_like, step=step, device=device,
                                    index=index)
    return mesh, state, step
