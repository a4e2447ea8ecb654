"""What both routes share over flat (P·v_max,) state.

- the ⊕ algebra of the mailbox and the sweeps: :data:`COMBINE_IDENTITY`,
  :func:`combine_reduce`, :func:`combine_ew`;
- :func:`flat_adjacency`, the local adjacency of all P partitions as one
  ELL, and its :func:`unit_weights` for PageRank's pull
  (:func:`sweep_flat_dense`, kernel K1 on the card);
- :func:`local_fixpoint`, the masked local fixpoint of every partition in
  lock step: the staged route sweeps it with kernel K2, the fused
  superstep's plain version (``kernels.megastep``) with K2's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.gofs.formats import PAD
from repro_torch.kernels import ops
from repro_torch.kernels.ref import semiring_spmv_frontier_ref

INF = float("inf")
COMBINE_IDENTITY = {"min": INF, "max": -INF, "sum": 0.0}
MAX_LOCAL_ITERS = 2 ** 30       # the unbounded fixpoint's loop cap


def combine_reduce(combine: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """⊕-reduce ``t`` over ``dim``."""
    if combine == "sum":
        return t.sum(dim=dim)
    return t.amin(dim=dim) if combine == "min" else t.amax(dim=dim)


def combine_ew(combine: str, a, b):
    """Element-wise a ⊕ b."""
    if combine == "sum":
        return a + b
    return torch.minimum(a, b) if combine == "min" else torch.maximum(a, b)


def idempotent_combine(semiring: str) -> str:
    """The ⊕ of an idempotent semiring; any other raises."""
    if semiring not in ("min_plus", "max_first"):
        raise ValueError(f"needs an idempotent semiring, got {semiring}")
    return "min" if semiring == "min_plus" else "max"


def flat_adjacency(gb: dict) -> dict:
    """The local adjacency over flat (P·v_max,) state: ``nbr`` (n, D) int32
    with each partition's local indices offset by p·v_max and PAD lanes
    kept PAD (every reader tests idx >= 0), and ``wgt`` (n, D). Both routes
    sweep it — the fused superstep inside K3, the staged route with one K1
    or K2 launch per sweep over all P partitions."""
    nbr = gb["nbr"]
    P, v_max, d = nbr.shape
    off = torch.arange(P, dtype=torch.int32, device=nbr.device) * v_max
    flat = torch.where(nbr != PAD, off[:, None, None] + nbr, PAD)
    return {"nbr": flat.reshape(P * v_max, d).contiguous(),
            "wgt": gb["wgt"].reshape(P * v_max, d).contiguous()}


def unit_weights(adj: dict) -> torch.Tensor:
    """Unit edge weights over the flat adjacency (a :func:`flat_adjacency`
    or a composed mailbox), for PageRank's pull: made on first use and kept
    in ``adj``, so the semiring programs never hold them."""
    if "ones" not in adj:
        adj["ones"] = torch.ones(adj["nbr"].shape, dtype=torch.float32,
                                 device=adj["nbr"].device)
    return adj["ones"]


def sweep_flat_dense(x: torch.Tensor, adj: dict) -> torch.Tensor:
    """Unmasked plus_times sweep with unit weights over the flat adjacency
    (PageRank's pull): ``ops.semiring_spmv``, so kernel K1 on the card."""
    return ops.semiring_spmv(x, adj["nbr"], unit_weights(adj), "plus_times")


def local_fixpoint(x, f, adj: dict, vmask, num_parts: int, semiring: str,
                   unroll: int = 1, max_it: int = MAX_LOCAL_ITERS,
                   sweep=semiring_spmv_frontier_ref):
    """The masked local fixpoint of every partition at once, in lock step
    over the flat (P·v_max,) state. ``sweep`` is a frontier-masked sweep
    with the contract of ``semiring_spmv_frontier_ref`` (the plain version
    for the fused superstep's reference, ``ops.semiring_spmv_frontier`` on
    the staged route). Returns ``(x, f_left, liters)``.

    Each partition of the JAX package runs its own loop, which ends when its
    frontier is empty or its counter reaches ``max_it``. Here one loop runs
    while any frontier is non-empty and the shared counter is below
    ``max_it``: local edges never leave a partition, so a quiesced
    partition's sweeps are no-ops for idempotent ⊕, and every partition
    still running entered the loop together, so the shared counter is its
    own. ``liters`` grows by ``unroll`` for a partition only on trips its
    frontier was non-empty when the trip began."""
    combine = idempotent_combine(semiring)
    li = torch.zeros(num_parts, dtype=torch.int32, device=x.device)
    it = 0
    while it < max_it and bool(f.any()):
        li = li + unroll * f.reshape(num_parts, -1).any(dim=1).int()
        for _ in range(unroll):
            y, _ = sweep(x, f, adj["nbr"], adj["wgt"], semiring)
            x2 = combine_ew(combine, x, y)
            f = (x2 != x) & vmask
            x = x2
        it += unroll
    return x, f, li
