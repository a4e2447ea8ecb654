"""What both routes share over flat (P·v_max,) state.

- the ⊕ algebra of the mailbox and the sweeps: :data:`COMBINE_IDENTITY`,
  :func:`combine_reduce`, :func:`combine_ew`;
- :func:`flat_adjacency`, the local adjacency of all P partitions as one
  ELL, and its :func:`unit_weights` for PageRank's pull
  (:func:`sweep_flat_dense`, kernel K1 on the card);
- :func:`flat_binned_adjacency`, the two-bin adjacency the serving sweeps
  read, over the same flat state;
- :func:`local_fixpoint`, the masked local fixpoint of every partition in
  lock step: the staged route sweeps it with kernel K2, the fused
  superstep's plain version (``kernels.megastep``) with K2's plain version,
  query batches with the two-bin multi-vector sweep.
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


def flat_binned_adjacency(gb: dict) -> dict:
    """The two-bin local adjacency (the block's ``nbr_lo``/``wgt_lo`` and
    hub rows ``adj_hub_*``) over flat (P·v_max,) state, keyed as in the
    block: ``nbr_lo`` (n, w_lo) and ``adj_hub_nbr`` (P·ah_max, D) with
    each partition's local indices offset by p·v_max, ``adj_hub_idx``
    (P·ah_max,) each hub row's flat row, PAD kept PAD throughout. The
    serving sweeps (``ops.binned_ell_spmv_multi`` and its frontier form)
    read it on both routes."""
    P, v_max = gb["vmask"].shape
    off = torch.arange(P, dtype=torch.int32, device=gb["vmask"].device) \
        * v_max

    def shift(idx):
        o = off.reshape((P,) + (1,) * (idx.dim() - 1))
        return torch.where(idx != PAD, o + idx, PAD).int()

    lo, hn = gb["nbr_lo"], gb["adj_hub_nbr"]
    return {
        "nbr_lo": shift(lo).reshape(P * v_max, -1).contiguous(),
        "wgt_lo": gb["wgt_lo"].reshape(P * v_max, -1).contiguous(),
        "adj_hub_idx": shift(gb["adj_hub_idx"]).reshape(-1).contiguous(),
        "adj_hub_nbr": shift(hn).reshape(-1, hn.shape[-1]).contiguous(),
        "adj_hub_wgt": gb["adj_hub_wgt"].reshape(-1, hn.shape[-1])
        .contiguous()}


def binned_plan_of(adj: dict, unit: bool = False) -> dict:
    """The sweeps' form (``ops.binned_plan``) of a
    :func:`flat_binned_adjacency` (or a composed mailbox holding one),
    built on first use and kept in ``adj``; ``unit=True`` the same with
    unit edge weights, for PageRank's pull."""
    key = "unit_plan" if unit else "plan"
    if key not in adj:
        lo, hub = adj["wgt_lo"], adj["adj_hub_wgt"]
        if unit:
            lo, hub = torch.ones_like(lo), torch.ones_like(hub)
        adj[key] = ops.binned_plan(adj["nbr_lo"], lo, adj["adj_hub_idx"],
                                   adj["adj_hub_nbr"], hub)
    return adj[key]


def binned_sweep_frontier(x, f, plan: dict, semiring: str):
    """:func:`local_fixpoint`'s sweep over query-trailing (n, Q) state and
    a :func:`binned_plan_of` (``operands=("plan",)``):
    ``ops.binned_sweep``, in the (y, act) form of the scalar frontier
    sweeps (``act`` unused, None)."""
    return ops.binned_sweep(x, f, plan, semiring), None


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
                   sweep=semiring_spmv_frontier_ref,
                   operands=("nbr", "wgt")):
    """The masked local fixpoint of every partition at once, in lock step
    over the flat (P·v_max,) state — or query-trailing (P·v_max, Q) state,
    with ``vmask`` (n, 1). ``sweep`` is a frontier-masked sweep with the
    contract of ``semiring_spmv_frontier_ref``, called on the ``adj``
    entries named by ``operands`` (the plain version for the fused
    superstep's reference, ``ops.semiring_spmv_frontier`` on the staged
    route, :func:`binned_sweep_frontier` over the ``plan`` of
    :func:`binned_plan_of` for query batches). Returns
    ``(x, f_left, liters)``.

    Each partition of the JAX package runs its own loop, which ends when its
    frontier is empty or its counter reaches ``max_it``. Here one loop runs
    while any frontier is non-empty and the shared counter is below
    ``max_it``: local edges never leave a partition, so a quiesced
    partition's sweeps are no-ops for idempotent ⊕, and every partition
    still running entered the loop together, so the shared counter is its
    own. ``liters`` grows by ``unroll`` for a partition only on trips its
    frontier (any lane of it) was non-empty when the trip began."""
    combine = idempotent_combine(semiring)
    args = [adj[k] for k in operands]
    li = torch.zeros(num_parts, dtype=torch.int32, device=x.device)
    it = 0
    while it < max_it and bool(f.any()):
        li = li + unroll * f.reshape(num_parts, -1).any(dim=1).int()
        for _ in range(unroll):
            y, _ = sweep(x, f, *args, semiring)
            x2 = combine_ew(combine, x, y)
            f = (x2 != x) & vmask
            x = x2
        it += unroll
    return x, f, li
