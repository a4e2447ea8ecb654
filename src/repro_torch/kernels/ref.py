"""Plain PyTorch versions of the ELL semiring sweeps.

They are the arithmetic the hand-written kernels are held to: the CPU path
of every wrapper, and the oracle ``chip_smoke.py`` compares each kernel with
on the card. Row for row the math of the JAX package's ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.gofs.formats import PAD

SEMIRINGS = ("min_plus", "max_first", "plus_times")

INF = float("inf")


def semiring_spmv_ref(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor,
                      semiring: str) -> torch.Tensor:
    """ELL semiring sweep: y[v] = ⊕_j ( x[nbr[v,j]] ⊗ wgt[v,j] ).

    x: (V,) float32; nbr: (V, D) int32 with PAD fill; wgt: (V, D) float32.
    Semirings: min_plus (SSSP), max_first (CC/MaxVertex — ⊗ ignores wgt),
    plus_times (PageRank). All-PAD rows give the ⊕-identity.
    """
    valid = nbr != PAD
    g = x[torch.where(valid, nbr, 0).long()]  # (V, D)
    if semiring == "min_plus":
        return torch.where(valid, g + wgt, INF).amin(dim=1)
    if semiring == "max_first":
        return torch.where(valid, g, -INF).amax(dim=1)
    if semiring == "plus_times":
        return torch.where(valid, g * wgt, 0.0).sum(dim=1)
    raise ValueError(f"unknown semiring {semiring}")


def semiring_spmv_frontier_ref(x: torch.Tensor, frontier: torch.Tensor,
                               nbr: torch.Tensor, wgt: torch.Tensor,
                               semiring: str):
    """Frontier-masked ELL sweep: rows with NO active in-neighbor yield the
    ⊕-identity (the caller's element-wise combine keeps their old state);
    rows WITH one reduce their full neighbor list, exactly like the unmasked
    sweep. Idempotent semirings only. Returns (y, row_active)."""
    if semiring not in ("min_plus", "max_first"):
        raise ValueError("frontier masking requires an idempotent ⊕ (min/max)")
    valid = nbr != PAD
    safe = torch.where(valid, nbr, 0).long()
    row_active = (valid & frontier[safe]).any(dim=1)
    y = semiring_spmv_ref(x, nbr, wgt, semiring)
    ident = INF if semiring == "min_plus" else -INF
    return torch.where(row_active, y, ident), row_active


def outbox_compact_plan_ref(active: torch.Tensor):
    """Per-row compaction plan of the compact exchange. ``active``: (R, cap)
    bool, the mailbox slots whose source is in the send set. Returns

      pfwd   (R, cap) int32  packed position j -> slot id of the j-th active
                             slot in ascending slot order (PAD past count)
      pinv   (R, cap) int32  slot id -> packed position (PAD if inactive)
      counts (R,)   int32    active slots per row (the wire header)

    :func:`outbox_pack_ref` with no truncation and no values."""
    R, cap = active.shape
    full = torch.full((R,), cap, dtype=torch.int32, device=active.device)
    _, pfwd, pinv, counts, _ = outbox_pack_ref(
        torch.zeros(active.shape, device=active.device), active, full, 0.0)
    return pfwd, pinv, counts


def outbox_pack_ref(slot_vals: torch.Tensor, active: torch.Tensor,
                    limit: torch.Tensor, ident: float):
    """Compaction plan, truncation and value pack in one pass: the packed
    position of an active slot is its prefix count minus one.

    slot_vals: (R, cap) or query-batched (R, cap, Q) float32 dense slot
    values; active: (R, cap) bool; limit: (R,) int32 per-row slot budget —
    positions at or past it are dropped and flagged in ``over``. Returns

      pvals  like slot_vals    packed prefix, ``ident`` past min(count,
                               limit); a query-batched slot moves its whole
                               Q-vector
      sids   (R, cap) int32    packed position -> slot id (PAD past the prefix)
      pinv   (R, cap) int32    slot id -> packed position (PAD if inactive or
                               dropped)
      counts (R,)   int32      UNtruncated active count
      over   (R,)   int32      1 where counts > limit

    Values are placed by a scatter of the values themselves, never by a
    multiply, so an active ±inf message survives."""
    R, cap = active.shape
    csum = torch.cumsum(active.int(), dim=1)
    counts = csum[:, -1] if cap else torch.zeros(R, dtype=torch.int64,
                                                   device=active.device)
    pos = csum - 1
    keep = active & (pos < limit[:, None])
    dest = torch.where(keep, pos, cap).long()           # cap -> dropped
    slot = torch.arange(cap, dtype=torch.int32,
                        device=active.device).expand(R, cap)
    sids = torch.full((R, cap + 1), PAD, dtype=torch.int32,
                      device=active.device).scatter_(1, dest, slot)
    pvals = scatter_prefix(slot_vals, dest, ident)
    pinv = torch.where(keep, pos, PAD).int()
    over = (counts > limit).int()
    return pvals, sids[:, :cap], pinv, counts.int(), over


def scatter_prefix(slot_vals: torch.Tensor, dest: torch.Tensor,
                   ident: float) -> torch.Tensor:
    """The value half of the pack: slot (r, c) of ``slot_vals`` — a value,
    or with a trailing query axis a Q-vector — lands at packed position
    ``dest[r, c]``; ``dest == cap`` drops it. Every other position holds
    ``ident``."""
    R, cap = dest.shape
    tail = slot_vals.shape[2:]
    idx = dest.reshape(R, cap, *(1,) * len(tail)).expand(slot_vals.shape)
    out = torch.full((R, cap + 1, *tail), ident, dtype=slot_vals.dtype,
                     device=slot_vals.device)
    return out.scatter_(1, idx, slot_vals)[:, :cap]
