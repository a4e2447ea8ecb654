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
