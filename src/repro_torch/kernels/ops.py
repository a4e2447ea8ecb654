"""Kernel dispatch by device.

Each function runs the plain PyTorch version for a tensor on the CPU and
its hand-written kernel for a tensor on a CUDA device; any other device
raises. The choice follows the tensor and nothing else: there is no switch
that picks the plain version on the card, and no fallback when the kernel
fails.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.outbox_compact import (outbox_compact_plan_cuda,
                                                outbox_pack_cuda)
from repro_torch.kernels.ref import (outbox_compact_plan_ref, outbox_pack_ref,
                                     semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import (semiring_spmv_cuda,
                                               semiring_spmv_frontier_cuda)


def _pick(t: torch.Tensor, cuda, plain, what: str):
    if t.is_cuda:
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{what} has no path for device {t.device}")


def semiring_spmv(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor,
                  semiring: str) -> torch.Tensor:
    """y[v] = ⊕_j ( x[nbr[v,j]] ⊗ wgt[v,j] ): kernel K1 or
    ``semiring_spmv_ref``."""
    return _pick(x, semiring_spmv_cuda, semiring_spmv_ref,
                 "semiring_spmv")(x, nbr, wgt, semiring)


def semiring_spmv_frontier(x: torch.Tensor, frontier: torch.Tensor,
                           nbr: torch.Tensor, wgt: torch.Tensor,
                           semiring: str):
    """The frontier-masked sweep, (y, row_active): kernel K2 or
    ``semiring_spmv_frontier_ref``."""
    return _pick(x, semiring_spmv_frontier_cuda, semiring_spmv_frontier_ref,
                 "semiring_spmv_frontier")(x, frontier, nbr, wgt, semiring)


def outbox_pack(slot_vals: torch.Tensor, active: torch.Tensor,
                limit: torch.Tensor, ident: float):
    """(pvals, sids, pinv, counts, over) of (R, cap) slot values: kernel K5
    or ``outbox_pack_ref``. Both refuse query-batched (R, cap, Q) values."""
    return _pick(active, outbox_pack_cuda, outbox_pack_ref,
                 "outbox_pack")(slot_vals, active, limit, ident)


def outbox_compact_plan(active: torch.Tensor):
    """(pfwd, pinv, counts) of an (R, cap) active mask: kernel K6 or
    ``outbox_compact_plan_ref``."""
    return _pick(active, outbox_compact_plan_cuda, outbox_compact_plan_ref,
                 "outbox_compact_plan")(active)
