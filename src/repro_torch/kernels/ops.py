"""Kernel dispatch by device.

``semiring_spmv`` runs the plain PyTorch version for a tensor on the CPU
and kernel K1 for a tensor on a CUDA device; any other device raises. The
choice follows the tensor and nothing else: there is no switch that picks
the plain version on the card, and no fallback when the kernel fails.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import semiring_spmv_ref
from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda


def semiring_spmv(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor,
                  semiring: str) -> torch.Tensor:
    """y[v] = ⊕_j ( x[nbr[v,j]] ⊗ wgt[v,j] ) — see ``semiring_spmv_ref``."""
    if x.is_cuda:
        return semiring_spmv_cuda(x, nbr, wgt, semiring)
    if x.device.type == "cpu":
        return semiring_spmv_ref(x, nbr, wgt, semiring)
    raise ValueError(f"semiring_spmv has no path for device {x.device}")
