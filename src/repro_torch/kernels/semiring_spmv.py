"""Kernel K1 — the ELL semiring SpMV on the card.

``semiring_spmv_cuda`` launches ``csrc/semiring_spmv.cu`` (the port of the
JAX package's Pallas ``semiring_spmv_pallas``): y[v] = ⊕_j x[nbr[v,j]] ⊗
wgt[v,j] for min_plus, max_first and plus_times, one thread per row. Its
plain version is ``kernels.ref.semiring_spmv_ref``; ``kernels.ops
.semiring_spmv`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_CODE = {"min_plus": 0, "max_first": 1, "plus_times": 2}


def semiring_spmv_cuda(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor,
                       semiring: str) -> torch.Tensor:
    """y[v] = ⊕_j ( x[nbr[v,j]] ⊗ wgt[v,j] ) by kernel K1.

    x: (V_x,) float32; nbr: (V, D) int32 with PAD (-1) fill, every other
    entry in [0, V_x); wgt: (V, D) float32; all on one CUDA device.
    Returns y (V,) float32 on that device."""
    if semiring not in _CODE:
        raise ValueError(f"unknown semiring {semiring}")
    if not x.is_cuda:
        raise ValueError(f"kernel K1 needs CUDA tensors, got {x.device}")
    dev = x.device
    if x.dim() != 1 or nbr.dim() != 2:
        raise ValueError(f"x must be (V,) and nbr (V, D), got "
                         f"{tuple(x.shape)} and {tuple(nbr.shape)}")
    rows, d = nbr.shape
    _build.need(x, "x", torch.float32, dev, x.shape)
    _build.need(nbr, "nbr", torch.int32, dev, (rows, d))
    _build.need(wgt, "wgt", torch.float32, dev, (rows, d))
    if rows * d >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError("kernel K1 indexes with int32: V·D must be < 2^31")
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.semiring_spmv_launch(
        x.data_ptr(), nbr.data_ptr(), wgt.data_ptr(), y.data_ptr(), rows, d,
        _CODE[semiring], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "semiring_spmv")
    _build.launches["semiring_spmv"] += 1
    return y
