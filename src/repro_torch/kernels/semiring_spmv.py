"""Kernels K1 and K2 — the ELL semiring SpMV on the card, unmasked and
masked by a frontier.

``semiring_spmv_cuda`` launches K1 in ``csrc/semiring_spmv.cu`` (the port
of the JAX package's Pallas ``semiring_spmv_pallas``): y[v] = ⊕_j
x[nbr[v,j]] ⊗ wgt[v,j] for min_plus, max_first and plus_times, one thread
per row. ``semiring_spmv_frontier_cuda`` launches K2 (the port of
``semiring_spmv_frontier_pallas``): the same sweep for min_plus and
max_first, where a row with no active in-neighbour gives the identity
without the x gather. Their plain versions are ``kernels.ref
.semiring_spmv_ref`` and ``semiring_spmv_frontier_ref``; ``kernels.ops``
picks between kernel and plain version by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_CODE = {"min_plus": 0, "max_first": 1, "plus_times": 2}


def _check_ell(x, nbr, wgt, what: str):
    """The checks K1 and K2 share; returns (device, rows, d)."""
    if not x.is_cuda:
        raise ValueError(f"kernel {what} needs CUDA tensors, got {x.device}")
    if x.dim() != 1 or nbr.dim() != 2:
        raise ValueError(f"x must be (V,) and nbr (V, D), got "
                         f"{tuple(x.shape)} and {tuple(nbr.shape)}")
    dev = x.device
    rows, d = nbr.shape
    _build.need(x, "x", torch.float32, dev, x.shape)
    _build.need(nbr, "nbr", torch.int32, dev, (rows, d))
    _build.need(wgt, "wgt", torch.float32, dev, (rows, d))
    if rows * d >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"kernel {what} indexes with int32: V·D must be "
                         f"< 2^31")
    return dev, rows, d


def semiring_spmv_cuda(x: torch.Tensor, nbr: torch.Tensor, wgt: torch.Tensor,
                       semiring: str) -> torch.Tensor:
    """y[v] = ⊕_j ( x[nbr[v,j]] ⊗ wgt[v,j] ) by kernel K1.

    x: (V_x,) float32; nbr: (V, D) int32 with PAD (-1) fill, every other
    entry in [0, V_x); wgt: (V, D) float32; all on one CUDA device.
    Returns y (V,) float32 on that device."""
    if semiring not in _CODE:
        raise ValueError(f"unknown semiring {semiring}")
    dev, rows, d = _check_ell(x, nbr, wgt, "K1")
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.semiring_spmv_launch(
        x.data_ptr(), nbr.data_ptr(), wgt.data_ptr(), y.data_ptr(), rows, d,
        _CODE[semiring], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "semiring_spmv")
    _build.launches["semiring_spmv"] += 1
    return y


def semiring_spmv_frontier_cuda(x: torch.Tensor, frontier: torch.Tensor,
                                nbr: torch.Tensor, wgt: torch.Tensor,
                                semiring: str):
    """The frontier-masked sweep by kernel K2: rows with no active
    in-neighbour give the ⊕-identity. ``frontier`` is (V_x,) bool on the
    same device as x; min_plus and max_first only. Returns (y (V,) float32,
    row_active (V,) bool), bit-identical to ``semiring_spmv_frontier_ref``."""
    if semiring not in ("min_plus", "max_first"):
        raise ValueError("frontier masking requires an idempotent ⊕ (min/max)")
    dev, rows, d = _check_ell(x, nbr, wgt, "K2")
    _build.need(frontier, "frontier", torch.bool, dev, x.shape)
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    act = torch.empty(rows, dtype=torch.bool, device=dev)
    lib = _build.library()
    err = lib.semiring_spmv_frontier_launch(
        x.data_ptr(), frontier.data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
        y.data_ptr(), act.data_ptr(), rows, d, _CODE[semiring], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "semiring_spmv_frontier")
    _build.launches["semiring_spmv_frontier"] += 1
    return y, act
