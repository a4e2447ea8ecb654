"""Kernel dispatch by device.

Each function runs the plain PyTorch version for a tensor on the CPU and
its hand-written kernel for a tensor on a CUDA device; any other device
raises. The choice follows the tensor and nothing else: there is no switch
that picks the plain version on the card, and no fallback when the kernel
fails. ``batch_invariant_matmul`` is the one product whose form on the card
(not a kernel of its own) differs from the CPU's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(B, Sq, H, dh) attention of q over (B, Sk, KV, dh) keys and values:
    kernel K7 or ``flash_attention_ref``."""
    return _pick(q, flash_attention_cuda, flash_attention_ref,
                 "flash_attention")(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)


def mamba1_scan(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                Cv: torch.Tensor, A: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                return_state: bool = False,
                y_dtype: Optional[torch.dtype] = None):
    """The Mamba1 selective scan from state ``h0`` (zeros when None), y
    (B, L, D) in x's dtype or ``y_dtype``, and with ``return_state`` the
    final state (B, D, N) float32: kernel K8 or ``mamba1_scan_ref``."""
    return _pick(x, mamba1_scan_cuda, mamba1_scan_ref,
                 "mamba1_scan")(x, delta, Bv, Cv, A, h0,
                                return_state=return_state, y_dtype=y_dtype)


# cuBLAS (CUDA 12.8 on an H100) splits the reduction of a bf16 product over
# K when the call has few rows: at falcon-mamba-7b's x_proj and out_proj
# (K = 8192) below 512 and 128 rows (tools/gemm_rows.py), so a decode
# step's rows round otherwise than the same rows of a prefill or forward.
INVARIANT_ROWS = 512


def batch_invariant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for x (..., K), each row's bits independent of how many rows
    the call has: on the card a call of fewer than ``INVARIANT_ROWS`` rows
    runs on that many, the rows added left unwritten (a row of the product
    reads only its own row of x, so they never reach the rows returned,
    and no fill is launched); on the CPU it is x @ w."""
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    if not x.is_cuda or n >= INVARIANT_ROWS:
        return x @ w
    rows = flat.new_empty((INVARIANT_ROWS, flat.shape[1]))
    rows[:n] = flat
    return (rows @ w)[:n].reshape(*x.shape[:-1], w.shape[1])
