"""Kernel dispatch by device.

Each kernel's function runs the plain PyTorch version for a tensor on the
CPU and its hand-written kernel for a tensor on a CUDA device; any other
device raises. The choice follows the tensor and nothing else: there is no
switch that picks the plain version on the card, and no fallback when the
kernel fails. ``batch_invariant_matmul`` is the one product whose form on the card
(not a kernel of its own) differs from the CPU's. The serving sweeps
(``binned_ell_spmv_multi`` and its frontier form, ``binned_sweep`` over a
prepared ``binned_plan``) are plain torch ops on every device, as the JAX
package computes them outside any Pallas kernel;
``multibin_spmv`` sweeps each degree bin with kernel K1 on the card.

``flash_attention`` and ``mamba1_scan`` are ``torch.autograd.Function``s:
their forward is K7 or K8 (or the plain version) and their backward K7b or
K8b (or the plain backward, written out as formulas), picked by the same
rule. With no input that requires a gradient they launch exactly what the
forward launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.gofs.formats import PAD

from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import (mamba1_scan_bwd_cuda,
                                            mamba1_scan_bwd_ref,
                                            mamba1_scan_cuda, mamba1_scan_ref)
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
    """(pvals, sids, pinv, counts, over) of (R, cap) or query-batched
    (R, cap, Q) slot values: kernel K5 (for Q-vectors its plan, then one
    masked scatter) or ``outbox_pack_ref``."""
    return _pick(active, outbox_pack_cuda, outbox_pack_ref,
                 "outbox_pack")(slot_vals, active, limit, ident)


def outbox_compact_plan(active: torch.Tensor):
    """(pfwd, pinv, counts) of an (R, cap) active mask: kernel K6 or
    ``outbox_compact_plan_ref``."""
    return _pick(active, outbox_compact_plan_cuda, outbox_compact_plan_ref,
                 "outbox_compact_plan")(active)


class _FlashAttention(torch.autograd.Function):
    """K7 forward, K7b backward (the plain versions on the CPU). When a
    gradient is wanted the forward also returns each row's log-sum-exp,
    saved beside the output for the backward; otherwise the forward is
    the serving launch, which writes no lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fwd = _pick(q, flash_attention_cuda, flash_attention_ref,
                    "flash_attention")
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if any(ctx.needs_input_grad):
            o, lse = fwd(q, k, v, return_lse=True, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = fwd(q, k, v, **kw)
        ctx.mask = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _pick(q, flash_attention_bwd_cuda,
                           flash_attention_bwd_ref, "flash_attention_bwd")(
            q, k, v, o, do.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(B, Sq, H, dh) attention of q over (B, Sk, KV, dh) keys and values:
    kernel K7 or ``flash_attention_ref``; its gradient kernel K7b or
    ``flash_attention_bwd_ref``. With gradients off (``torch.no_grad``,
    the serving steps) it is the forward alone, which writes no lse."""
    if not torch.is_grad_enabled():
        return _pick(q, flash_attention_cuda, flash_attention_ref,
                     "flash_attention")(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)


class _MambaScan(torch.autograd.Function):
    """K8 forward, K8b backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, delta, Bv, Cv, A, h0, return_state, y_dtype):
        ctx.set_materialize_grads(False)
        out = _pick(x, mamba1_scan_cuda, mamba1_scan_ref, "mamba1_scan")(
            x, delta, Bv, Cv, A, h0, return_state=return_state,
            y_dtype=y_dtype)
        ctx.save_for_backward(x, delta, Bv, Cv, A, h0)
        return out

    @staticmethod
    def backward(ctx, dy, dh_last=None):
        x, delta, Bv, Cv, A, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, dd, dB, dC, dA, dh0 = _pick(
            x, mamba1_scan_bwd_cuda, mamba1_scan_bwd_ref,
            "mamba1_scan_bwd")(x, delta, Bv, Cv, A, h0, dy.contiguous(),
                               None if dh_last is None
                               else dh_last.contiguous())
        return dx, dd, dB, dC, dA, dh0, None, None


def mamba1_scan(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                Cv: torch.Tensor, A: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                return_state: bool = False,
                y_dtype: Optional[torch.dtype] = None):
    """The Mamba1 selective scan from state ``h0`` (zeros when None), y
    (B, L, D) in x's dtype or ``y_dtype``, and with ``return_state`` the
    final state (B, D, N) float32: kernel K8 or ``mamba1_scan_ref``; its
    gradient kernel K8b or ``mamba1_scan_bwd_ref``."""
    return _MambaScan.apply(x, delta, Bv, Cv, A, h0, return_state, y_dtype)


# ---------------- the serving sweeps: two-bin ELL over Q vectors -----------

_IDENT = {"min_plus": float("inf"), "max_first": -float("inf"),
          "plus_times": 0.0}
_MERGE = {"min_plus": "amin", "max_first": "amax"}


def binned_plan(nbr_lo: torch.Tensor, wgt_lo: torch.Tensor,
                hub_idx: torch.Tensor, hub_nbr: torch.Tensor,
                hub_wgt: torch.Tensor) -> dict:
    """The two-bin adjacency in the form the sweeps read, for state of
    ``V = nbr_lo.shape[0]`` rows: each bin cut to the lanes some row uses,
    its indices int64 with PAD pointing at row V (the sweeps append one
    identity row to the state, so a PAD lane reads the identity and needs
    no mask) and its PAD weights zero; only the live hub rows, with their
    destination rows. Built once per adjacency by the serving route
    (``kernels.flat.binned_plan_of``), or per call by the functions below.
    The lanes and rows it drops only ever contribute the ⊕-identity, so
    every result is unchanged."""
    V = nbr_lo.shape[0]

    def cut(nbr, wgt):
        ok = nbr != PAD
        used = ok.any(dim=0).nonzero()
        w = int(used.max()) + 1 if used.numel() else 1
        ok, nbr, wgt = ok[:, :w], nbr[:, :w], wgt[:, :w]
        return {"idx": torch.where(ok, nbr, V).long(),
                "wgt": torch.where(ok, wgt, 0.0).unsqueeze(-1)}

    live = (hub_idx != PAD).nonzero().reshape(-1)
    hub = cut(hub_nbr[live], hub_wgt[live]) if live.numel() else None
    if hub is not None:
        hub["dst"] = hub_idx[live].long()
    return {"lo": cut(nbr_lo, wgt_lo), "hub": hub}


_WORDS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def any_last(t: torch.Tensor) -> torch.Tensor:
    """``t.any(-1)`` of a contiguous bool tensor. A row of 2, 4 or a
    multiple of 8 bools is read as integer words (a bool is one byte, 0 or
    1), which on the card is several times faster than the reduction."""
    n = t.shape[-1]
    if t.is_contiguous() and (n in _WORDS or n % 8 == 0):
        words = t.view(_WORDS.get(n, torch.int64)).ne(0)
        return words[..., 0] if words.shape[-1] == 1 else words.any(-1)
    return t.any(-1)


def _bin_sweep(x_ext, f_ext, idx, wgt, semiring: str):
    """Rows ``idx`` (r, w) of one bin over the identity-extended (V + 1, Q)
    state: (r, Q), the identity where ``f_ext`` is given and no lane of the
    row is active."""
    q = x_ext.shape[1]
    g = x_ext.index_select(0, idx.reshape(-1)).reshape(*idx.shape, q)
    if semiring == "min_plus":
        y = g.add_(wgt).amin(1)
    elif semiring == "max_first":
        y = g.amax(1)
    elif semiring == "plus_times":
        y = g.mul_(wgt).sum(1)
    else:
        raise ValueError(f"unknown semiring {semiring}")
    if f_ext is not None:
        act = f_ext.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, q).any(1)
        y.masked_fill_(~act, _IDENT[semiring])
    return y


def binned_sweep(x: torch.Tensor, frontier, plan: dict,
                 semiring: str) -> torch.Tensor:
    """The two-bin multi-vector sweep over a :func:`binned_plan`: x is
    (V, Q), query-trailing; ``frontier`` (V, Q) bool masks it per lane (a
    (row, q) with no active in-neighbour in lane q gives the ⊕-identity;
    idempotent semirings only) or is None. A masked sweep computes only the
    narrow bin's rows with an active in-neighbour in some lane — their
    list costs one host read — and gives every other row the identity, as
    the whole-bin computation would. The hub rows merge by
    ``scatter_reduce_`` amin/amax, order-free and so exact, or for
    plus_times an ``index_add_``, whose sum is atomic on the card."""
    if frontier is not None and semiring not in _MERGE:
        raise ValueError("frontier masking requires an idempotent ⊕ (min/max)")
    ident = _IDENT[semiring]
    q = x.shape[1]
    x_ext = torch.cat([x, x.new_full((1, q), ident)])
    lo, hub = plan["lo"], plan["hub"]
    if frontier is None:
        f_ext = None
        y = _bin_sweep(x_ext, None, lo["idx"], lo["wgt"], semiring)
    else:
        f_ext = torch.cat([frontier, frontier.new_zeros((1, q))])
        rows = any_last(any_last(f_ext)[lo["idx"]]).nonzero().reshape(-1)
        y = x.new_full(x.shape, ident)
        if rows.numel():
            y.index_copy_(0, rows, _bin_sweep(x_ext, f_ext, lo["idx"][rows],
                                              lo["wgt"][rows], semiring))
    if hub is not None:
        yh = _bin_sweep(x_ext, f_ext, hub["idx"], hub["wgt"], semiring)
        if semiring == "plus_times":
            y.index_add_(0, hub["dst"], yh)
        else:
            y.scatter_reduce_(0, hub["dst"][:, None].expand_as(yh), yh,
                              _MERGE[semiring], include_self=True)
    return y


def binned_ell_spmv_multi(x: torch.Tensor, nbr_lo: torch.Tensor,
                          wgt_lo: torch.Tensor, hub_idx: torch.Tensor,
                          hub_nbr: torch.Tensor, hub_wgt: torch.Tensor,
                          semiring: str) -> torch.Tensor:
    """Multi-vector two-bin ELL sweep, the serving path's: x is (V, Q), Q
    problems over one topology with the query axis TRAILING, so every
    neighbour gather pulls a contiguous Q-vector. The narrow bin
    (``nbr_lo``/``wgt_lo``, (V, w_lo)) covers the bulk of the rows; the few
    hub rows (``hub_nbr``/``hub_wgt``, (H, D)) merge into rows ``hub_idx``
    (PAD for none). Plain torch ops on every device, as the JAX package
    computes it in plain XLA (:func:`binned_sweep` over a
    :func:`binned_plan`). Min/max results are exact; plus_times sums in
    another association than the scalar sweep, so it is allclose."""
    return binned_sweep(x, None, binned_plan(nbr_lo, wgt_lo, hub_idx,
                                             hub_nbr, hub_wgt), semiring)


def binned_ell_spmv_multi_frontier(x: torch.Tensor, frontier: torch.Tensor,
                                   nbr_lo: torch.Tensor, wgt_lo: torch.Tensor,
                                   hub_idx: torch.Tensor,
                                   hub_nbr: torch.Tensor,
                                   hub_wgt: torch.Tensor,
                                   semiring: str) -> torch.Tensor:
    """The frontier-masked two-bin multi-vector sweep: ``frontier`` is
    (V, Q) bool, per query lane. A (row, q) with no active in-neighbour in
    lane q gives the ⊕-identity (the caller's combine keeps its old value).
    Idempotent semirings only."""
    return binned_sweep(x, frontier, binned_plan(nbr_lo, wgt_lo, hub_idx,
                                                 hub_nbr, hub_wgt), semiring)


# ---------------- multi-bin ELL (degree-skew mitigation) ----------------

def bin_rows_by_degree(nbr: np.ndarray, wgt: np.ndarray,
                       boundaries: Sequence[int] = (8, 64)) -> list:
    """Host-side: split ELL rows into degree bins [(rows, nbr_b, wgt_b),
    ...]. Each bin's width is its own max degree rounded up to 8 lanes, so
    a powerlaw graph pays mega-hub padding only for its hub rows."""
    deg = (nbr != PAD).sum(1)
    edges = [0, *boundaries, nbr.shape[1] + 1]
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        rows = np.flatnonzero((deg >= lo) & (deg < hi))
        if rows.size == 0:
            continue
        w = max(int(deg[rows].max()), 1)
        w = -(-w // 8) * 8
        bins.append((rows.astype(np.int32),
                     np.ascontiguousarray(nbr[rows, :w]),
                     np.ascontiguousarray(wgt[rows, :w])))
    return bins


def multibin_spmv(x: torch.Tensor, bins: list, v_out: int,
                  semiring: str) -> torch.Tensor:
    """Semiring sweep over degree-binned ELL (``bin_rows_by_degree``): one
    :func:`semiring_spmv` a bin — kernel K1 on the card — each bin's rows
    written back into the (v_out,) result."""
    ident = {"min_plus": float("inf"), "max_first": -float("inf"),
             "plus_times": 0.0}[semiring]
    y = torch.full((v_out,), ident, dtype=x.dtype, device=x.device)
    for rows, nbr_b, wgt_b in bins:
        y[torch.as_tensor(rows, device=x.device).long()] = semiring_spmv(
            x, torch.as_tensor(nbr_b, device=x.device),
            torch.as_tensor(wgt_b, device=x.device), semiring)
    return y


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
