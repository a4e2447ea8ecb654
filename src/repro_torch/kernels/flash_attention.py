"""Kernel K7 — forward attention with an online softmax, on the card.

``flash_attention_cuda`` is the port of the JAX package's Pallas
``flash_attention_pallas``: causal or sliding-window attention with grouped
query heads (GQA), queries at the absolute positions ``q_offset + i``. It
has two instantiations, picked by dtype and head width:

* bf16 at dh in ``SM90_HEAD_DIMS`` (64, 80, 128, 256) — every full-width
  config — runs ``flash_kernel_sm90`` (``csrc/flash_attention_sm90.cu``):
  TMA loads, wgmma on bf16 tiles, warp-specialised. q·k accumulates in
  float32; the 1/sqrt(dh) scale is applied to the float32 scores; the row
  sum adds the float32 p; P·V takes p rounded to bf16 and accumulates in
  float32; the output is rounded to bf16 once.
* float32 at any dh of ``HEAD_DIMS``, and bf16 at dh 16 and 32 (the
  reduced configs), run the SIMT ``flash_kernel`` (``csrc/flash_attention.cu``):
  every product and sum in float32 on the CUDA cores.

``flash_attention_ref`` is the plain version and the float32 oracle of
both, with the TPU kernel's numerics: every product and sum in float32
(including p·V), the output cast to q's dtype, a fully masked row 0.
``kernels.ops.flash_attention`` picks between kernel and plain version by
the tensors' device.

The backward, K7b, has no TPU counterpart (the JAX package differentiates
its jnp loop): ``flash_attention_bwd_cuda`` launches
``csrc/flash_attention_bwd.cu`` and ``flash_attention_bwd_ref`` is its
plain version, written out as the formulas (P, dP, dS = P∘(dP −
rowsum(dO∘O))), not as autograd. ``kernels.ops.flash_attention`` is a
``torch.autograd.Function`` whose backward picks between them by device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

# the head widths K7 is built for: every attention config of
# ``repro_torch.configs`` at full width (64, 80, 128, 256) and reduced (16)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
SM90_HEAD_DIMS = (64, 80, 128, 256)  # bf16 on the tensor-core kernel
MAX_GROUP = 64                       # query heads per KV head it takes


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, Sq, H, dh) and k, v (B, Sk, KV, dh)")
    B, _, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i (absolute position
    q_offset + i)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh), H a multiple of KV.
    Returns (B, Sq, H, dh) in q's dtype. Keys with ``kpos > qpos`` (causal)
    or ``qpos - kpos >= window`` are masked; a row with no visible key is
    0 (the kernel's ``acc / max(l, 1e-30)``)."""
    _check_shapes(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, Sq, KV, g, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())   # (B, KV, g, Sq, Sk)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / l.clamp(min=1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            q_offset: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at
    (q, k, v) for the output gradient ``do``, given its output ``o``; each
    in its input's dtype, computed in float32. With s = (q/sqrt(dh))·k,
    P = softmax(s) over the visible keys (0 on a row with none) and
    D = rowsum(do∘o): dS = P∘(do·vᵀ − D), dq = dS·k/sqrt(dh),
    dk = Σ_g dSᵀ·q/sqrt(dh), dv = Σ_g Pᵀ·do (the g query heads of a KV
    head summed)."""
    _check_shapes(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, Sq, KV, g, dh) * scale
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KV, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)          # (B, KV, g, Sq, Sk)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    rows = (dof * o.float().reshape(B, Sq, KV, g, dh)).sum(-1)
    ds = p * (dp - rows.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_args(q, k, v, window, what: str):
    """The checks both of K7's launches make; returns (B, Sq, Sk, H, KV,
    dh)."""
    if not q.is_cuda:
        raise ValueError(f"kernel {what} needs CUDA tensors, got {q.device}")
    _check_shapes(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel {what} takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel {what} is built for head widths "
                         f"{HEAD_DIMS}, got {dh}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"kernel {what} takes at most {MAX_GROUP} query "
                         f"heads per KV head, got {H // KV}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if Sk == 0:
        raise ValueError(f"kernel {what} needs at least one key")
    return B, Sq, Sk, H, KV, dh


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """The same function by kernel K7, for contiguous float32 or bfloat16
    CUDA tensors of one dtype with dh in ``HEAD_DIMS`` and at least one
    key: bf16 at dh in ``SM90_HEAD_DIMS`` launches the tensor-core kernel,
    everything else the SIMT one (module docstring)."""
    B, Sq, Sk, H, KV, dh = _check_kernel_args(q, k, v, window, "K7")
    dev = q.device
    _build.need(q, "q", q.dtype, dev, (B, Sq, H, dh))
    _build.need(k, "k", q.dtype, dev, (B, Sk, KV, dh))
    _build.need(v, "v", q.dtype, dev, (B, Sk, KV, dh))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, dh, int(bool(causal)),
            0 if window is None else int(window), int(q_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q.dtype == torch.bfloat16 and dh in SM90_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16:     # TMA reads from 16-byte aligned bases
                raise ValueError(f"kernel K7 needs {name} 16-byte aligned")
        err = lib.flash_attention_sm90_launch(*args, 1.0 / math.sqrt(dh),
                                              dev.index, stream)
    else:
        err = lib.flash_attention_launch(
            *args, 1 if q.dtype == torch.bfloat16 else 0,
            1.0 / math.sqrt(dh), dev.index, stream)
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0):
    """:func:`flash_attention_bwd_ref` by kernel K7b, for contiguous
    float32 or bfloat16 CUDA tensors of one dtype with dh in
    ``HEAD_DIMS``: one cooperative launch (``csrc/flash_attention_bwd.cu``)
    that recomputes the row statistics K7 does not keep. Returns (dq, dk,
    dv) in the inputs' dtype."""
    B, Sq, Sk, H, KV, dh = _check_kernel_args(q, k, v, window, "K7b")
    dev = q.device
    _build.need(q, "q", q.dtype, dev, (B, Sq, H, dh))
    _build.need(k, "k", q.dtype, dev, (B, Sk, KV, dh))
    _build.need(v, "v", q.dtype, dev, (B, Sk, KV, dh))
    _build.need(o, "o", q.dtype, dev, (B, Sq, H, dh))
    _build.need(do, "do", q.dtype, dev, (B, Sq, H, dh))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    stats = torch.empty((B, Sq, H, 3), dtype=torch.float32, device=dev)
    err = _build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), B, Sq, Sk, H, KV, dh, int(bool(causal)),
        0 if window is None else int(window), int(q_offset),
        1 if q.dtype == torch.bfloat16 else 0, 1.0 / math.sqrt(dh),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    _build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv
