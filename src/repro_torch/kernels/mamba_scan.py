"""Kernel K8 — the Mamba1 (S6) selective scan, on the card.

``mamba1_scan_cuda`` launches the kernel in ``csrc/mamba_scan.cu``, the
port of the JAX package's Pallas ``mamba1_scan_pallas``;
``mamba1_scan_ref`` is its plain version, the step-by-step recurrence of
the JAX package's ``mamba1_scan_ref``. ``kernels.ops.mamba1_scan`` picks
between them by the tensors' device. No model path of the port calls it
yet: the Mamba mixers come with the ssm and hybrid families.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STATE = 16        # the largest N the kernel is built for


def _check_shapes(x, delta, Bv, Cv, A):
    if x.dim() != 3 or Bv.dim() != 3 or A.dim() != 2:
        raise ValueError("x, delta must be (B, L, D), Bv, Cv (B, L, N) and "
                         "A (D, N)")
    B, L, D = x.shape
    N = A.shape[1]
    if tuple(delta.shape) != (B, L, D) or tuple(Bv.shape) != (B, L, N) \
            or tuple(Cv.shape) != (B, L, N) or A.shape[0] != D:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, delta "
                         f"{tuple(delta.shape)}, Bv {tuple(Bv.shape)}, Cv "
                         f"{tuple(Cv.shape)}, A {tuple(A.shape)}")
    return B, L, D, N


def mamba1_scan_ref(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                    Cv: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """y[b,l,d] = Σ_n h[b,l,d,n]·C[b,l,n] with
    h[b,l] = exp(δ[b,l]⊗A)·h[b,l-1] + (δ[b,l]·x[b,l])⊗B[b,l], h[b,-1] = 0.

    x, delta: (B, L, D); Bv, Cv: (B, L, N); A: (D, N) (negative decays).
    The state is float32; y has x's dtype."""
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A)
    xf, df, bf, cf = (t.float() for t in (x, delta, Bv, Cv))
    af = A.float()
    h = torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
    ys = []
    for l in range(L):
        dt = df[:, l]
        da = torch.exp(dt[:, :, None] * af)                   # (B, D, N)
        h = da * h + (dt * xf[:, l])[:, :, None] * bf[:, l, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, l]))
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)


def mamba1_scan_cuda(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                     Cv: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The same function by kernel K8, for contiguous CUDA tensors: x,
    delta, Bv and Cv of one dtype (float32 or bfloat16), A float32,
    N <= ``MAX_STATE``."""
    if not x.is_cuda:
        raise ValueError(f"kernel K8 needs CUDA tensors, got {x.device}")
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel K8 takes float32 or bfloat16, got {x.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"kernel K8 is built for a state of at most "
                         f"{MAX_STATE} entries, got N = {N}")
    dev = x.device
    _build.need(x, "x", x.dtype, dev, (B, L, D))
    _build.need(delta, "delta", x.dtype, dev, (B, L, D))
    _build.need(Bv, "Bv", x.dtype, dev, (B, L, N))
    _build.need(Cv, "Cv", x.dtype, dev, (B, L, N))
    _build.need(A, "A", torch.float32, dev, (D, N))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.library()
    err = lib.mamba1_scan_launch(
        x.data_ptr(), delta.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        A.data_ptr(), y.data_ptr(), B, L, D, N,
        1 if x.dtype == torch.bfloat16 else 0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mamba1_scan")
    _build.launches["mamba1_scan"] += 1
    return y
