"""Kernel K8 — the Mamba1 (S6) selective scan, on the card.

``mamba1_scan_cuda`` launches the kernel in ``csrc/mamba_scan.cu``, the
port of the JAX package's Pallas ``mamba1_scan_pallas``;
``mamba1_scan_ref`` is its plain version, the step-by-step recurrence of
the JAX package's ``mamba1_scan_ref``. ``kernels.ops.mamba1_scan`` picks
between them by the tensors' device. The ssm family's mixer
(``models.layers.mamba1_mixer``) runs it once a layer in every prefill
and forward.

Beyond the Pallas kernel's contract (h starts at 0, only y is written),
both take an initial state ``h0`` and can return the state after the last
step (``return_state``) and a float32 ``y`` (``y_dtype``): the serving
path's prefill keeps each layer's final state, and its mixer adds
``xc·D`` to the float32 scan output. The defaults keep the Pallas
kernel's contract.

``scan_step`` is one step of the recurrence in float32: the plain scan
loops over it, and the mixer's decode step (plain ops, no K8) is one call
of it. On the card K8's bits equal the plain version's: it rounds every
product and sum on its own, as these plain ops do, and sums over the
states as the pairwise tree that torch's ``sum(-1)`` over 16 takes there
(``csrc/mamba_scan.cu`` names where bits are easily lost). So a decode
step continues a prefill's state bit for bit. On the CPU torch sums in
another order, which the tests hold at float32's tolerance.

The backward, K8b, has no TPU counterpart (the Pallas kernel is
forward-only): ``mamba1_scan_bwd_cuda`` launches
``csrc/mamba_scan_bwd.cu``, a reverse sweep over L from states that a
forward pass in the same launch stores every chunk, and
``mamba1_scan_bwd_ref`` is its plain version, the reverse recurrence
written out in torch ops. ``kernels.ops.mamba1_scan`` is a
``torch.autograd.Function`` whose backward picks between them by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_STATE = 16        # the largest N the kernel is built for


def _check_shapes(x, delta, Bv, Cv, A, h0):
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
    if h0 is not None and tuple(h0.shape) != (B, D, N):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected "
                         f"{(B, D, N)}")
    return B, L, D, N


def _y_dtype(x: torch.Tensor, y_dtype) -> torch.dtype:
    y_dtype = x.dtype if y_dtype is None else y_dtype
    if y_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"y is x's dtype ({x.dtype}) or float32, not "
                        f"{y_dtype}")
    return y_dtype


def scan_step(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, a: torch.Tensor):
    """One step of the recurrence, all float32: h (B, D, N) -> (exp(dt⊗a)·h
    + (dt·x)⊗b, y = Σ_n h·c). dt, x: (B, D); b, c: (B, N); a: (D, N).
    Returns (h, y (B, D))."""
    da = torch.exp(dt[:, :, None] * a)                        # (B, D, N)
    h = da * h + (dt * x)[:, :, None] * b[:, None, :]
    return h, (h * c[:, None, :]).sum(-1)


def mamba1_scan_ref(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                    Cv: torch.Tensor, A: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, *,
                    return_state: bool = False,
                    y_dtype: Optional[torch.dtype] = None):
    """y[b,l,d] = Σ_n h[b,l,d,n]·C[b,l,n] with
    h[b,l] = exp(δ[b,l]⊗A)·h[b,l-1] + (δ[b,l]·x[b,l])⊗B[b,l], h[b,-1] = h0
    (zeros when None).

    x, delta: (B, L, D); Bv, Cv: (B, L, N); A: (D, N) (negative decays);
    h0: (B, D, N) float32. The state is float32; y has x's dtype, or
    ``y_dtype`` (float32). Returns y, or (y, h after the last step (B, D,
    N) float32) with ``return_state``."""
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A, h0)
    y_dtype = _y_dtype(x, y_dtype)
    xf, df, bf, cf = (t.float() for t in (x, delta, Bv, Cv))
    af = A.float()
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32, copy=True))
    ys = []
    for l in range(L):
        h, y = scan_step(h, df[:, l], xf[:, l], bf[:, l], cf[:, l], af)
        ys.append(y)
    y = (torch.stack(ys, dim=1).to(y_dtype) if ys
         else torch.empty((B, 0, D), dtype=y_dtype, device=x.device))
    if return_state:
        return y, h
    return y


def mamba1_scan_bwd_ref(x: torch.Tensor, delta: torch.Tensor,
                        Bv: torch.Tensor, Cv: torch.Tensor, A: torch.Tensor,
                        h0: Optional[torch.Tensor], dy: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None):
    """The gradients of :func:`mamba1_scan_ref` for the gradients ``dy``
    of y (B, L, D) and ``dh_last`` of the final state (B, D, N; zeros when
    None): (dx, dδ, dB, dC, dA, dh0), dx/dδ/dB/dC in their inputs' dtypes,
    dA and dh0 float32 (dh0 None when ``h0`` is). The states are recomputed
    and kept; the reverse sweep carries the state's gradient g:

        g += dy_l·C_l;  dC_l = Σ_d dy_l·h_l;  dB_l = Σ_d g·δ_l·x_l
        e = Σ_n g·B_l;  dx_l = e·δ_l
        u = g·exp(δ_l·A)·h_{l-1};  dδ_l = Σ_n u·A + e·x_l;  dA += Σ_b u·δ_l
        g = g·exp(δ_l·A)
    """
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A, h0)
    xf, df, bf, cf = (t.float() for t in (x, delta, Bv, Cv))
    af = A.float()
    dyf = dy.float()
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32, copy=True))
    hs = [h]                                   # hs[l + 1] = h_l
    for l in range(L):
        h, _ = scan_step(h, df[:, l], xf[:, l], bf[:, l], cf[:, l], af)
        hs.append(h)
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.to(torch.float32, copy=True))
    dx = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    dd, dB, dC = torch.empty_like(dx), bf.new_empty((B, L, N)), \
        cf.new_empty((B, L, N))
    dA = torch.zeros_like(af)
    for l in reversed(range(L)):
        dl, xl, dyl = df[:, l], xf[:, l], dyf[:, l]
        g = g + dyl[:, :, None] * cf[:, l, None, :]
        dC[:, l] = (dyl[:, :, None] * hs[l + 1]).sum(1)
        dB[:, l] = (g * (dl * xl)[:, :, None]).sum(1)
        e = (g * bf[:, l, None, :]).sum(-1)
        gd = g * torch.exp(dl[:, :, None] * af)
        u = gd * hs[l]
        dd[:, l] = (u * af).sum(-1) + e * xl
        dx[:, l] = e * dl
        dA += (u * dl[:, :, None]).sum(0)
        g = gd
    return (dx.to(x.dtype), dd.to(delta.dtype), dB.to(Bv.dtype),
            dC.to(Cv.dtype), dA, None if h0 is None else g)


def k8_layout() -> dict:
    """The layout K8 was built with (``csrc/mamba_scan.cu``): lanes a
    channel, channels a block, steps a chunk, raw chunks in the ring, steps
    unrolled, and ``fused``: 1 if h's update is one fmaf."""
    out = (ctypes.c_int * 6)()
    _build.library().mamba1_scan_layout(out)
    return dict(zip(("lanes", "channels", "steps", "stages", "unroll",
                     "fused"), out))


def mamba1_scan_cuda(x: torch.Tensor, delta: torch.Tensor, Bv: torch.Tensor,
                     Cv: torch.Tensor, A: torch.Tensor,
                     h0: Optional[torch.Tensor] = None, *,
                     return_state: bool = False,
                     y_dtype: Optional[torch.dtype] = None):
    """The same function by kernel K8, for contiguous CUDA tensors: x,
    delta, Bv and Cv of one dtype (float32 or bfloat16), A and h0 float32,
    N <= ``MAX_STATE``; y in x's dtype or float32."""
    if not x.is_cuda:
        raise ValueError(f"kernel K8 needs CUDA tensors, got {x.device}")
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A, h0)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel K8 takes float32 or bfloat16, got {x.dtype}")
    y_dtype = _y_dtype(x, y_dtype)
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"kernel K8 is built for a state of at most "
                         f"{MAX_STATE} entries, got N = {N}")
    dev = x.device
    _build.need(x, "x", x.dtype, dev, (B, L, D))
    _build.need(delta, "delta", x.dtype, dev, (B, L, D))
    _build.need(Bv, "Bv", x.dtype, dev, (B, L, N))
    _build.need(Cv, "Cv", x.dtype, dev, (B, L, N))
    _build.need(A, "A", torch.float32, dev, (D, N))
    if h0 is not None:
        _build.need(h0, "h0", torch.float32, dev, (B, D, N))
    y = torch.empty((B, L, D), dtype=y_dtype, device=dev)
    h_last = (torch.empty((B, D, N), dtype=torch.float32, device=dev)
              if return_state else None)
    if L == 0 or B * D == 0:
        if h_last is not None:
            h_last.zero_()
            if h0 is not None:
                h_last.copy_(h0)
        return (y, h_last) if return_state else y
    lib = _build.library()
    err = lib.mamba1_scan_launch(
        x.data_ptr(), delta.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_last is None else h_last.data_ptr(), B, L, D, N,
        1 if x.dtype == torch.bfloat16 else 0,
        1 if y_dtype == torch.float32 else 0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mamba1_scan")
    _build.launches["mamba1_scan"] += 1
    return (y, h_last) if return_state else y


def mamba1_scan_bwd_cuda(x: torch.Tensor, delta: torch.Tensor,
                         Bv: torch.Tensor, Cv: torch.Tensor, A: torch.Tensor,
                         h0: Optional[torch.Tensor], dy: torch.Tensor,
                         dh_last: Optional[torch.Tensor] = None):
    """:func:`mamba1_scan_bwd_ref` by kernel K8b, for contiguous CUDA
    tensors: x, delta, Bv and Cv of one dtype (float32 or bfloat16), A,
    h0 and dh_last float32, dy in x's dtype or float32, N <=
    ``MAX_STATE``. dB, dC and dA are float32 sums by atomics (allclose,
    not bit-equal, to the plain version); dB and dC come back in Bv's
    dtype."""
    if not x.is_cuda:
        raise ValueError(f"kernel K8b needs CUDA tensors, got {x.device}")
    B, L, D, N = _check_shapes(x, delta, Bv, Cv, A, h0)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel K8b takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"kernel K8b is built for a state of at most "
                         f"{MAX_STATE} entries, got N = {N}")
    dev = x.device
    _build.need(x, "x", x.dtype, dev, (B, L, D))
    _build.need(delta, "delta", x.dtype, dev, (B, L, D))
    _build.need(Bv, "Bv", x.dtype, dev, (B, L, N))
    _build.need(Cv, "Cv", x.dtype, dev, (B, L, N))
    _build.need(A, "A", torch.float32, dev, (D, N))
    _build.need(dy, "dy", _y_dtype(x, dy.dtype), dev, (B, L, D))
    if h0 is not None:
        _build.need(h0, "h0", torch.float32, dev, (B, D, N))
    if dh_last is not None:
        _build.need(dh_last, "dh_last", torch.float32, dev, (B, D, N))
    dx, dd = torch.empty_like(x), torch.empty_like(delta)
    dB = torch.zeros((B, L, N), dtype=torch.float32, device=dev)
    dC = torch.zeros((B, L, N), dtype=torch.float32, device=dev)
    dA = torch.zeros((D, N), dtype=torch.float32, device=dev)
    dh0 = (None if h0 is None
           else torch.empty((B, D, N), dtype=torch.float32, device=dev))
    if L == 0 or B * D == 0:
        if dh0 is not None:
            dh0.zero_()
            if dh_last is not None:
                dh0.copy_(dh_last)
        return dx, dd, dB.to(Bv.dtype), dC.to(Cv.dtype), dA, dh0
    lib = _build.library()
    steps = lib.mamba1_scan_bwd_steps()
    scratch = torch.empty((B, -(-L // steps), MAX_STATE, D),
                          dtype=torch.float32, device=dev)
    err = lib.mamba1_scan_bwd_launch(
        x.data_ptr(), delta.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        dd.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), scratch.data_ptr(), B, L,
        D, N, 1 if x.dtype == torch.bfloat16 else 0,
        1 if dy.dtype == torch.float32 else 0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mamba1_scan_bwd")
    _build.launches["mamba1_scan_bwd"] += 1
    return dx, dd, dB.to(Bv.dtype), dC.to(Cv.dtype), dA, dh0
