"""The gradients of K7 and K8 in the port, on the CPU.

``flash_attention_bwd_ref`` and ``mamba1_scan_bwd_ref`` (the plain
backwards that the card's kernels K7b and K8b are held to) against
``jax.grad`` of the JAX package's plain forwards (``layers.flash_attention``
with ``use_kernel=False``, ``kernels/mamba_scan.py``'s ``mamba1_scan_ref``)
and against torch autograd of the port's own plain forwards; and
``kernels.ops``'s autograd Functions on CPU tensors against autograd of
the plain forward. Inputs come from numpy seeds; float32 throughout, so
each comparison is allclose at rtol 1e-5 (the sums run in other orders).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.mamba_scan import mamba1_scan_ref as jax_scan  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.mamba_scan import (mamba1_scan_bwd_ref,  # noqa: E402
                                            mamba1_scan_ref)

TOL = dict(rtol=1e-5, atol=1e-6)
# (B, Sq, Sk, H, KV, dh, causal, window, q_offset): causal, a window, GQA
# (g = 3 and 4), a continuation with Sq < Sk, no mask, at dh 16 and 80
ATTN_CASES = [(2, 16, 16, 4, 4, 16, True, None, 0),
              (2, 16, 16, 6, 2, 16, True, 5, 0),
              (1, 8, 24, 8, 2, 80, True, None, 16),
              (1, 8, 24, 4, 1, 80, True, 6, 16),
              (2, 12, 12, 4, 2, 80, False, None, 0)]


def _attn_inputs(case, seed):
    B, Sq, Sk, H, KV, dh = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, dh)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    return q, k, v, do


def _scan_inputs(seed, B=2, L=19, D=6, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    delta = rng.uniform(0.01, 0.5, (B, L, D)).astype(np.float32)
    bv = rng.standard_normal((B, L, N)).astype(np.float32)
    cv = rng.standard_normal((B, L, N)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, (D, N)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    dy = rng.standard_normal((B, L, D)).astype(np.float32)
    dh = rng.standard_normal((B, D, N)).astype(np.float32)
    return x, delta, bv, cv, A, h0, dy, dh


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{what}[{i}]",
                                   **TOL)


def test_flash_attention_bwd_ref_matches_jax_grad():
    for i, case in enumerate(ATTN_CASES):
        causal, window, q_offset = case[6:]
        q, k, v, do = _attn_inputs(case, i)

        def f(q, k, v):
            o = JL.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, use_kernel=False)
            return jnp.sum(o * do)
        want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
        o = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                window=window, q_offset=q_offset)
        got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do),
                                      causal=causal, window=window,
                                      q_offset=q_offset)
        _close(got, want, f"attention case {case}")


def test_mamba1_scan_bwd_ref_matches_jax_grad():
    x, delta, bv, cv, A, _, dy, _ = _scan_inputs(0)
    _, vjp = jax.vjp(jax_scan, x, delta, bv, cv, A)
    want = vjp(dy)
    got = mamba1_scan_bwd_ref(*(_t(a) for a in (x, delta, bv, cv, A)), None,
                              _t(dy))
    assert got[5] is None
    _close(got[:5], want, "scan")


def test_bwd_refs_match_torch_autograd_of_the_plain_forwards():
    for i, case in enumerate(ATTN_CASES):
        causal, window, q_offset = case[6:]
        q, k, v, do = (_t(a, True) for a in _attn_inputs(case, 10 + i))
        o = flash_attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
        want = torch.autograd.grad(o, (q, k, v), do)
        got = flash_attention_bwd_ref(q, k, v, o.detach(), do.detach(),
                                      causal=causal, window=window,
                                      q_offset=q_offset)
        _close(got, [w.numpy() for w in want], f"attention case {case}")
    ins = [_t(a, True) for a in _scan_inputs(1)]
    x, delta, bv, cv, A, h0, dy, dh = ins
    y, h = mamba1_scan_ref(x, delta, bv, cv, A, h0, return_state=True)
    want = torch.autograd.grad((y, h), (x, delta, bv, cv, A, h0), (dy, dh))
    got = mamba1_scan_bwd_ref(x, delta, bv, cv, A, h0, dy.detach(),
                              dh.detach())
    _close(got, [w.numpy() for w in want], "scan with h0 and dh_last")


def test_functions_on_the_cpu_equal_autograd_of_the_plain_forward():
    case = ATTN_CASES[3]
    causal, window, q_offset = case[6:]
    q, k, v, do = (_t(a, True) for a in _attn_inputs(case, 20))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = flash_attention_ref(q, k, v, **kw)
    assert torch.equal(o, o_ref)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    _close(got, [w.numpy() for w in want], "ops.flash_attention")

    x, delta, bv, cv, A, h0, dy, dh = (_t(a, True) for a in _scan_inputs(2))
    ins = (x, delta, bv, cv, A, h0)
    for h_in, state in ((h0, True), (None, True), (None, False)):
        args = (x, delta, bv, cv, A, h_in)
        wrt = ins if h_in is not None else ins[:5]
        out = ops.mamba1_scan(*args, return_state=state)
        ref = mamba1_scan_ref(*args, return_state=state)
        outs, refs = ((out, ref) if state else ((out,), (ref,)))
        grads = (dy, dh) if state else (dy,)
        got = torch.autograd.grad(outs, wrt, grads)
        want = torch.autograd.grad(refs, wrt, grads)
        _close(got, [w.numpy() for w in want],
               f"ops.mamba1_scan h0={h_in is not None} state={state}")
    # one output used: the other's gradient is None, taken as zeros
    for i, g in ((0, dy), (1, dh)):
        out = ops.mamba1_scan(x, delta, bv, cv, A, h0, return_state=True)
        ref = mamba1_scan_ref(x, delta, bv, cv, A, h0, return_state=True)
        got = torch.autograd.grad(out[i], ins, g)
        want = torch.autograd.grad(ref[i], ins, g, allow_unused=True)
        _close(got, [np.zeros(t.shape, np.float32) if w is None else w.numpy()
                     for t, w in zip(ins, want)], f"ops.mamba1_scan, out[{i}]")
