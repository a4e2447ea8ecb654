"""K7's log-sum-exp and K7b's plain version given it, on the CPU.

The tensor-core K7b takes each row's log-sum-exp from K7 instead of
rebuilding the softmax. Here, with the JAX package as the reference:
``flash_attention_ref(..., return_lse=True)`` against ``torch.logsumexp``
of the masked, scaled scores (+inf on a row with no visible key);
``flash_attention_bwd_ref(..., lse=)`` against itself without ``lse`` and
against ``jax.grad`` of the JAX package's plain attention; and
``kernels.ops``'s autograd Function asking for and saving ``lse`` only
when a gradient is wanted. Inputs come from numpy seeds; float32, so the
comparisons are allclose at rtol 1e-5 (sums in other orders).
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _mask, flash_attention_bwd_ref, flash_attention_ref)

TOL = dict(rtol=1e-5, atol=1e-6)
# (B, Sq, Sk, H, KV, dh, causal, window, q_offset): causal, a window, GQA,
# a continuation, no mask, and rows with no visible key (q_offset < 0,
# with and without a window)
CASES = [(2, 16, 16, 4, 4, 16, True, None, 0),
         (2, 16, 16, 6, 2, 16, True, 5, 0),
         (1, 8, 24, 8, 2, 80, True, None, 16),
         (2, 12, 12, 4, 2, 80, False, None, 0),
         (1, 10, 10, 4, 2, 16, True, None, -4),
         (1, 9, 30, 2, 1, 32, True, 3, -6)]


def _inputs(case, seed):
    B, Sq, Sk, H, KV, dh = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dh)).astype(np.float32),
            rng.standard_normal((B, Sq, H, dh)).astype(np.float32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_plain_lse_is_the_logsumexp_of_the_masked_scores():
    for case in CASES:
        B, Sq, Sk, H, KV, dh, causal, window, q_offset = case
        q, k, v, _ = (_t(a) for a in _inputs(case, 1))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
        assert torch.equal(out, flash_attention_ref(q, k, v, **kw))
        assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
        g = H // KV
        kk = k.repeat_interleave(g, dim=2)           # head h reads KV h // g
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
        mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
        want = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
        empty = ~mask.any(dim=-1)                    # (Sq,) rows with no key
        assert torch.isinf(want[..., empty]).all()
        assert (lse[..., empty] == math.inf).all()
        np.testing.assert_allclose(lse[..., ~empty].numpy(),
                                   want[..., ~empty].numpy(),
                                   err_msg=str(case), **TOL)
        assert empty.any() == (q_offset < 0)


def test_bwd_ref_given_lse_matches_it_without_and_jax_grad():
    for i, case in enumerate(CASES):
        causal, window, q_offset = case[6:]
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        q, k, v, do = _inputs(case, 10 + i)

        def f(q, k, v):
            o = JL.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, use_kernel=False)
            return jnp.sum(o * do)
        want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
        o, lse = flash_attention_ref(_t(q), _t(k), _t(v), return_lse=True,
                                     **kw)
        got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), lse,
                                      **kw)
        plain = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), **kw)
        for j, (a, b, c) in enumerate(zip(got, plain, want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       err_msg=f"{case}[{j}]", **TOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       err_msg=f"{case}[{j}]", **TOL)
        if q_offset < 0:                 # rows with no visible key: dq 0
            assert not got[0][:, :-q_offset].any()


def test_function_asks_for_lse_only_when_a_gradient_is_wanted(monkeypatch):
    asked = []

    def recording_ref(*args, **kw):
        asked.append(kw.get("return_lse", False))
        return flash_attention_ref(*args, **kw)
    monkeypatch.setattr(ops, "flash_attention_ref", recording_ref)
    case = CASES[4]
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = (_t(a, True) for a in _inputs(case, 20))

    o = ops.flash_attention(q, k, v, **kw)           # training: lse saved
    saved = o.grad_fn.saved_tensors
    _, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert asked == [True] and len(saved) == 5
    assert torch.equal(saved[3], o) and torch.equal(saved[4], lse)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = flash_attention_bwd_ref(q, k, v, o.detach(), do.detach(), lse,
                                   **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), **TOL)

    with torch.no_grad():                            # serving: no lse
        ops.flash_attention(q, k, v, **kw)
    ops.flash_attention(q.detach(), k.detach(), v.detach(), **kw)
    assert asked == [True, False, False]
