"""The plain versions of kernels K7 (flash attention) and K8 (Mamba1 scan)
against the JAX package's Pallas kernels in interpret mode and its jnp
paths, on the CPU. The same numpy inputs go through both; tolerances are
those of the JAX package's own kernel tests (K7 rtol 1e-4, atol 1e-5; K8
rtol 1e-5). The CUDA kernels themselves are held to these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba_scan import mamba1_scan_pallas  # noqa: E402
from repro.kernels.mamba_scan import mamba1_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import (mamba1_scan_cuda,  # noqa: E402
                                            mamba1_scan_ref)
from repro_torch.models import layers as L  # noqa: E402

K7_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(seed, B, Sq, Sk, H, KV, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dh)).astype(np.float32))


# (B, Sq, Sk, H, KV, dh, causal, window, q_offset)
K7_CASES = {
    "causal_mha": (2, 32, 32, 4, 4, 16, True, None, 0),
    "causal_gqa2": (2, 32, 32, 4, 2, 16, True, None, 0),
    "causal_gqa4": (1, 40, 40, 8, 2, 8, True, None, 0),
    "window_gqa4": (2, 32, 32, 8, 2, 16, True, 8, 0),
    "window_mha": (1, 48, 48, 2, 2, 16, True, 5, 0),
    "offset_short_q": (2, 7, 29, 4, 2, 16, True, None, 22),
    "offset_window": (1, 13, 45, 4, 1, 8, True, 9, 32),
    "ragged_sq": (1, 37, 37, 4, 2, 16, True, None, 0),
    "not_causal": (2, 19, 23, 4, 4, 8, False, None, 0),
    "rows_fully_masked": (1, 12, 12, 2, 1, 8, True, None, -4),
    "head_width_80": (1, 20, 20, 8, 2, 80, True, 8, 0),   # h2o-danube's dh
}


@pytest.mark.parametrize("case", K7_CASES, ids=list(K7_CASES))
def test_k7_plain_matches_pallas_and_layer(case):
    B, Sq, Sk, H, KV, dh, causal, window, q_offset = K7_CASES[case]
    q, k, v = _qkv(len(case), B, Sq, Sk, H, KV, dh)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, q_offset=q_offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, q_offset=q_offset,
                                    q_block=8, kv_block=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **K7_TOL)
    layer = JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               q_offset=q_offset, q_block=16, kv_block=16,
                               use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(layer), **K7_TOL)
    if q_offset < 0:              # rows with no visible key are 0
        assert not got[:, :-q_offset].any()


def test_k7_dispatch_and_dtype():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 9, 9, 4, 2, 16))
    want = flash_attention_ref(q, k, v, window=4)
    assert torch.equal(ops.flash_attention(q, k, v, window=4), want)
    assert torch.equal(L.flash_attention(q, k, v, window=4), want)
    out = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               flash_attention_ref(q, k, v).numpy(),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiple"):
        k3 = k[:, :, :1].expand(1, 9, 3, 16)
        flash_attention_ref(q, k3, k3)


@pytest.mark.parametrize("B,L_,D,N", [(2, 16, 8, 4), (1, 24, 16, 8),
                                      (2, 10, 12, 4), (1, 70, 20, 16),
                                      (2, 9, 8, 1), (1, 12, 10, 5),
                                      (2, 1, 8, 16)])
def test_k8_plain_matches_pallas_and_oracle(B, L_, D, N):
    rng = np.random.default_rng(B * 100 + L_)
    x = rng.standard_normal((B, L_, D)).astype(np.float32) * 0.5
    dt = rng.uniform(0.01, 0.5, (B, L_, D)).astype(np.float32)
    Bv = rng.standard_normal((B, L_, N)).astype(np.float32)
    Cv = rng.standard_normal((B, L_, N)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (D, N)).astype(np.float32)
    got = mamba1_scan_ref(*(torch.from_numpy(a) for a in (x, dt, Bv, Cv, A)))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    args = [jnp.asarray(a) for a in (x, dt, Bv, Cv, A)]
    pallas = mamba1_scan_pallas(*args, block_d=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    oracle = jax_scan_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


def test_k8_dispatch_and_limits():
    rng = np.random.default_rng(7)
    x, dt = (torch.from_numpy(rng.uniform(0.1, 0.4, (1, 6, 4))
                              .astype(np.float32)) for _ in range(2))
    Bv, Cv = (torch.from_numpy(rng.standard_normal((1, 6, 3))
                               .astype(np.float32)) for _ in range(2))
    A = -torch.ones((4, 3))
    want = mamba1_scan_ref(x, dt, Bv, Cv, A)
    assert torch.equal(ops.mamba1_scan(x, dt, Bv, Cv, A), want)
    assert mamba1_scan_ref(x.bfloat16(), dt.bfloat16(), Bv.bfloat16(),
                           Cv.bfloat16(), A).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba1_scan_cuda(x, dt, Bv, Cv, A)
    with pytest.raises(ValueError, match="shapes do not match"):
        mamba1_scan_ref(x, dt, Bv, Cv, A[:3])
