"""The port's ssm serving path (falcon-mamba, Mamba1) against the JAX
package, on the CPU.

The reduced falcon-mamba-7b config (2 layers, d_model 64, d_inner 128,
N 8, vocab 256, float32): the JAX package's ``ssm.init_params(PRNGKey(0))``
carried into the port by ``params_from_numpy``, the same tokens from a
numpy seed through both. The JAX mixer scans with its chunked associative
scan, the port's with K8's plain version (one call a layer, from the
given state); both are the same recurrence in float32, so logits, caches
and mixer outputs are held to allclose at rtol = atol = 1e-5 and greedy
tokens to equality.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.mamba_scan import mamba1_scan_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba1_scan_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import train_step as ST  # noqa: E402

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port model) of reduced
    falcon-mamba-7b."""
    jcfg = jax_config(ARCH).reduced()
    pcfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert (pcfg.n_layers, pcfg.d_model, pcfg.ssm.d_state, pcfg.vocab,
            pcfg.dtype) == (2, 64, 8, 256, "float32")
    jparams = JS.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, pcfg, params_from_numpy(tree, pcfg, device=CPU)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches(pair):
    jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (2, 12), 0)
    want, _ = JS.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = M.forward(model, _t(toks), pcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)
    np.testing.assert_allclose(model(_t(toks))[0].numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_prefill_logits_and_cache_match(pair):
    """Logits, each layer's conv window and final scan state, and len; a
    2-token prompt leaves part of the conv window at its zero start."""
    jcfg, jparams, pcfg, model = pair
    for shape, seed in (((2, 12), 1), ((3, 2), 4)):
        toks = _tokens(pcfg, shape, seed)
        wl, wc, _ = JS.prefill(jparams, jnp.asarray(toks), jcfg, max_seq=16)
        gl, gc, aux = M.prefill(model, _t(toks), pcfg, max_seq=16)
        _close(gl, wl)
        assert float(aux) == 0.0
        assert gc["len"] == int(wc["len"]) == shape[1]
        for key in ("conv", "ssm"):
            assert tuple(gc[key].shape) == tuple(wc[key].shape)
            assert gc[key].dtype == torch.float32
            _close(gc[key], wc[key])


def test_decode_steps_match(pair):
    """An 8-token prefill, then 4 greedy decode steps: logits, both cache
    tensors and len after each."""
    jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (2, 8), 2)
    wl, wc, _ = JS.prefill(jparams, jnp.asarray(toks), jcfg)
    gl, gc, _ = M.prefill(model, _t(toks), pcfg)
    wt = jnp.argmax(wl[:, -1], axis=-1).astype(jnp.int32)
    gt = torch.argmax(gl[:, -1], dim=-1).to(torch.int32)
    for step in range(4):
        assert np.array_equal(gt.numpy(), np.asarray(wt)), step
        wl, wc = JS.decode_step(jparams, wt, wc, jcfg)
        gl, gc = M.decode_step(model, gt, gc, pcfg)
        _close(gl, wl)
        assert gc["len"] == int(wc["len"]) == 9 + step
        for key in ("conv", "ssm"):
            _close(gc[key], wc[key])
        wt = jnp.argmax(wl, axis=-1).astype(jnp.int32)
        gt = torch.argmax(gl, dim=-1).to(torch.int32)


def test_serve_steps_give_the_same_tokens(pair):
    """``make_prefill_step`` then ``make_decode_step``, greedy, in both
    packages, through the dispatcher."""
    jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (3, 6), 3)
    jpre, jdec = JT.make_prefill_step(jcfg, max_seq=10), \
        JT.make_decode_step(jcfg)
    ppre, pdec = ST.make_prefill_step(pcfg, max_seq=10), \
        ST.make_decode_step(pcfg)
    wt, wc = jpre(jparams, {"inputs": jnp.asarray(toks)})
    gt, gc = ppre(model, {"inputs": _t(toks)})
    assert gt.dtype == torch.int32
    for _ in range(4):
        assert np.array_equal(gt.numpy(), np.asarray(wt))
        wt, wc = jdec(jparams, wt, wc)
        gt, gc = pdec(model, gt, gc)
    assert np.array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("L_", [1, 5, 16])
def test_mixer_from_a_state_matches(pair, L_):
    """``mamba1_mixer`` continuing from a given conv window and scan state
    (L > 1: K8's plain version from h0; L == 1: the decode step), and from
    none."""
    jcfg, jparams, pcfg, model = pair
    rng = np.random.default_rng(L_)
    di = pcfg.ssm.expand * pcfg.d_model
    x = rng.standard_normal((2, L_, pcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, pcfg.ssm.d_conv - 1, di)) \
        .astype(np.float32)
    h = (rng.standard_normal((2, di, pcfg.ssm.d_state)) * 0.5) \
        .astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"][0]["mixer"])
    p = model.blocks[1].mixer
    for state in (None, (conv, h)):
        jst = None if state is None else {"conv": jnp.asarray(conv),
                                          "ssm": jnp.asarray(h)}
        pst = None if state is None else {"conv": _t(conv), "ssm": _t(h)}
        wy, wst = JL.mamba1_mixer(jnp.asarray(x), jp, jcfg, state=jst)
        with torch.no_grad():
            gy, gst = L.mamba1_mixer(_t(x), p, pcfg, state=pst)
        _close(gy, wy)
        _close(gst["conv"], wst["conv"])
        _close(gst["ssm"], wst["ssm"])


def _scan_inputs(seed, B, L_, D, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L_, D)).astype(np.float32) * 0.5,
            rng.uniform(0.01, 0.5, (B, L_, D)).astype(np.float32),
            rng.standard_normal((B, L_, N)).astype(np.float32),
            rng.standard_normal((B, L_, N)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (D, N)).astype(np.float32),
            rng.standard_normal((B, D, N)).astype(np.float32))


@pytest.mark.parametrize("B,L_,D,N", [(2, 9, 6, 4), (1, 20, 12, 8),
                                      (3, 1, 5, 16), (2, 0, 4, 3)])
def test_k8_plain_with_state_matches_recurrence(B, L_, D, N):
    """``h0``, ``return_state`` and a float32 y from bf16 inputs against a
    float64 numpy recurrence; a bf16 y is the float32 y rounded once."""
    x, dt, Bv, Cv, A, h0 = _scan_inputs(L_ + 10 * N, B, L_, D, N)
    h = h0.astype(np.float64)
    want = np.zeros((B, L_, D))
    for l in range(L_):
        h = np.exp(dt[:, l, :, None] * A.astype(np.float64)) * h \
            + (dt[:, l] * x[:, l])[:, :, None] * Bv[:, l, None, :]
        want[:, l] = np.einsum("bdn,bn->bd", h, Cv[:, l])
    y, h_last = mamba1_scan_ref(*map(_t, (x, dt, Bv, Cv, A, h0)),
                                return_state=True)
    assert y.dtype == h_last.dtype == torch.float32
    assert tuple(h_last.shape) == (B, D, N)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(h_last.numpy(), h, **TOL)
    args = [_t(a).bfloat16() for a in (x, dt, Bv, Cv)]
    yf, hf = ops.mamba1_scan(*args, _t(A), _t(h0), return_state=True,
                             y_dtype=torch.float32)
    yb = ops.mamba1_scan(*args, _t(A), _t(h0))
    assert yf.dtype == torch.float32 and yb.dtype == torch.bfloat16
    assert torch.equal(yb, yf.bfloat16())
    assert tuple(hf.shape) == (B, D, N)
    with pytest.raises(TypeError, match="float32"):
        mamba1_scan_ref(*args, _t(A), y_dtype=torch.float16)
    with pytest.raises(ValueError, match="h0 has shape"):
        mamba1_scan_ref(*map(_t, (x, dt, Bv, Cv, A)), _t(h0[:, :1]))


def test_k8_plain_defaults_match_pallas():
    """The defaults keep the Pallas kernel's contract (h starts at 0, y in
    x's dtype), in interpret mode; a zero h0 gives the same y."""
    x, dt, Bv, Cv, A, _ = _scan_inputs(5, 2, 24, 16, 8)
    got = mamba1_scan_ref(*map(_t, (x, dt, Bv, Cv, A)))
    want = mamba1_scan_pallas(*map(jnp.asarray, (x, dt, Bv, Cv, A)),
                              block_d=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    zero = torch.zeros((2, 16, 8))
    assert torch.equal(mamba1_scan_ref(*map(_t, (x, dt, Bv, Cv, A)), zero),
                       got)


def test_mixer_reaches_k8_once_a_layer_in_prefill_only(pair, monkeypatch):
    jcfg, jparams, pcfg, model = pair
    calls = []
    orig = ops.mamba1_scan

    def counted(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)
    monkeypatch.setattr(ops, "mamba1_scan", counted)
    toks = _t(_tokens(pcfg, (2, 7), 5))
    _, cache, _ = M.prefill(model, toks, pcfg)
    assert len(calls) == pcfg.n_layers
    assert all(kw == {"return_state": True, "y_dtype": torch.float32}
               for kw in calls)
    M.forward(model, toks, pcfg)
    assert len(calls) == 2 * pcfg.n_layers
    for _ in range(3):
        M.decode_step(model, toks[:, 0], cache, pcfg)
    assert len(calls) == 2 * pcfg.n_layers


def test_init_is_seeded_and_stores_the_jax_dtypes(pair):
    """Seeded draws, the JAX tree's names and shapes, bf16 matrices with
    float32 decays, skip and norms; the deterministic leaves equal the JAX
    package's."""
    jcfg, jparams, pcfg, model = pair
    a = M.init_params(pcfg, seed=3, device="cpu")
    b = M.init_params(pcfg, torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    if not torch.cuda.is_available():      # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.init_params(pcfg)
    c = M.init_params(pcfg, seed=4, device="cpu")
    assert not torch.equal(a.blocks[0].mixer["in_proj"],
                           c.blocks[0].mixer["in_proj"])
    jm = jparams["blocks"][0]["mixer"]
    for name, p in a.blocks[0].mixer.items():
        assert tuple(p.shape) == np.shape(jm[name])[1:], name
    for name in ("A_log", "D", "conv_b"):      # log(n) may differ by an ulp
        np.testing.assert_allclose(a.blocks[1].mixer[name].numpy(),
                                   np.asarray(jm[name][1]), **TOL)
    dt = torch.nn.functional.softplus(a.blocks[0].mixer["dt_proj_b"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    bf = M.init_params(dataclasses.replace(pcfg, dtype="bfloat16"),
                       device="cpu")
    mx = bf.blocks[0].mixer
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj_w",
                 "dt_proj_b", "out_proj"):
        assert mx[name].dtype == torch.bfloat16, name
    for t in (mx["A_log"], mx["D"], bf.blocks[0].ln, bf.final_norm):
        assert t.dtype == torch.float32
    assert bf.embed["tok"].dtype == bf.embed["unembed"].dtype \
        == torch.bfloat16


def test_param_count_is_the_jax_trees(pair):
    """The port holds exactly the JAX tree's leaves. ``param_count()`` of
    the config (kept equal to the JAX package's) leaves out dt_proj_w, the
    dt_rank columns of x_proj, one d_inner bias and the final norm, and
    counts a second d-wide norm a layer; at full width the tree holds
    7,272,665,088."""
    jcfg, jparams, pcfg, model = pair
    assert isinstance(model, S.SSM) and len(model.blocks) == pcfg.n_layers
    leaves = sum(int(np.size(a)) for a in jax.tree.leaves(jparams))
    assert M.param_count(model) == leaves

    def tree_count(cfg):
        d, di = cfg.d_model, cfg.ssm.expand * cfg.d_model
        dt_rank = max(d // 16, 1)
        return cfg.param_count() + cfg.n_layers * (
            2 * dt_rank * di + di - d) + d
    assert leaves == tree_count(pcfg)
    assert tree_count(get_config(ARCH)) == 7_272_665_088


def test_convert_refuses_a_tree_that_differs(pair):
    """Names, layer counts or shapes that differ from the port's raise."""
    jcfg, jparams, pcfg, model = pair
    tree = jax.tree.map(np.asarray, jparams)
    mixer = dict(tree["blocks"][0]["mixer"])
    renamed = dict(mixer, Dskip=mixer.pop("D"))
    bad = [
        dict(tree, blocks=[{"mixer": renamed, "ln": tree["blocks"][0]["ln"]}]),
        dict(tree, blocks=[{"mixer": tree["blocks"][0]["mixer"],
                            "ln": tree["blocks"][0]["ln"][:1]}]),
        dict(tree, blocks=tree["blocks"] * 2),
        dict(tree, blocks=[{"mixer": dict(tree["blocks"][0]["mixer"],
                                          x_proj=tree["blocks"][0]["mixer"]
                                          ["x_proj"][:, :, :-1]),
                            "ln": tree["blocks"][0]["ln"]}]),
    ]
    for t in bad:
        with pytest.raises(ValueError):
            params_from_numpy(t, pcfg, device=CPU)


def test_rows_invariant_matmul_is_the_product():
    """On the CPU the padded product of the card is x @ w itself, of x's
    shape but for the last axis."""
    rng = np.random.default_rng(8)
    w = _t(rng.standard_normal((24, 5)).astype(np.float32))
    for shape in ((3, 24), (2, 3, 24), (1, 1, 24),
                  (ops.INVARIANT_ROWS + 1, 24)):
        x = _t(rng.standard_normal(shape).astype(np.float32))
        got = ops.batch_invariant_matmul(x, w)
        assert tuple(got.shape) == shape[:-1] + (5,)
        assert torch.equal(got, x @ w)


def test_bf16_serving_on_the_cpu():
    """The bf16 path end to end on the CPU: finite logits, a bf16 conv
    cache and a float32 scan state; softplus follows ``jax.nn.softplus``
    past F.softplus's threshold."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    model = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 6), 6))
    tok, cache = ST.make_prefill_step(cfg)(model, {"inputs": toks})
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    logits, cache = M.decode_step(model, tok, cache, cfg)
    assert logits.dtype == torch.bfloat16 and cache["len"] == 7
    assert bool(torch.isfinite(logits).all())
    z = torch.tensor([-30.0, 0.0, 25.0])
    np.testing.assert_allclose(L.softplus(z).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(
                                   z.numpy()))), rtol=1e-6, atol=0)


# bf16 limits, relative L2 against the JAX package, from this test's
# readings on the CPU over JAX seeds 0-2: logits at most 1.8e-2, the conv
# window 5.6e-3, the scan state 1.3e-2.
BF16_LOGITS, BF16_CACHE = 3e-2, 2e-2


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_matches_the_jax_package(seed):
    """Reduced falcon-mamba-7b in bf16 with the JAX package's weights:
    forward logits, a 16-token prefill's logits and caches, then 4 decode
    steps on given tokens, each within ``BF16_LOGITS`` / ``BF16_CACHE``."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="bfloat16")
    pcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    jparams = JS.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                              device=CPU)
    toks = _tokens(pcfg, (2, 24), 10 + seed)
    want, _ = JS.forward(jparams, jnp.asarray(toks), jcfg)
    got, _ = M.forward(model, _t(toks), pcfg)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_LOGITS
    wl, wc, _ = JS.prefill(jparams, jnp.asarray(toks[:, :16]), jcfg)
    gl, gc, _ = M.prefill(model, _t(toks[:, :16]), pcfg)
    for step in range(5):
        assert _rel(gl, wl) <= BF16_LOGITS, step
        assert _rel(gc["conv"], wc["conv"]) <= BF16_CACHE, step
        assert _rel(gc["ssm"], wc["ssm"]) <= BF16_CACHE, step
        if step < 4:
            tok = toks[:, 16 + step]
            wl, wc = JS.decode_step(jparams, jnp.asarray(tok), wc, jcfg)
            gl, gc = M.decode_step(model, _t(tok), gc, pcfg)
