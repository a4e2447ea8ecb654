"""The port's dense LM serving path against the JAX package, on the CPU.

The reduced configs of llama3-8b, h2o-danube-1.8b (every layer windowed;
also with its full-width head width of 80), gemma3-4b (5 local : 1 global,
tied embeddings, qk norm, GELU) and qwen1.5-110b (qkv bias): the JAX
package's ``init_params(PRNGKey(0))`` carried into the port by
``params_from_numpy``, the same tokens from a numpy seed through both. float32 throughout, so logits and caches are
held to allclose at rtol = atol = 1e-5 and greedy tokens to equality.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import train_step as S  # noqa: E402

DENSE = ["llama3-8b", "h2o-danube-1.8b", "gemma3-4b", "qwen1.5-110b"]
# reduced configs that keep a full-width head width: h2o-danube's 80
WIDE_HEADS = {"h2o-danube-1.8b/d_head=80": ("h2o-danube-1.8b", 80)}
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=DENSE + list(WIDE_HEADS))
def pair(request):
    """(name, JAX cfg, JAX params, port cfg, port model) of one reduced
    dense arch."""
    name, d_head = WIDE_HEADS.get(request.param, (request.param, None))
    jcfg = jax_config(name).reduced()
    pcfg = get_config(name).reduced()
    if d_head is not None:
        jcfg = dataclasses.replace(jcfg, d_head=d_head)
        pcfg = dataclasses.replace(pcfg, d_head=d_head)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return name, jcfg, jparams, pcfg, params_from_numpy(tree, pcfg,
                                                        device=CPU)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_configs_are_the_jax_packages():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))
        assert get_config(name).param_count() == jax_config(name).param_count()
        assert get_config(name).reduced().param_count() == \
            jax_config(name).reduced().param_count()


def test_forward_matches(pair):
    name, jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (2, 12), 0)
    want, _ = JT.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(model, _t(toks), pcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the module's own forward is the same function
    np.testing.assert_allclose(model(_t(toks))[0].numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_prefill_logits_and_cache_match(pair):
    """A 12-token prompt into a 16-slot cache: window segments (8 slots)
    are ring-packed, global ones plain."""
    name, jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (2, 12), 1)
    wl, wc, _ = JT.prefill(jparams, jnp.asarray(toks), jcfg, max_seq=16)
    gl, gc, _ = T.prefill(model, _t(toks), pcfg, max_seq=16)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    assert gc["len"] == int(wc["len"]) == 12
    assert len(gc["segs"]) == len(wc["segs"])
    for g, w in zip(gc["segs"], wc["segs"]):
        for key in ("k", "v"):
            assert tuple(g[key].shape) == tuple(w[key].shape)
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]),
                                       **TOL)
    if pcfg.swa_window is not None:
        assert any(c["k"].shape[2] == pcfg.swa_window < 12
                   for c in gc["segs"])


def test_decode_steps_match(pair):
    """An 8-token prefill (max_seq 12), then 4 greedy decode steps: window
    segments wrap their 8-slot ring."""
    name, jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (2, 8), 2)
    wl, wc, _ = JT.prefill(jparams, jnp.asarray(toks), jcfg, max_seq=12)
    gl, gc, _ = T.prefill(model, _t(toks), pcfg, max_seq=12)
    wt = jnp.argmax(wl[:, -1], axis=-1).astype(jnp.int32)
    gt = torch.argmax(gl[:, -1], dim=-1).to(torch.int32)
    for step in range(4):
        assert np.array_equal(gt.numpy(), np.asarray(wt)), step
        wl, wc = JT.decode_step(jparams, wt, wc, jcfg)
        gl, gc = T.decode_step(model, gt, gc, pcfg)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        assert gc["len"] == int(wc["len"]) == 9 + step
        wt = jnp.argmax(wl, axis=-1).astype(jnp.int32)
        gt = torch.argmax(gl, dim=-1).to(torch.int32)
    for g, w in zip(gc["segs"], wc["segs"]):
        np.testing.assert_allclose(g["k"].numpy(), np.asarray(w["k"]), **TOL)
        np.testing.assert_allclose(g["v"].numpy(), np.asarray(w["v"]), **TOL)


def test_serve_steps_give_the_same_tokens(pair):
    """``make_prefill_step`` then ``make_decode_step``, greedy, in both
    packages."""
    name, jcfg, jparams, pcfg, model = pair
    toks = _tokens(pcfg, (3, 6), 3)
    jpre, jdec = JS.make_prefill_step(jcfg, max_seq=10), \
        JS.make_decode_step(jcfg)
    ppre, pdec = S.make_prefill_step(pcfg, max_seq=10), \
        S.make_decode_step(pcfg)
    wt, wc = jpre(jparams, {"inputs": jnp.asarray(toks)})
    gt, gc = ppre(model, {"inputs": _t(toks)})
    assert gt.dtype == torch.int32
    for _ in range(4):
        assert np.array_equal(gt.numpy(), np.asarray(wt))
        wt, wc = jdec(jparams, wt, wc)
        gt, gc = pdec(model, gt, gc)
    assert np.array_equal(gt.numpy(), np.asarray(wt))


def test_dispatcher_serves_dense_and_init_is_seeded():
    cfg = get_config("llama3-8b").reduced()
    a = M.init_params(cfg, seed=3, device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    # the analytic count leaves out the final norm
    assert M.param_count(a) == cfg.param_count() + cfg.d_model
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.segments[0][0].ln1.dtype == torch.float32
    bf = M.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                       device="cpu")
    assert bf.segments[0][0].attn["wq"].dtype == torch.bfloat16
    assert bf.segments[0][0].ln1.dtype == torch.float32
    toks = torch.zeros((1, 4), dtype=torch.int32)
    logits, cache, _ = M.prefill(a, toks, cfg, max_seq=6)
    assert logits.shape == (1, 4, cfg.vocab) and cache["len"] == 4


@pytest.mark.parametrize("name", sorted(n for n, c in ARCHS.items()
                                        if c.family not in ("dense", "ssm")))
def test_other_families_raise(name):
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="A10"):
        M.init_params(cfg, device="cpu")
    dense = M.init_params(get_config("llama3-8b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        M.forward(dense, torch.zeros((1, 2), dtype=torch.int32), cfg)
