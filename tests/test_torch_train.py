"""The port's training slice against the JAX package, on the CPU.

``training/data.py`` (bit-equal batches and state), ``cross_entropy``,
``apply_updates`` from one numpy state, and the train and eval steps of
reduced llama3-8b, gemma3-4b and falcon-mamba-7b with the JAX package's
``init_params(PRNGKey(0))`` carried across by ``params_from_numpy``: one
step's gradients against ``jax.grad`` of the JAX ``loss_fn``, three
steps' losses and the state after them, gradient accumulation, remat on
and off; and the train CLI cut and resumed. float32 throughout (the
reduced configs), so the sums' other orders are held at the tolerances
named at each check.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import data as JD  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import data as D  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_step as S  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["llama3-8b", "gemma3-4b", "falcon-mamba-7b"]
# Adam divides each gradient element by its own RMS, so an element whose
# gradient cancels to within float32's rounding of zero takes a step of
# about ±lr in either package at random (both are right to float32).
# eps = 1e-5, well above that rounding (~1e-7 here), keeps such an
# element's step below lr / 100 in both, so the states stay comparable.
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10, eps=1e-5,
           mixed_precision=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, rng, rows=4, seq=12):
    toks = rng.integers(0, cfg.vocab, (rows, seq + 1), dtype=np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _named(tree, cfg) -> dict:
    """A JAX parameter-shaped pytree (params, grads, m, v) as the port's
    {parameter name: numpy array}."""
    mod = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device=CPU)
    return {n: p.detach().numpy() for n, p in mod.named_parameters()}


def _close(got: dict, want: dict, what: str, rtol: float, atol: float,
           of_max: bool = False):
    """allclose per parameter; with ``of_max`` the atol is relative to the
    parameter's largest magnitude (a gradient element that cancels to
    near 0 keeps its O(1) terms' float32 rounding)."""
    assert set(got) == set(want), what
    for n in want:
        scale = float(np.abs(want[n]).max()) if of_max else 1.0
        np.testing.assert_allclose(got[n], want[n], rtol=rtol,
                                   atol=atol * scale, err_msg=f"{what} {n}")


def test_data_streams_match_the_jax_package(tmp_path):
    cfg = dict(batch=3, seq=9, vocab=500, seed=4)
    for kw in ({}, {"frames": (5, 4), "mrope": True}):
        j, p = JD.SyntheticLM(JD.DataCfg(**cfg, **kw)), \
            D.SyntheticLM(D.DataCfg(**cfg, **kw))
        for _ in range(3):
            a, b = next(j), next(p)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert j.state() == p.state()
        p2 = D.make_dataset(D.DataCfg(**cfg, **kw))
        p2.restore(p.state())
        np.testing.assert_array_equal(next(p2)["inputs"], next(j)["inputs"])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 1000).astype(
        np.uint16).tofile(path)
    fcfg = dict(batch=2, seq=15, vocab=700, path=str(path))
    j = JD.make_dataset(JD.DataCfg(**fcfg), host_index=1, host_count=2)
    p = D.make_dataset(D.DataCfg(**fcfg), host_index=1, host_count=2)
    assert isinstance(p, D.TokenFile)
    for _ in range(20):                    # past the span's end: wraps
        a, b = next(j), next(p)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert j.state() == p.state()
    p2 = D.TokenFile(D.DataCfg(**fcfg), host_index=1, host_count=2)
    p2.restore(p.state())
    np.testing.assert_array_equal(next(p2)["labels"], next(j)["labels"])


def test_cross_entropy_matches():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = S.IGNORE
    labels[2, 5] = S.IGNORE
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = S.cross_entropy(_t(logits), _t(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits: the gold logit gathered in bf16, the logsumexp in float32
    lb = jnp.asarray(logits).astype(jnp.bfloat16)
    want = JS.cross_entropy(lb, jnp.asarray(labels))
    got = S.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_ignored = np.full((2, 3), S.IGNORE, np.int32)
    assert float(S.cross_entropy(_t(logits[:2, :3]), _t(all_ignored))) == 0.0


def test_apply_updates_matches():
    """Three updates with the clip active, the warmup and cosine schedule,
    grad_compress_bf16 and mixed precision, from one numpy state and
    gradients: float32 master, m and v at rtol 1e-6 of each array's largest
    value (an element that cancels to near 0 keeps the rounding of its
    terms: XLA may contract b1·m + (1 − b1)·g into one fma where torch
    rounds each product), the bf16 model copy within one bf16 ulp."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5,
               grad_compress_bf16=True, mixed_precision=True)
    jstate = JO.init_state({k: jnp.asarray(v) for k, v in params.items()},
                           JO.OptCfg(**cfg))

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k, torch.nn.Parameter(_t(v)))
    pstate = O.init_state(Toy(), O.OptCfg(**cfg))
    for p in pstate["params"].parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
    for i in range(3):
        grads = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
                 for k, s in shapes.items()}
        jstate, jm = JO.apply_updates(
            jstate, {k: jnp.asarray(v).astype(jnp.bfloat16)
                     for k, v in grads.items()}, JO.OptCfg(**cfg))
        pstate, pm = O.apply_updates(
            pstate, {k: _t(v).to(torch.bfloat16) for k, v in grads.items()},
            O.OptCfg(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)
        assert int(pstate["step"]) == int(jstate["step"]) == i + 1
    for key in ("master", "m", "v"):
        for k, v in jstate[key].items():
            want = np.asarray(v)
            np.testing.assert_allclose(
                pstate[key][k].numpy(), want, rtol=1e-6,
                atol=1e-6 * np.abs(want).max(), err_msg=f"{key} {k}")
    for k, p in pstate["params"].named_parameters():
        want = np.asarray(jstate["params"][k].astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert np.all(np.abs(p.detach().float().numpy() - want) <= ulp), k


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: the JAX package's weights, one gradient, three train
    steps (with their batches) and one accumulated step, computed once."""
    out = {}
    for name in ARCHS:
        jc = jax_config(name).reduced()
        params = JM.init_params(jax.random.PRNGKey(0), jc)
        rng = np.random.default_rng(7)
        batches = [_batch(jc, rng) for _ in range(3)]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        (loss, _), grads = jax.jit(jax.value_and_grad(
            JS.make_loss_fn(jc), has_aux=True))(params, jb[0])
        ocfg = JO.OptCfg(**OPT)
        step = jax.jit(JS.make_train_step(jc, ocfg))
        state, losses = JO.init_state(params, ocfg), []
        for b in jb:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        acc_state, acc_met = jax.jit(JS.make_train_step(jc, ocfg, 2))(
            JO.init_state(params, ocfg), jb[0])
        out[name] = dict(params=jax.tree.map(np.asarray, params),
                         batches=batches, loss=float(loss), grads=grads,
                         losses=losses, state=state, acc_state=acc_state,
                         acc_loss=float(acc_met["loss"]))
    return out


def _model(name, tree, remat=True):
    cfg = dataclasses.replace(get_config(name).reduced(), remat=remat)
    return cfg, params_from_numpy(tree, cfg, device=CPU)


@pytest.mark.parametrize("name", ARCHS)
def test_train_steps_match_jax(name, jax_runs):
    """One step's gradients against ``jax.grad`` (rtol 1e-4, atol 1e-6 of
    each parameter's largest gradient);
    three steps' losses (rtol 1e-5) and the state after them (rtol 1e-4,
    atol 1e-5); one step with ``accum_steps=2`` likewise; remat on and off
    give bit-equal gradients."""
    run = jax_runs[name]
    cfg, model = _model(name, run["params"])
    state = O.init_state(model, O.OptCfg(**OPT))
    batch = {k: _t(v) for k, v in run["batches"][0].items()}
    loss, _ = S.make_loss_fn(cfg)(model, batch)
    np.testing.assert_allclose(float(loss.detach()), run["loss"], rtol=1e-5)
    grads = {k: v.numpy() for k, v in S._grads(loss, model).items()}
    _close(grads, _named(run["grads"], cfg), "grad", rtol=1e-4, atol=1e-6,
           of_max=True)

    off_cfg, off = _model(name, run["params"], remat=False)
    O.init_state(off, O.OptCfg(**OPT))
    loss_off, _ = S.make_loss_fn(off_cfg)(off, batch)
    for n, g in S._grads(loss_off, off).items():
        assert np.array_equal(g.numpy(), grads[n]), f"remat off: {n}"

    step = S.make_train_step(cfg, O.OptCfg(**OPT))
    for i, b in enumerate(run["batches"]):
        state, met = step(state, {k: _t(v) for k, v in b.items()})
        np.testing.assert_allclose(float(met["loss"]), run["losses"][i],
                                   rtol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-5)
    _close({n: p.detach().numpy() for n, p in model.named_parameters()},
           _named(run["state"]["params"], cfg), "params", **tol)
    for key in ("m", "v"):
        _close({n: t.numpy() for n, t in state[key].items()},
               _named(run["state"][key], cfg), key, **tol)

    _, acc = _model(name, run["params"])
    acc_state = O.init_state(acc, O.OptCfg(**OPT))
    acc_state, met = S.make_train_step(cfg, O.OptCfg(**OPT), 2)(
        acc_state, batch)
    np.testing.assert_allclose(float(met["loss"]), run["acc_loss"], rtol=1e-5)
    _close({n: p.detach().numpy() for n, p in acc.named_parameters()},
           _named(run["acc_state"]["params"], cfg), "accum params", **tol)
    _close({n: t.numpy() for n, t in acc_state["m"].items()},
           _named(run["acc_state"]["m"], cfg), "accum m", **tol)


def test_eval_step_matches(jax_runs):
    run = jax_runs["llama3-8b"]
    cfg, model = _model("llama3-8b", run["params"])
    jc = jax_config("llama3-8b").reduced()
    b = run["batches"][1]
    want = JS.make_eval_step(jc)(JM.init_params(jax.random.PRNGKey(0), jc),
                                 {k: jnp.asarray(v) for k, v in b.items()})
    O.init_state(model, O.OptCfg(**OPT))
    got = S.make_eval_step(cfg)(model, {k: _t(v) for k, v in b.items()})
    for k in ("loss", "ce", "aux"):
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_state_and_refusals():
    """Mixed precision casts every parameter to bf16 (norm scales too, as
    the JAX package does) beside float32 master, m and v; a float32 config
    refuses mixed precision; the CLI refuses a mesh, naming A10.2b."""
    cfg = get_config("falcon-mamba-7b").reduced()
    model = M.init_params(cfg, seed=0, device=CPU)
    drawn = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = O.init_state(model, O.OptCfg())
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad, n
        assert torch.equal(state["master"][n], drawn[n]), n
        assert state["m"][n].dtype == state["v"][n].dtype == torch.float32
    tree = O.state_tree(state)
    assert set(tree) == {"params", "master", "m", "v", "step"}
    with pytest.raises(ValueError, match="bfloat16"):
        S.make_train_step(cfg, O.OptCfg())
    with pytest.raises(NotImplementedError, match="A10.2b"):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh",
                           "data=1"])


def test_cli_cut_and_resumed_equals_uninterrupted(tmp_path, monkeypatch,
                                                  capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu`` for 8
    steps, and the same run cut after step 4's snapshot and resumed: the
    last snapshots are bit-equal."""
    argv = ["--arch", "llama3-8b", "--reduced", "--device", "cpu",
            "--steps", "8", "--batch", "2", "--seq", "16",
            "--ckpt-every", "4", "--log-every", "4"]
    launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "whole")])

    real = launch_train.make_dataset

    def cut_after_4(cfg):
        data = real(cfg)

        class Cut:
            def __next__(self):
                if data.step == 4:
                    raise RuntimeError("cut at step 4")
                return next(data)

            def state(self):
                return data.state()
        return Cut()
    monkeypatch.setattr(launch_train, "make_dataset", cut_after_4)
    with pytest.raises(RuntimeError, match="cut at step 4"):
        launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "cut")])
    monkeypatch.setattr(launch_train, "make_dataset", real)
    capsys.readouterr()
    launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "cut"),
                              "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    with np.load(tmp_path / "whole" / "step_8" / "host_0.npz") as a, \
            np.load(tmp_path / "cut" / "step_8" / "host_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
