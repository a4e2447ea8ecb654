"""The LM half of the port's multi-device backend (``models.sharding``,
``training.shardspec``, the dense and ssm families on a mesh over
``torch.distributed``) against the JAX package's GSPMD runs.

One module fixture runs, side by side, each in processes of its own:

  * the JAX side: processes under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, each serving
    some of the reduced configs on their meshes (``set_rules`` and
    ``jax.set_mesh``, params and prompts placed by the package's specs):
    llama3-8b on (2, 2) ('data', 'model') and on (2, 1, 2) ('pod', 'data',
    'model'); gemma3-4b on (2, 2); qwen1.5-110b on (1, 4), where its 2 kv
    heads do not divide TP (wk/wv row-parallel, the cache split on its
    head dim); falcon-mamba-7b on (2, 2) and (1, 4); and gemma3-4b with 2
    heads and 1 kv head on (1, 4), where the heads do not divide TP and
    attention folds its batch over 'model' (``batch_tp``). 8-token
    prompts, B 4, prefill and 3 greedy decode steps; the logits, the
    tokens, the caches and the specs are written as .npz and .json;
  * the port: 4 gloo ranks (rendezvous through a file, one thread each)
    build the same meshes from one world, load the same weights through
    ``params_from_numpy(mesh=)``, run the same steps, check that each
    holds only its spec's blocks, and write what they gathered; last,
    they ``restart`` the JAX package's llama3-8b snapshot onto
    ``shrink_after_failure((2, 2), 2)``;
  * ``serve --mesh data,model=2,2`` and the unsharded ``serve``.

The test process draws the weights (the JAX package's
``init_params(PRNGKey(0))``) and the snapshot before it starts them, and
writes the programs to ``tmp_path``, so no child imports this module.
float32 throughout: tokens are held equal, logits and caches allclose at
rtol = atol = 1e-5 (sums over ranks associate differently from XLA's).
llama3-8b reduced on (1, 4) is left out: the JAX package refuses it
(ROADMAP, known reference-side failures); qwen1.5-110b's (1, 4) run covers
the same GQA fallback.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, arch, mesh shape, axes, config overrides)
CASES = [
    ("llama_2x2", "llama3-8b", [2, 2], ["data", "model"], {}),
    ("llama_2x1x2", "llama3-8b", [2, 1, 2], ["pod", "data", "model"], {}),
    ("gemma_2x2", "gemma3-4b", [2, 2], ["data", "model"], {}),
    ("qwen_1x4", "qwen1.5-110b", [1, 4], ["data", "model"], {}),
    ("mamba_2x2", "falcon-mamba-7b", [2, 2], ["data", "model"], {}),
    ("mamba_1x4", "falcon-mamba-7b", [1, 4], ["data", "model"], {}),
    ("gemma_fold_1x4", "gemma3-4b", [1, 4], ["data", "model"],
     {"n_heads": 2, "n_kv_heads": 1}),
]
# the JAX side's processes (each compiles its cases' prefill and decode)
JAX_SPLIT = [["llama_2x2", "qwen_1x4"], ["llama_2x1x2", "mamba_1x4"],
             ["gemma_2x2", "mamba_2x2", "gemma_fold_1x4"]]
B, S, MAX_SEQ, STEPS = 4, 8, 12, 3

COMMON = r'''
import dataclasses, json, sys, time
import numpy as np


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    if type(tree) in (list, tuple):      # not a PartitionSpec
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def spec_json(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]
'''

JAX_SIDE = COMMON + r'''
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core import compat
from repro.models import model as M
from repro.models.sharding import clear_rules, set_rules
from repro.training import shardspec as SS
out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
B, S, MAX_SEQ, STEPS = (int(x) for x in sys.argv[3:7])
for name, arch, shape, axes, over in cases:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.load(f"{out_dir}/prompts.npy")
    mesh = compat.make_mesh(tuple(shape), tuple(axes))
    set_rules(mesh)
    jax.set_mesh(mesh)
    pspec = SS.param_pspecs(params, mesh)
    params = jax.device_put(params, SS.named(mesh, pspec))
    batch = {"inputs": jnp.asarray(toks)}
    bspec = SS.batch_pspecs(batch, mesh)
    batch = jax.device_put(batch, SS.named(mesh, bspec))
    pre = jax.jit(lambda p, x: M.prefill(p, x, cfg, max_seq=MAX_SEQ))
    dec = jax.jit(lambda p, t, c: M.decode_step(p, t, c, cfg))
    logits, cache, _ = pre(params, batch["inputs"])
    res = {"prefill_logits": np.asarray(logits)}
    res.update({f"prefill_cache/{k}": np.asarray(v)
                for k, v in flat(cache).items()})
    tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1).astype(jnp.int32)
    toks_out, dls = [tok], []
    for _ in range(STEPS):
        lg, cache = dec(params, tok, cache)
        dls.append(np.asarray(lg))
        tok = jnp.argmax(lg.astype(jnp.float32), -1).astype(jnp.int32)
        toks_out.append(tok)
    res["decode_logits"] = np.stack(dls)
    res["tokens"] = np.stack([np.asarray(t) for t in toks_out], 1)
    res.update({f"cache/{k}": np.asarray(v) for k, v in flat(cache).items()})
    specs = {f"param/{k}": spec_json(v) for k, v in flat(pspec).items()}
    specs.update({f"cache/{k}": spec_json(v) for k, v in
                  flat(SS.cache_pspecs(cache, mesh)).items()})
    specs.update({f"batch/{k}": spec_json(v) for k, v in flat(bspec).items()})
    specs.update({f"state/{k}": spec_json(v) for k, v in flat(
        SS.state_pspecs({"params": params, "step": 0}, mesh)).items()})
    if name == "llama_2x2":      # what the port's restart onto (1, 2) reads
        small = compat.make_mesh((1, 2), ("data", "model"),
                                 devices=jax.devices()[:2])
        specs.update({f"restart/{k}": spec_json(v) for k, v in
                      flat(SS.param_pspecs(params, small)).items()})
    clear_rules()
    np.savez(f"{out_dir}/jax_{name}.npz", **res)
    with open(f"{out_dir}/jax_{name}.json", "w") as f:
        json.dump(specs, f)
'''

TORCH_SIDE = COMMON + r'''
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch.elastic import MeshPlan, restart, shrink_after_failure
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import shardspec as SS
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.train_step import make_decode_step, make_prefill_step
rank, world, rdv, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])
cases = json.loads(sys.argv[5])
B, S, MAX_SEQ, STEPS = (int(x) for x in sys.argv[6:10])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world)


def unflat(z):
    tree = {}
    for key in z.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]

    def fix(t):
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return [fix(t[str(i)]) for i in range(len(t))]
        return {k: fix(v) for k, v in t.items()} if isinstance(t, dict) else t
    return fix(tree)


def gathered(x, spec):
    for d, entry in enumerate(spec):
        if sh.axes_of(entry):
            x = sh.gather(x, sh.axes_of(entry), d)
    return x


def leaf_of(name):
    return name.rsplit(".", 1)[-1]


ok = True
toks = np.load(f"{out_dir}/prompts.npy")
for name, arch, shape, axes, over in cases:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    tree = unflat(np.load(f"{out_dir}/weights_{arch}{'_'.join(over)}.npz"))
    mesh = make_mesh(shape, axes, device="cpu")
    model = params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    whole = dict(params_from_numpy(tree, cfg, device="cpu")
                 .named_parameters())
    res, specs = {}, {}
    whole_cache = M.init_cache(cfg, B, MAX_SEQ, torch.float32, "cpu")
    full = flat(whole_cache)
    cspec = flat(SS.cache_pspecs(whole_cache, mesh))
    with sh.use(mesh):
        rows = sh.batch_rows(B)
        x = torch.from_numpy(toks[rows])
        sh.reset_collectives()
        logits, cache, _ = M.prefill(model, x, cfg, max_seq=MAX_SEQ)
        res["prefill_collectives"] = np.asarray(
            sum(sh.collectives().values()))
        res["prefill_logits"] = sh.gather_batch(
            sh.full_logits(logits, cfg, S)).numpy()
        # each cache leaf's block, gathered by its spec
        for k, v in flat(cache).items():
            if hasattr(v, "shape"):
                leaf = k.rsplit("/", 1)[-1]
                ok &= tuple(v.shape) == SS.local_shape(
                    leaf, cspec[k], tuple(full[k].shape), mesh)
                res[f"prefill_cache/{k}"] = gathered(v, cspec[k]).numpy()
        tok = sh.gather_batch(sh.greedy(logits[:, -1].float(), cfg, S)
                              .to(torch.int32))
        out, dls = [tok], []
        for _ in range(STEPS):
            sh.reset_collectives()
            lg, cache = M.decode_step(model, tok[rows], cache, cfg)
            res["decode_collectives"] = np.asarray(
                sum(sh.collectives().values()))
            dls.append(sh.gather_batch(sh.full_logits(lg[:, None], cfg, 1))
                       [:, 0].numpy())
            tok = sh.gather_batch(sh.greedy(lg.float(), cfg, 1)
                                  .to(torch.int32))
            out.append(tok)
        res["decode_logits"] = np.stack(dls)
        res["tokens"] = torch.stack(out, 1).numpy()
        for k, v in flat(cache).items():
            if hasattr(v, "shape"):
                res[f"cache/{k}"] = gathered(v, cspec[k]).numpy()
    # the public serve steps give the same tokens
    prefill = make_prefill_step(cfg, max_seq=MAX_SEQ, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)
    t, c = prefill(model, {"inputs": x})
    st = [t]
    for _ in range(STEPS):
        t, c = decode(model, t, c)
        st.append(t)
    res["step_tokens"] = torch.stack(st, 1).numpy()
    # each rank holds its spec's block of every parameter, and only that:
    # the block cut here by hand from the whole weights and the rank's
    # mesh coordinates (in_proj: the xin and z columns of its channels)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for n, p in model.named_parameters():
        a = whole[n].detach()
        for d, entry in enumerate(p.spec):
            axes = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            k, i = 1, 0
            for ax in axes:
                k, i = k * sizes[ax], i * sizes[ax] + coords[ax]
            if leaf_of(n) == "in_proj" and d == 1 and k > 1:
                half = a.shape[1] // 2
                c = half // k
                a = torch.cat([a[:, i * c:(i + 1) * c],
                               a[:, half + i * c:half + (i + 1) * c]], 1)
            else:
                a = a.narrow(d, i * (a.shape[d] // k), a.shape[d] // k)
        ok &= torch.equal(p.detach(), a)
    specs.update({f"param/{k}": spec_json(v)
                  for k, v in SS.param_pspecs(model).items()})
    specs.update({f"cache/{k}": spec_json(v) for k, v in cspec.items()})
    specs.update({f"batch/{k}": spec_json(v) for k, v in flat(
        SS.batch_pspecs({"inputs": torch.from_numpy(toks)}, mesh)).items()})
    specs.update({f"state/{k}": spec_json(v) for k, v in flat(
        SS.state_pspecs({"params": model, "step": 0}, mesh)).items()})
    if rank == 0:
        np.savez(f"{out_dir}/torch_{name}.npz", **res)
        with open(f"{out_dir}/torch_{name}.json", "w") as f:
            json.dump(specs, f)
flags = torch.tensor([int(not ok)])
dist.all_reduce(flags)
# last (its sub-mesh's groups are made by two ranks only): the JAX
# package's llama3-8b snapshot restarted onto the shrunk plan
plan = shrink_after_failure(MeshPlan((2, 2), ("data", "model")), 2)
tree = unflat(np.load(f"{out_dir}/weights_llama3-8b.npz"))
m, state, step = restart(Checkpointer(f"{out_dir}/ck"), tree, plan,
                         SS.param_pspecs(tree, plan), device="cpu")
if m is not None:
    np.savez(f"{out_dir}/restart_{rank}.npz", step=np.asarray(step),
             shape=np.asarray(plan.shape), coord=np.asarray(
                 m.get_coordinate()),
             **{k: v.numpy() for k, v in flat(state).items()})
if rank == 0:
    np.save(f"{out_dir}/blocks_ok.npy", np.asarray(int(flags) == 0))
dist.destroy_process_group()
'''


def _spawn(args, env, tmp, name):
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    return subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=tmp), log


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Draw the weights, the prompts and the snapshot; run every world at
    once; return their results."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.models import model as JM
    from repro.training.checkpoint import Checkpointer as JCheckpointer
    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    np.save(os.path.join(tmp, "prompts.npy"), np.random.default_rng(0)
            .integers(0, 256, (B, S), dtype=np.int32))
    weights = {}
    for _, arch, _, _, over in CASES:
        key = f"{arch}{'_'.join(over)}"
        if key not in weights:
            cfg = dataclasses.replace(get_config(arch).reduced(), **over)
            weights[key] = jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(0), cfg))
            np.savez(os.path.join(tmp, f"weights_{key}.npz"),
                     **_flat(weights[key]))
    JCheckpointer(os.path.join(tmp, "ck")).save(weights["llama3-8b"], 5)
    for name, text in (("jax_side.py", JAX_SIDE),
                       ("torch_side.py", TORCH_SIDE)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={D}").strip())
    dims = [str(x) for x in (B, S, MAX_SEQ, STEPS)]
    t0 = time.perf_counter()
    by_name = {c[0]: c for c in CASES}
    procs = [_spawn(["jax_side.py", tmp, json.dumps(
        [by_name[n] for n in part]), *dims], jenv, tmp, f"jax{i}")
        for i, part in enumerate(JAX_SPLIT)]
    procs += [_spawn(["torch_side.py", str(r), str(D),
                      os.path.join(tmp, "rdv"), tmp, json.dumps(CASES),
                      *dims], env, tmp, f"rank{r}") for r in range(D)]
    serve = ["-m", "repro_torch.launch.serve", "--arch", "llama3-8b",
             "--reduced", "--device", "cpu", "--prompt-len", "8", "--gen",
             "6"]
    procs += [_spawn(serve + ["--mesh", "data,model=2,2"], env, tmp,
                     "serve_mesh"), _spawn(serve, env, tmp, "serve_one")]
    names = [f"jax{i}" for i in range(len(JAX_SPLIT))] + [
        f"rank{r}" for r in range(D)] + ["serve_mesh", "serve_one"]
    rcs = []
    for p, log in procs:
        try:
            rcs.append(p.wait(timeout=600))
        finally:
            p.kill()
            log.close()
    logs = {n: open(os.path.join(tmp, f"{n}.log")).read() for n in names}
    if any(rcs):
        pytest.fail(f"exit codes {rcs}: "
                    f"{ {n: t[-3000:] for n, t in logs.items()} }")
    res = {"seconds": time.perf_counter() - t0, "logs": logs,
           "weights": weights}
    for side in ("jax", "torch"):
        for name, *_ in CASES:
            res[side, name] = dict(np.load(os.path.join(
                tmp, f"{side}_{name}.npz")))
            with open(os.path.join(tmp, f"{side}_{name}.json")) as f:
                res[side, name, "specs"] = json.load(f)
    res["blocks_ok"] = bool(np.load(os.path.join(tmp, "blocks_ok.npy")))
    res["restart"] = [dict(np.load(os.path.join(tmp, f"restart_{r}.npz")))
                      for r in range(2)]
    return res


def _jax_key(kind: str, name: str) -> str:
    """The JAX package's flat key of a port parameter name: a block's
    leaf is stacked in its segment (``params["blocks"][seg]``)."""
    parts = name.split(".")
    if parts[0] == "segments":
        return f"{kind}/blocks/{parts[1]}/" + "/".join(parts[3:])
    if parts[0] == "blocks":
        return f"{kind}/blocks/0/" + "/".join(parts[2:])
    return f"{kind}/" + "/".join(parts)


def test_specs_match_jax(worlds):
    """``param_pspecs``, ``state_pspecs``, ``cache_pspecs`` and
    ``batch_pspecs`` equal the JAX package's leaf by leaf on every mesh, a
    block's parameter without the JAX leaf's leading stack dim."""
    for name, *_ in CASES:
        t, j = worlds["torch", name, "specs"], worlds["jax", name, "specs"]
        for k, spec in t.items():
            kind = k.split("/", 1)[0]
            if kind in ("param", "state"):
                sub = k.split("/", 1)[1]
                if kind == "state":
                    if sub == "step":
                        assert spec == j["state/step"] == [], (name, k)
                        continue
                    sub = sub.split("/", 1)[1]
                jk = _jax_key(kind if kind == "param" else "state/params",
                              sub)
                want = j[jk]
                if "/blocks/" in jk and want:     # P() stays P()
                    assert want[0] is None, (name, k, want)
                    want = want[1:]
                assert spec == want, (name, k, spec, want)
            else:
                assert spec == j[k], (name, k, spec, j[k])
        # every JAX parameter has its port counterpart
        assert {_jax_key("param", k.split("/", 1)[1]) for k in t
                if k.startswith("param/")} == {k for k in j
                                               if k.startswith("param/")}
    # the GQA fallback and the fold are among them
    q = worlds["torch", "qwen_1x4", "specs"]
    assert q["param/segments.0.0.attn.wk"] == ["model", None, None]
    assert q["cache/segs/0/k"] == [None, "data", None, None, "model"]
    f = worlds["torch", "gemma_fold_1x4", "specs"]
    assert f["param/segments.0.0.attn.wq"] == ["data", None, None]


def test_each_rank_holds_only_its_block(worlds):
    """On every mesh each rank's parameters are its spec's blocks of the
    JAX weights (Mamba1's in_proj: the xin and z columns of its channels)
    and its caches have its spec's block shape."""
    assert worlds["blocks_ok"]


def test_tokens_match_jax(worlds):
    """The greedy tokens of the prefill and 3 decode steps equal the JAX
    package's on every mesh, through the port's serve steps too."""
    for name, *_ in CASES:
        t, j = worlds["torch", name], worlds["jax", name]
        assert np.array_equal(t["tokens"], j["tokens"]), name
        assert np.array_equal(t["step_tokens"], j["tokens"]), name


def test_logits_and_caches_match_jax(worlds):
    """Prefill and decode logits and the caches after the prefill and
    after the decode steps, gathered from the ranks, allclose to the JAX
    package's at rtol = atol = 1e-5; the steps issued collectives."""
    for name, *_ in CASES:
        t, j = worlds["torch", name], worlds["jax", name]
        for k in ("prefill_logits", "decode_logits"):
            np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=name)
        caches = [k for k in j if "cache/" in k and not k.endswith("len")]
        assert caches and set(caches) == {k for k in t if "cache/" in k}
        for k in caches:
            assert t[k].shape == j[k].shape, (name, k)
            np.testing.assert_allclose(t[k], j[k], **TOL,
                                       err_msg=f"{name} {k}")
        assert t["prefill_collectives"] > 0 and t["decode_collectives"] > 0


def test_restart_onto_the_shrunk_mesh(worlds):
    """The JAX package's llama3-8b snapshot, restarted onto
    ``shrink_after_failure((2, 2), 2)`` (the (1, 2) mesh of world ranks 0
    and 1): each rank's block of every leaf equals the slice of the JAX
    array by the JAX package's specs on a (1, 2) mesh."""
    specs = worlds["jax", "llama_2x2", "specs"]
    full = _flat(worlds["weights"]["llama3-8b"])
    for r, got in enumerate(worlds["restart"]):
        assert list(got["shape"]) == [1, 2] and int(got["step"]) == 5
        coord = dict(zip(("data", "model"), got["coord"]))
        assert coord["model"] == r
        for k, arr in full.items():
            idx = []
            for d, entry in enumerate(specs[f"restart/{k}"]):
                axes = entry if isinstance(entry, list) else (
                    [] if entry is None else [entry])
                k_ = int(np.prod([{"data": 1, "model": 2}[a] for a in axes]))
                i = coord["model"] if "model" in axes else 0
                n = arr.shape[d] // k_
                idx.append(slice(i * n, (i + 1) * n))
            assert np.array_equal(got[k], arr[tuple(idx)]), (r, k)


def test_serve_cli_on_a_mesh_equals_unsharded(worlds):
    """``serve --mesh data,model=2,2 --device cpu --reduced`` (4 gloo
    ranks under one deadline, rank 0 printing) prints the unsharded
    ``serve``'s tokens."""
    def tokens(log):
        line = [x for x in log.splitlines() if x.startswith("generated")]
        assert len(line) == 1, log
        return line[0].split(":", 1)[1]
    mesh, one = worlds["logs"]["serve_mesh"], worlds["logs"]["serve_one"]
    assert "mesh=data,model=2,2" in mesh
    assert tokens(mesh) == tokens(one)


def test_production_mesh_refuses_a_small_world(tmp_path):
    """``make_production_mesh`` (16 x 16, and 2 x 16 x 16 with pods) raises
    ``ValueError`` in a world of one rank; importing ``launch.mesh``
    touches no group; ``MeshPlan.make`` builds a ('data', 'model') mesh."""
    import torch.distributed as dist
    from _mesh_world import one_rank_world

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.elastic import MeshPlan
    assert not dist.is_initialized()
    with one_rank_world(tmp_path) as _:
        for pods in (False, True):
            with pytest.raises(ValueError, match="needs"):
                lmesh.make_production_mesh(multi_pod=pods, device="cpu")
        m = MeshPlan((1, 1), ("data", "model")).make(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
