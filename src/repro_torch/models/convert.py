"""Weights carried across from the JAX package.

``params_from_numpy(tree, cfg)`` takes the JAX package's parameter pytree
for a dense or ssm config, read as numpy (``jax.tree.map(np.asarray,
params)``), and returns the port's ``Transformer`` or ``SSM`` holding the
same values: the scan axis of each ``params["blocks"][seg]`` leaf is
unstacked into one ``Block`` per layer, matrices and embeddings are cast
to the compute dtype and norm scales kept in float32, as ``init_params``
stores them. With ``mesh`` each rank keeps its block of every leaf
(``training.shardspec.shard_module``): this is how a sharded run is held
to the JAX package's weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.training.shardspec import shard_module


def _fill(dst: torch.nn.ParameterDict, src: dict, index=None) -> None:
    if set(dst.keys()) != set(src.keys()):
        raise ValueError(f"parameter names differ: port {sorted(dst.keys())}"
                         f", given {sorted(src.keys())}")
    for name, p in dst.items():
        a = np.asarray(src[name])
        if index is not None:
            a = a[index]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))


def _check_stack(seg, stack: dict) -> None:
    """Raise unless a stacked segment has the names of the port's blocks
    and one entry a block on every leaf's leading axis."""
    blk = seg[0]
    names = {n for n, _ in blk.named_children()} | {
        n for n, _ in blk.named_parameters(recurse=False)}
    if set(stack.keys()) != names:
        raise ValueError(f"block names differ: port {sorted(names)}, given "
                         f"{sorted(stack.keys())}")
    for name, leaf in stack.items():
        for a in (leaf.values() if isinstance(leaf, dict) else [leaf]):
            if np.shape(a)[:1] != (len(seg),):
                raise ValueError(f"{name}: {np.shape(a)[:1]} stacked, the "
                                 f"segment has {len(seg)} blocks")


def params_from_numpy(tree: dict, cfg, device="cuda", mesh=None):
    """The JAX package's ``init_params`` tree (numpy leaves) as the port's
    module on ``device``; with ``mesh``, this rank's blocks of it."""
    device = resolve_device(device)
    ssm = cfg.family == "ssm"
    n_segs = 1 if ssm else len(T._plan(cfg))
    if len(tree["blocks"]) != n_segs:
        raise ValueError(f"{len(tree['blocks'])} stacked segments, the port "
                         f"has {n_segs}")
    # allocate (the draw is overwritten), then copy every leaf
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        if ssm:
            model = S.SSM(cfg, gen, device)
            segments = [model.blocks]
        else:
            model = T.Transformer(cfg, gen, device)
            segments = model.segments
        _fill(model.embed, tree["embed"])
        model.final_norm.copy_(torch.from_numpy(
            np.array(tree["final_norm"], np.float32)))
        for seg, stack in zip(segments, tree["blocks"]):
            _check_stack(seg, stack)
            for i, blk in enumerate(seg):
                for name, part in blk.named_children():
                    _fill(part, stack[name], i)
                for name, p in blk.named_parameters(recurse=False):
                    p.copy_(torch.from_numpy(np.array(stack[name][i])))
    return model if mesh is None else shard_module(model, mesh)
