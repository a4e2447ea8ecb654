"""Weights carried across from the JAX package.

``params_from_numpy(tree, cfg)`` takes the JAX package's parameter pytree
for a dense config, read as numpy (``jax.tree.map(np.asarray, params)``),
and returns the port's ``Transformer`` holding the same values: the scan
axis of each ``params["blocks"][seg]`` leaf is unstacked into one ``Block``
per layer, matrices and embeddings are cast to the compute dtype and norm
scales kept in float32, as ``init_params`` stores them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as T


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


def params_from_numpy(tree: dict, cfg, device="cuda") -> T.Transformer:
    """The JAX package's ``init_params`` tree (numpy leaves) as the port's
    module on ``device``."""
    device = resolve_device(device)
    segs = T._plan(cfg)
    if len(tree["blocks"]) != len(segs):
        raise ValueError(f"{len(tree['blocks'])} stacked segments, the plan "
                         f"has {len(segs)}")
    # allocate (the draw is overwritten), then copy every leaf
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        model = T.Transformer(cfg, gen, device)
        _fill(model.embed, tree["embed"])
        model.final_norm.copy_(torch.from_numpy(
            np.array(tree["final_norm"], np.float32)))
        for seg, stack in zip(model.segments, tree["blocks"]):
            for i, blk in enumerate(seg):
                _fill(blk.attn, stack["attn"], i)
                _fill(blk.mlp, stack["mlp"], i)
                blk.ln1.copy_(torch.from_numpy(np.array(stack["ln1"][i])))
                blk.ln2.copy_(torch.from_numpy(np.array(stack["ln2"][i])))
    return model
