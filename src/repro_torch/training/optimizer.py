"""AdamW with mixed-precision master weights, the schedule and gradient
clipping.

The port of the JAX package's ``training/optimizer.py`` on one device. The
train state is a dict:

    params  the model (``nn.Module``): bf16 with ``mixed_precision``,
            its parameters ``requires_grad``
    master  {parameter name: float32 copy} (``mixed_precision`` only)
    m, v    {parameter name: float32 moment}
    step    int32 scalar tensor

Per parameter that is the JAX package's layout: model param bf16 (2 B),
master, m and v float32 (12 B). :func:`state_tree` gives the nest of
tensors the port's ``Checkpointer`` saves, :func:`load_state_tree` puts
one back. :func:`apply_updates` follows the JAX package's float32
arithmetic in its order: bf16 compression, the global-norm clip, warmup
plus cosine, bias correction, decoupled weight decay. Unlike the JAX
package it updates the state in place (the model's parameters, master, m
and v) and casts the gradients to float32 one parameter at a time, so a
step holds one parameter's temporaries and not a second copy of the state
or of the gradients.

With ``mixed_precision`` every parameter of the model copy becomes bf16,
norm scales and the Mamba decays included, as the JAX package casts every
leaf; the layers upcast those to float32 where they use them.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mixed_precision: bool = True       # bf16 params + fp32 master
    grad_compress_bf16: bool = False   # round the gradients to bf16 first


def schedule(step: torch.Tensor, cfg: OptCfg) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to 0.1·lr at
    ``total_steps``; float32, from the (integer) step tensor."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(model: torch.nn.Module, cfg: OptCfg) -> dict:
    """The train state of ``model`` (its parameters as drawn). With
    ``mixed_precision`` the master is a float32 copy and the model's
    parameters become bf16; without it the parameters are the master (no
    duplicate). Turns ``requires_grad`` on for the model's parameters:
    from here its forward records a graph."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                for n, p in params.items()}

    state = {"params": model, "m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.mixed_precision:
        with torch.no_grad():
            state["master"] = {n: p.detach().float().clone()
                               for n, p in params.items()}
            for p in params.values():
                p.data = p.data.to(torch.bfloat16)
    model.requires_grad_(True)
    return state


def global_norm(tree) -> torch.Tensor:
    """The L2 norm in float32 over a dict's values or an iterable of
    tensors, upcasting one at a time."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def apply_updates(state: dict, grads: dict, cfg: OptCfg):
    """One AdamW step. ``grads`` maps each parameter's name to its
    gradient (the model's dtype or float32). Updates ``state`` in place and
    returns it with dict(grad_norm, lr), float32 scalar tensors."""
    def f32(g):
        if cfg.grad_compress_bf16:
            g = g.to(torch.bfloat16)
        return g.float()

    gn = global_norm(map(f32, grads.values()))
    scale = torch.clamp(torch.full_like(gn, cfg.clip_norm)
                        / torch.clamp(gn, min=1e-9), max=1.0)

    step = state["step"] + 1
    lr = schedule(step, cfg)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    masters = state.get("master")
    for n, p in state["params"].named_parameters():
        g = f32(grads[n]) * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        mh = m / b1c
        vh = v / b2c
        master = p.data if masters is None else masters[n]
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * master))
        if masters is not None:
            p.data.copy_(master)            # rounded to bf16
    state["step"] = step
    return state, dict(grad_norm=gn, lr=lr)


def state_tree(state: dict) -> dict:
    """The state as a nest of tensors for ``Checkpointer.save``: the
    model's parameters by name, master (if any), m, v and step."""
    tree = {k: v for k, v in state.items() if k != "params"}
    tree["params"] = {n: p.detach()
                      for n, p in state["params"].named_parameters()}
    return tree


@torch.no_grad()
def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a restored :func:`state_tree` into ``state`` (the model's
    parameters in place, the rest replaced) and return it."""
    for n, p in state["params"].named_parameters():
        p.copy_(tree["params"][n])
    for k in ("master", "m", "v"):
        if k in state:
            state[k] = {n: t.to(torch.float32) for n, t in tree[k].items()}
    state["step"] = tree["step"].to(torch.int32)
    return state
