"""Pure-SSM family (falcon-mamba-7b): Mamba1 (S6) blocks, attention-free,
as ``nn.Module``s.

The JAX package scans the stacked layers; here each layer is a ``Block``
(the mixer's ``ParameterDict`` and its pre-norm ``ln``) in a
``ModuleList``. Every prefill and forward layer runs the selective scan as
one launch of kernel K8 on the card (``layers.mamba1_mixer``); a decode
step runs the reference's one-step recurrence as plain ops. The serving
cache keeps the JAX package's layout: ``conv`` (n_layers, B, d_conv-1,
d_inner) in the compute dtype, ``ssm`` (n_layers, B, d_inner, N) float32
and ``len``, a Python int. ``decode_step`` writes the cache in place (the
JAX package returns a new one).

On a mesh (``models.sharding.use(mesh)`` around the call) each rank holds
the block of every parameter and cache leaf its spec gives it
(``training.shardspec``): its di/TP channels, its rows of the batch. K8
runs on its channels.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import _cutter, compute_dtype
from repro_torch.training import shardspec


def _check_family(cfg) -> None:
    if cfg.family != "ssm" or cfg.ssm is None or cfg.ssm.version != 1:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not a Mamba1 ssm config: the "
            f"port's ssm module serves falcon-mamba; ROADMAP A10")


class Block(nn.Module):
    """One layer: pre-norm Mamba1 mixer with a residual."""

    def __init__(self, cfg, gen: torch.Generator, dtype, device):
        super().__init__()
        self.mixer = L.mamba1_params(gen, cfg, dtype, device)
        self.ln = L._zeros((cfg.d_model,), torch.float32, device)


class SSM(nn.Module):
    """The parameters of a Mamba1 stack: ``embed``, ``blocks`` (one
    ``Block`` a layer) and ``final_norm``; with ``mesh`` each cut to the
    rank's block as soon as it is drawn. ``forward`` is :func:`forward`."""

    def __init__(self, cfg, gen: torch.Generator, device, mesh=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        cut = _cutter(mesh)
        self.embed = cut(L.embed_params(gen, cfg, dtype, device))
        self.blocks = nn.ModuleList(cut(Block(cfg, gen, dtype, device))
                                    for _ in range(cfg.n_layers))
        self.final_norm = L._zeros((cfg.d_model,), torch.float32, device)
        cut(self)

    def forward(self, inputs, positions=None):
        return forward(self, inputs, self.cfg, positions)


def init_params(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda", mesh=None) -> SSM:
    """Random weights for ``cfg`` (the JAX package's distributions), drawn
    one tensor at a time on ``device`` from ``generator`` (a fresh one
    seeded with ``seed`` when none is given; it must live on ``device``).
    With ``mesh`` each rank keeps its block of the same draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return SSM(cfg, generator, device, mesh)


def _remat_layer(x, p: Block, cfg):
    return x + L.mamba1_mixer(L.rms_norm(x, p.ln, cfg.norm_eps), p.mixer,
                              cfg)[0]


def _layers(params: SSM, inputs, cfg, on_state=None):
    """Embed, run every layer, final norm and unembed. ``on_state(i,
    state)`` receives each layer's final conv and ssm state (prefill's
    cache). Where a gradient flows through the layers and ``cfg.remat`` is
    set, each layer runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` per layer): K8 twice a layer a train
    step."""
    _check_family(cfg)
    x = L.embed(inputs, params.embed)
    for i, p in enumerate(params.blocks):
        if cfg.remat and on_state is None and x.requires_grad:
            x = checkpoint(_remat_layer, x, p, cfg, use_reentrant=False)
            continue
        y, st = L.mamba1_mixer(L.rms_norm(x, p.ln, cfg.norm_eps), p.mixer,
                               cfg)
        x = x + y
        if on_state is not None:
            on_state(i, st)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.unembed(x, params.embed, cfg)


def forward(params: SSM, inputs: torch.Tensor, cfg, positions=None):
    """inputs: (B, S) int tokens (``positions`` is unused: the family has
    none). Returns (logits (B, S, V), aux_loss 0), with a graph where grad
    mode is on and a parameter requires a gradient (the loss's forward)."""
    logits = _layers(params, inputs, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    """The recurrent state of every layer, zero; its size does not depend
    on ``max_seq``. On a mesh ``batch`` is the whole batch and each rank
    allocates its block."""
    device = resolve_device(device)
    s = cfg.ssm
    di = s.expand * cfg.d_model
    shapes = shardspec.local_cache_shapes(
        {"conv": (cfg.n_layers, batch, s.d_conv - 1, di),
         "ssm": (cfg.n_layers, batch, di, s.d_state)}, sh.active_mesh())
    return {
        "conv": torch.zeros(shapes["conv"], dtype=dtype, device=device),
        "ssm": torch.zeros(shapes["ssm"], dtype=torch.float32,
                           device=device),
        "len": 0,
    }


@torch.no_grad()
def decode_step(params: SSM, token: torch.Tensor, cache: dict, cfg,
                positions=None):
    """token: (B,) int. Returns (logits (B, V), cache), every layer's state
    advanced in place and ``len`` + 1."""
    _check_family(cfg)
    x = L.embed(token[:, None], params.embed)
    for i, p in enumerate(params.blocks):
        y, st = L.mamba1_mixer(
            L.rms_norm(x, p.ln, cfg.norm_eps), p.mixer, cfg,
            state={"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
        cache["conv"][i].copy_(st["conv"])
        cache["ssm"][i].copy_(st["ssm"])
        x = x + y
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.unembed(x, params.embed, cfg)[:, 0]
    cache["len"] += 1
    return logits, cache


@torch.no_grad()
def prefill(params: SSM, inputs: torch.Tensor, cfg,
            max_seq: Optional[int] = None, positions=None):
    """Full-sequence forward and each layer's final state. ``max_seq`` is
    ignored, as in the JAX package: the state does not grow. Returns
    (logits, cache, aux_loss)."""
    B, S = inputs.shape[0], inputs.shape[1]
    cache = init_cache(cfg, B * sh.size("batch"), S, compute_dtype(cfg),
                       inputs.device)

    def keep(i, st):
        cache["conv"][i].copy_(st["conv"])
        cache["ssm"][i].copy_(st["ssm"])

    logits = _layers(params, inputs, cfg, keep)
    cache["len"] = S
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, cache, aux
