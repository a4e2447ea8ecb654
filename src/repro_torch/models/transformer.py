"""Decoder-only transformer, dense family (llama3, qwen1.5-110b,
h2o-danube, gemma3), as ``nn.Module``s.

The JAX package scans stacked layers; here each layer is a ``Block`` and
a segment of the layer plan (``_plan``: gemma3's 5 local : 1 global
cycles, one segment for uniform stacks) is a ``ModuleList`` of them. The
serving cache keeps the JAX package's layout, per segment (n, B, s, KV, dh)
keys and values, with ring buffers of ``min(window, max_seq)`` slots for
window segments. ``decode_step`` writes the cache in place (the JAX
package returns a new one) and returns it with ``len`` advanced; ``len`` is
a Python int. The MoE and VLM members of the JAX module come with their
families (ROADMAP A10).

On a mesh (``models.sharding.use(mesh)`` around the call; the serve steps
of ``training.train_step`` take the mesh) ``init_params(mesh=)`` keeps the
rank's block of every parameter, the inputs are the rank's rows of the
batch, the cache holds its block as ``training.shardspec.cache_pspecs``
lays it out (batch over ('pod', 'data'), kv heads over 'model', or the
head dim where the kv heads do not divide TP), and the logits are its
block as ``sharding.logit_layout`` gives it. K7 runs on the rank's heads.
Off a mesh nothing changes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.training import shardspec


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.mrope \
            or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: the port's "
            f"transformer serves the dense family; ROADMAP A10")


# ---------------------------------------------------------------- params

class Block(nn.Module):
    """One decoder layer: pre-norm attention and pre-norm gated MLP."""

    def __init__(self, cfg, gen: torch.Generator, dtype, device):
        super().__init__()
        self.attn = L.attn_proj_params(gen, cfg, dtype, device)
        self.ln1 = L._zeros((cfg.d_model,), torch.float32, device)
        self.ln2 = L._zeros((cfg.d_model,), torch.float32, device)
        self.mlp = L.mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """The parameters of a dense decoder: ``embed``, ``segments`` (one
    ``ModuleList`` of ``Block``s per segment of ``_plan(cfg)``) and
    ``final_norm``. With ``mesh`` each part is cut to the rank's block as
    soon as it is drawn (``shardspec.shard_module``), so the draws are the
    unsharded model's. ``forward`` is :func:`forward`."""

    def __init__(self, cfg, gen: torch.Generator, device, mesh=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        cut = _cutter(mesh)
        self.embed = cut(L.embed_params(gen, cfg, dtype, device))
        self.final_norm = L._zeros((cfg.d_model,), torch.float32, device)
        self.segments = nn.ModuleList(
            nn.ModuleList(cut(Block(cfg, gen, dtype, device))
                          for _ in range(n))
            for n, _ in _plan(cfg))
        cut(self)

    def forward(self, inputs, positions=None):
        return forward(self, inputs, self.cfg, positions)


def _cutter(mesh):
    if mesh is None:
        return lambda m: m
    return lambda m: shardspec.shard_module(m, mesh)


def _plan(cfg):
    """Layer grouping: [(count, is_global)] segments. Uniform archs are one
    segment; gemma3 (5 local : 1 global) builds per-cycle segments."""
    if cfg.swa_pattern is None:
        return [(cfg.n_layers, cfg.swa_window is None)]
    loc, glob = cfg.swa_pattern
    segs = []
    n = cfg.n_layers
    while n > 0:
        take = min(loc, n)
        segs.append((take, False))
        n -= take
        if n > 0:
            g = min(glob, n)
            segs.append((g, True))
            n -= g
    return segs


def init_params(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda", mesh=None) -> Transformer:
    """Random weights for ``cfg`` (the JAX package's distributions), drawn
    one tensor at a time on ``device`` from ``generator`` (a fresh one
    seeded with ``seed`` when none is given; it must live on ``device``).
    With ``mesh`` each rank keeps its block of the same draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, generator, device, mesh)


# ---------------------------------------------------------------- forward

def _attn_block(x, p: Block, cfg, pos, is_global: bool):
    """Pre-norm attention with its residual; returns the keys and values
    too (whole heads of the rank's rows where the batch folded)."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    rows = L.batch_fold(cfg, h)
    if rows is not None:
        h, pos = h[rows], pos[rows]
    q, k, v = L.qkv(h, p.attn, cfg, whole=rows is not None)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    win = None if is_global else cfg.swa_window
    kq, vq = L.kv_for_heads(k, v, q.shape[2], cfg)
    o = L.flash_attention(q.contiguous(), kq.contiguous(), vq.contiguous(),
                          causal=True, window=win)
    y = L.attn_out(o, p.attn, x.dtype, whole=rows is not None)
    if rows is not None:        # the TP ranks' rows back together
        y, k, v = (sh.gather(t, "tp", 0) for t in (y, k, v))
    return x + y, k, v


def _ffn_block(x, p: Block, cfg):
    h = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp(h, p.mlp, cfg.act).to(x.dtype)


def _remat_layer(x, p: Block, cfg, pos, is_global: bool):
    return _ffn_block(_attn_block(x, p, cfg, pos, is_global)[0], p, cfg)


def _layers(params: Transformer, inputs, cfg, positions, on_kv=None):
    """Embed, run every layer, final norm and unembed. ``on_kv(seg, i, k,
    v)`` receives each layer's keys and values (prefill's cache). Where a
    gradient flows through the layers (``x.requires_grad``) and
    ``cfg.remat`` is set, each layer runs under ``torch.utils.checkpoint``,
    as the JAX package's ``jax.checkpoint`` per layer: the backward runs
    its forward again (K7 twice a layer a train step)."""
    _check_family(cfg)
    x = L.embed(inputs, params.embed)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for si, ((_, is_global), seg) in enumerate(zip(_plan(cfg),
                                                   params.segments)):
        for i, p in enumerate(seg):
            if cfg.remat and on_kv is None and x.requires_grad:
                x = checkpoint(_remat_layer, x, p, cfg, positions, is_global,
                               use_reentrant=False)
                continue
            x, k, v = _attn_block(x, p, cfg, positions, is_global)
            x = _ffn_block(x, p, cfg)
            if on_kv is not None:
                on_kv(si, i, k, v)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.unembed(x, params.embed, cfg)


def forward(params: Transformer, inputs: torch.Tensor, cfg, positions=None):
    """inputs: (B, S) int tokens; positions: (B, S) (default 0..S-1).
    Returns (logits (B, S, V), aux_loss); the dense family has no auxiliary
    loss, so it is 0. It records a graph where grad mode is on and a
    parameter requires a gradient (``training.optimizer.init_state``
    turns that on): the loss's forward. Serving's prefill and decode run
    without a graph."""
    logits = _layers(params, inputs, cfg, positions)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------- serving

def cache_len_for(cfg, is_global: bool, max_seq: int) -> int:
    if is_global or cfg.swa_window is None:
        return max_seq
    return min(cfg.swa_window, max_seq)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    """Per-segment KV caches; window segments use ring buffers of window
    size. On a mesh ``batch`` is the whole batch and each rank allocates
    its block (``shardspec.cache_pspecs``)."""
    device = resolve_device(device)
    caches = []
    for n, is_global in _plan(cfg):
        s = cache_len_for(cfg, is_global, max_seq)
        shape = shardspec.local_cache_shapes(
            {"k": (n, batch, s, cfg.n_kv_heads, cfg.head_dim)},
            sh.active_mesh())["k"]
        caches.append({
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        })
    return {"segs": caches, "len": 0}


def _cache_block(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Keys or values (..., KV', dh') as attention made them, cut to the
    cache's block (..., KV, dh): the rank's kv heads or head-dim slice
    where the cache splits what ``t`` holds whole."""
    kv, dh = like.shape[-2], like.shape[-1]
    if t.shape[-2] > kv:
        t = t.narrow(-2, sh.index("tp") * kv, kv)
    if t.shape[-1] > dh:
        t = t.narrow(-1, sh.index("tp") * dh, dh)
    return t


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor, cache: dict, cfg,
                positions=None):
    """token: (B,) int (the rank's rows on a mesh). Returns (logits (B, V),
    cache), the cache written in place at slot ``len`` (``len % s`` in a
    full ring) and ``len`` + 1."""
    _check_family(cfg)
    x = L.embed(token[:, None], params.embed)
    B = x.shape[0]
    pos = cache["len"]
    if positions is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    for (_, is_global), seg, c in zip(_plan(cfg), params.segments,
                                      cache["segs"]):
        s_cache = c["k"].shape[2]
        slot = pos if s_cache >= pos + 1 else pos % s_cache
        valid = min(pos + 1, s_cache)
        for i, p in enumerate(seg):
            h = L.rms_norm(x, p.ln1, cfg.norm_eps)
            q, k, v = L.qkv(h, p.attn, cfg)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            c["k"][i, :, slot] = _cache_block(k[:, 0], c["k"][i, :, slot])
            c["v"][i, :, slot] = _cache_block(v[:, 0], c["v"][i, :, slot])
            # the ring buffer already bounds the window
            o = L.decode_attention(q[:, 0], c["k"][i], c["v"][i], valid,
                                   cfg)
            x = x + L.attn_out(o[:, None], p.attn, x.dtype)
            x = _ffn_block(x, p, cfg)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.unembed(x, params.embed, cfg)[:, 0]
    cache["len"] = pos + 1
    return logits, cache


@torch.no_grad()
def prefill(params: Transformer, inputs: torch.Tensor, cfg,
            max_seq: Optional[int] = None, positions=None):
    """Full-sequence forward + decode-ready cache (ring-packed for window
    segments: the last s positions at slot pos % s). On a mesh ``inputs``
    are the rank's rows. Returns (logits, cache, aux_loss)."""
    B, S = inputs.shape[0], inputs.shape[1]
    max_seq = max_seq or S
    cache = init_cache(cfg, B * sh.size("batch"), max_seq,
                       compute_dtype(cfg), inputs.device)

    def write(si, i, k, v):
        c = cache["segs"][si]
        k, v = _cache_block(k, c["k"][i]), _cache_block(v, c["v"][i])
        s_cache = c["k"].shape[2]
        if s_cache >= S:    # plain cache: positions 0..S-1 at slots 0..S-1
            c["k"][i, :, :S] = k
            c["v"][i, :, :S] = v
        else:               # ring: keep the last s_cache positions
            slots = torch.arange(S - s_cache, S, device=k.device) % s_cache
            c["k"][i][:, slots] = k[:, -s_cache:]
            c["v"][i][:, slots] = v[:, -s_cache:]

    logits = _layers(params, inputs, cfg, positions, write)
    cache["len"] = S
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, cache, aux
