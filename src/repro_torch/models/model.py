"""Family dispatcher: one API over the architectures the port serves.

    init_params(cfg, generator, device=...)   parameter module
    forward(params, inputs, cfg, ...)         (logits, aux_loss)
    prefill(params, inputs, cfg, ...)         (logits, cache, aux)
    decode_step(params, token, cache, cfg)    (logits, cache)
    init_cache(cfg, batch, max_seq)           decode cache

The dense family runs on ``models.transformer`` (K7 in every prefill
layer), the ssm family (falcon-mamba) on ``models.ssm`` (K8 in every
prefill layer); every other family raises ``NotImplementedError`` naming
the ROADMAP item that brings it. ``init_params(mesh=)`` keeps each rank's
block of the parameters; the other calls run on the mesh whose rules are
active (``models.sharding.use``).
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm}
_LATER = {
    "moe": "the MoE family (mailbox-dispatch experts) is ROADMAP A10",
    "vlm": "the VLM family (M-RoPE, embedding inputs) is ROADMAP A10",
    "hybrid": "the hybrid family (Mamba2 + shared attention) is ROADMAP A10",
    "encdec": "the encoder-decoder family is ROADMAP A10",
}


def _mod(cfg):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    reason = _LATER.get(cfg.family, f"unknown family {cfg.family!r}")
    raise NotImplementedError(f"{cfg.name}: not ported yet; {reason}")


def init_params(cfg, generator=None, *, seed: int = 0, device="cuda",
                mesh=None):
    return _mod(cfg).init_params(cfg, generator, seed=seed, device=device,
                                 mesh=mesh)


def forward(params, inputs, cfg, positions=None):
    return _mod(cfg).forward(params, inputs, cfg, positions=positions)


def prefill(params, inputs, cfg, max_seq=None, positions=None):
    return _mod(cfg).prefill(params, inputs, cfg, max_seq=max_seq,
                             positions=positions)


def decode_step(params, token, cache, cfg, positions=None):
    return _mod(cfg).decode_step(params, token, cache, cfg,
                                 positions=positions)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_seq, dtype, device)


def param_count(params) -> int:
    return sum(p.numel() for p in params.parameters())
