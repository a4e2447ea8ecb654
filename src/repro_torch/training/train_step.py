"""Serve steps: prefill and one token of greedy decode.

The serving half of the JAX package's ``training/train_step.py``; the
loss, the train step and the optimizer come with the training slice
(ROADMAP A10). Greedy choice is ``argmax`` of float32 logits, ties to the
first index in both packages.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M


def make_prefill_step(cfg, max_seq: Optional[int] = None):
    """(params, batch) -> (next token (B,) int32, cache), batch["inputs"]
    (B, S) tokens."""
    def prefill_step(params, batch):
        logits, cache, _ = M.prefill(params, batch["inputs"], cfg,
                                     max_seq=max_seq,
                                     positions=batch.get("positions"))
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok.to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg):
    """One token of greedy decode: (params, token, cache) -> (token,
    cache), the cache updated in place."""
    def serve_step(params, token, cache):
        logits, cache = M.decode_step(params, token, cache, cfg)
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        return nxt, cache
    return serve_step
