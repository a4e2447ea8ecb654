"""Serve steps: prefill and one token of greedy decode.

The serving half of the JAX package's ``training/train_step.py``; the
loss, the train step and the optimizer come with the training slice
(ROADMAP A10). Greedy choice is ``argmax`` of float32 logits, ties to the
first index in both packages.

With ``mesh`` the steps run under its rules (``models.sharding.use``):
each rank feeds its rows of the prompts (``shardspec.batch_pspecs``) and
holds its block of the parameters and the cache; the greedy argmax over
vocab-sharded logits keeps ties on the first global index
(``sharding.greedy``), and the tokens are all-gathered over the batch
axes, so every rank returns all B. The decode step takes all B tokens and
feeds its own rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models import sharding as sh


def make_prefill_step(cfg, max_seq: Optional[int] = None, mesh=None):
    """(params, batch) -> (next token (B,) int32, cache), batch["inputs"]
    (B, S) tokens (the rank's rows on a mesh; all B tokens come back)."""
    def prefill_step(params, batch):
        with sh.use(mesh):
            inputs = batch["inputs"]
            logits, cache, _ = M.prefill(params, inputs, cfg,
                                         max_seq=max_seq,
                                         positions=batch.get("positions"))
            nxt = sh.greedy(logits[:, -1].float(), cfg, inputs.shape[1])
            return sh.gather_batch(nxt.to(torch.int32)), cache
    return prefill_step


def make_decode_step(cfg, mesh=None):
    """One token of greedy decode: (params, token, cache) -> (token,
    cache), the cache updated in place; ``token`` and the result (B,)."""
    def serve_step(params, token, cache):
        with sh.use(mesh):
            mine = token[sh.batch_rows(token.shape[0])]
            logits, cache = M.decode_step(params, mine, cache, cfg)
            nxt = sh.greedy(logits.float(), cfg, 1)
            return sh.gather_batch(nxt.to(torch.int32)), cache
    return serve_step
