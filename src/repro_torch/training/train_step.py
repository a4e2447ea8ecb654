"""Train, eval and serve steps: the loss, its gradient and the optimizer
update; prefill and one token of greedy decode.

The port of the JAX package's ``training/train_step.py`` on one device
(training on a mesh is ROADMAP A10.2b). ``make_train_step`` returns a
(state, batch) -> (state, metrics) function over ``training.optimizer``'s
state; the gradient is ``torch.autograd.grad`` through the model's
forward, which reaches K7/K7b or K8/K8b on the card. The ssm and dense
families train; every other family raises in ``models.model``. Greedy
choice is ``argmax`` of float32 logits, ties to the first index in both
packages.

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
from repro_torch.models.transformer import compute_dtype
from repro_torch.training import optimizer as O

IGNORE = -1  # label ignore index


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits (B, S, V), labels (B, S).
    The float32 upcast feeds only the logsumexp; the gold logit is
    gathered in the logits' dtype."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold.float()) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def make_loss_fn(cfg):
    """(params, batch) -> (loss, {"ce", "aux"}); batch["inputs"] and
    ["labels"] (B, S) int tensors."""
    def loss_fn(params, batch):
        logits, aux = M.forward(params, batch["inputs"], cfg,
                                positions=batch.get("positions"))
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def _grads(loss: torch.Tensor, model) -> dict:
    """{parameter name: gradient of ``loss``}."""
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def make_train_step(cfg, opt_cfg: O.OptCfg, accum_steps: int = 1):
    """(state, batch) -> (state, metrics): the loss and its gradient, then
    one AdamW update (``optimizer.apply_updates``, in place). With
    ``accum_steps`` > 1 the batch's rows split into that many microbatches,
    run one after another, their gradients summed in float32 and averaged
    (peak activation memory 1/accum_steps, FLOPs unchanged). metrics:
    loss, ce, aux, grad_norm, lr (float32 scalar tensors)."""
    if opt_cfg.mixed_precision and compute_dtype(cfg) != torch.bfloat16:
        raise ValueError(f"{cfg.name}: mixed precision needs a bfloat16 "
                         f"config (its parameters become bf16), got "
                         f"{cfg.dtype}")
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        model = state["params"]
        if accum_steps == 1:
            loss, parts = loss_fn(model, batch)
            grads = _grads(loss, model)
            loss = loss.detach()
            parts = {k: v.detach() for k, v in parts.items()}
        else:
            rows = batch["inputs"].shape[0]
            if rows % accum_steps:
                raise ValueError(f"{rows} rows do not split into "
                                 f"{accum_steps} microbatches")
            n = rows // accum_steps
            grads = None
            dev = batch["inputs"].device
            lsum, cesum, auxsum = (torch.zeros((), dtype=torch.float32,
                                               device=dev) for _ in range(3))
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, parts = loss_fn(model, mb)
                g = _grads(l, model)
                if grads is None:
                    grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                            device=t.device)
                             for k, t in g.items()}
                for k, t in g.items():
                    grads[k] += t.float()
                lsum = lsum + l.detach()
                cesum = cesum + parts["ce"].detach()
                auxsum = auxsum + parts["aux"].detach()
            k = float(accum_steps)
            grads = {name: t / k for name, t in grads.items()}
            loss = lsum / k
            parts = {"ce": cesum / k, "aux": auxsum / k}
        state, om = O.apply_updates(state, grads, opt_cfg)
        return state, dict(loss=loss, **parts, **om)

    return train_step


def make_eval_step(cfg):
    """(params, batch) -> dict(loss, ce, aux), without a graph."""
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, batch)
        return dict(loss=loss, **parts)

    return eval_step


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
