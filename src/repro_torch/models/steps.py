"""Train, prefill and serve step builders; port of ``repro.models.steps``.

train_step: microbatched gradient accumulation (a loop over row slices,
fp32 accumulators) -> global fp32 grads -> Adam. The reference's sharding
rules and abstract input specs are placement and dry-run accounting, not
ported here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, forward_encdec,
                                           forward_lm)
from repro_torch.train.adam import (AdamConfig, AdamState, adam_update,
                                    tree_leaves, tree_unflatten)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """Mean next-token cross entropy over the masked positions.

    fp32 over the whole padded vocab (the padded columns count in the
    logsumexp). The gold logit is gathered: the reference's one-hot
    contraction adds exact zeros to it, so the two agree bit for bit.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def _forward_loss(params: dict, cfg: ModelConfig, batch: dict
                  ) -> torch.Tensor:
    if cfg.is_encdec:
        logits = forward_encdec(params, cfg, batch["frames"], batch["tokens"])
        return lm_loss(logits, batch["labels"], batch["mask"])
    patch = batch.get("patch_embeds", None)
    logits = forward_lm(params, cfg, batch["tokens"], patch_embeds=patch)
    if patch is not None:
        # loss on the text positions only (vision prefix is unsupervised)
        logits = logits[:, patch.shape[1]:, :]
    return lm_loss(logits, batch["labels"], batch["mask"])


# --------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------
def _loss_and_grads(params: dict, cfg: ModelConfig, batch: dict):
    """(loss, grads as a list in ``tree_leaves`` order) of one batch."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = _forward_loss(tree_unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def make_train_step(cfg: ModelConfig, adam_cfg: Optional[AdamConfig] = None,
                    num_microbatches: int = 1):
    """``train_step(params, opt, batch) -> (params, opt, loss)``: the
    batch's mean loss and its gradient, averaged over ``num_microbatches``
    equal row slices, then one Adam step (lr 3e-4, clip 1.0 by default)."""
    adam_cfg = adam_cfg or AdamConfig(learning_rate=3e-4, grad_clip_norm=1.0)

    def train_step(params: dict, opt: AdamState, batch: dict):
        if num_microbatches > 1:
            rows = next(iter(batch.values())).shape[0] // num_microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            losses = []
            for i in range(num_microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                loss, g = _loss_and_grads(params, cfg, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                del g
                losses.append(loss)
            grads = [a.div_(num_microbatches) for a in acc]
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = _loss_and_grads(params, cfg, batch)
        new_params, new_opt = adam_update(tree_unflatten(params, grads), opt,
                                          params, adam_cfg)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits``: the full-sequence forward
    without gradients."""
    @torch.no_grad()
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        if cfg.is_encdec:
            return forward_encdec(params, cfg, batch["frames"],
                                  batch["tokens"])
        return forward_lm(params, cfg, batch["tokens"],
                          patch_embeds=batch.get("patch_embeds", None))

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, tokens, pos) -> (logits, cache)``: one
    :func:`decode_step` without gradients, the cache updated in place."""
    @torch.no_grad()
    def serve_step(params: dict, cache: dict, tokens: torch.Tensor, pos):
        return decode_step(params, cfg, cache, tokens, pos)

    return serve_step
