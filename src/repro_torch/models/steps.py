"""Train, prefill and serve step builders; port of ``repro.models.steps``.

train_step: microbatched gradient accumulation (a loop over row slices,
fp32 accumulators) -> global fp32 grads -> Adam.

The parameter, batch and cache placements of the reference's sharding
policy (per leaf, the per-dimension axis tuple that ``valid_spec``
leaves) and the abstract inputs of every (arch x shape) dry-run cell
(fake tensors made in ``transformer.fake_mode()``) are the dry-run's
inputs (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import (
    DP,
    FSDP,
    TP,
    NamedSharding,
    axis_size,
    valid_spec,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, fake_mode,
                                           forward_encdec, forward_lm,
                                           init_cache)
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


# --------------------------------------------------------------------------
# Parameter / input sharding rules
# --------------------------------------------------------------------------
_COL_PARALLEL = {
    "wq", "wk", "wv", "wi", "wi_gate", "wi_up", "in_proj", "frontend_proj",
    "lm_head", "shared_wi", "shared_wi_gate", "shared_wi_up",
}
_ROW_PARALLEL = {"wo", "out_proj", "shared_wo"}
_TP_VECS = {"bq", "bk", "bv", "conv_b", "norm"}


def _base_spec(name: str, ndim_trailing: int):
    if name == "embed":
        # vocab-dim sharding: the token lookup is a local take + mask + a
        # sum over "model" (no table gather)
        return (TP, None)
    if name in _COL_PARALLEL:
        return (FSDP, TP)
    if name in _ROW_PARALLEL:
        return (TP, FSDP)
    if name == "conv_w":
        return (None, TP)
    if name in _TP_VECS:
        return (TP,)
    if name == "router":
        return (None, None)
    return ()  # replicate (ln scales, A_log, D, dt_bias, ...)


def _map_named(fn, tree: dict, *others) -> dict:
    """``fn(key, leaf, *other leaves)`` over a nested dict, the key being
    the leaf's own dict key (the reference's ``path[-1].key``)."""
    return {k: _map_named(fn, v, *(o[k] for o in others))
            if isinstance(v, dict) else fn(k, v, *(o[k] for o in others))
            for k, v in tree.items()}


def param_pspec_tree(cfg: ModelConfig, params_abstract: dict,
                     serving: bool = False) -> dict:
    """Per leaf the axis tuple of its dimensions, right-aligned: stacked
    period / expert leading axes are unsplit.

    ``serving=True`` drops the FSDP storage axis: a serving fleet has no
    optimiser state, so weights stay resident per position (TP-split
    only) and the per-step FSDP gathers disappear."""
    def spec_for(name, leaf):
        base = _base_spec(name, leaf.ndim)
        if serving:
            base = tuple(None if a == FSDP else a for a in base)
        return (None,) * (leaf.ndim - len(base)) + tuple(base)

    return _map_named(spec_for, params_abstract)


def param_shardings(cfg: ModelConfig, mesh: Mesh, params_abstract: dict,
                    serving: bool = False) -> dict:
    """Per leaf its placement on ``mesh`` (axes that do not divide
    dropped)."""
    specs = param_pspec_tree(cfg, params_abstract, serving=serving)
    return _map_named(
        lambda _, leaf, spec: NamedSharding(mesh, valid_spec(mesh, leaf.shape,
                                                             spec)),
        params_abstract, specs)


def opt_shardings(mesh: Mesh, param_sh: dict, opt_abstract: AdamState
                  ) -> AdamState:
    """Adam's moments placed as their parameters, the step replicated."""
    return AdamState(step=NamedSharding(mesh, ()), mu=param_sh, nu=param_sh)


def batch_pspec(batch_abstract: dict, mesh: Mesh) -> dict:
    """Every batch leaf split over DP on its leading (row) dimension."""
    return _map_named(
        lambda _, leaf: NamedSharding(mesh, valid_spec(
            mesh, leaf.shape, (DP,) + (None,) * (leaf.ndim - 1))),
        batch_abstract)


def cache_shardings(cfg: ModelConfig, mesh: Mesh, cache_abstract: dict
                    ) -> dict:
    """KV cache: batch over DP; KV heads over TP when they divide, else the
    sequence over TP (flash-decoding layout). Leading dim = periods."""
    tp = axis_size(mesh, TP)

    def spec_for(name, leaf):
        if name in ("k", "v", "ck", "cv"):  # (P, B, S, KV, hd)
            if cfg.num_kv_heads % tp == 0:
                spec = (None, DP, None, TP, None)
            else:
                spec = (None, DP, TP, None, None)
        elif name == "ssm":  # (P, B, NH, hd, N)
            spec = (None, DP, TP, None, None)
        elif name == "conv":  # (P, B, W-1, conv_dim)
            spec = (None, DP, None, TP)
        else:
            spec = (None, DP)
        return NamedSharding(mesh, valid_spec(mesh, leaf.shape, spec))

    return _map_named(spec_for, cache_abstract)


# --------------------------------------------------------------------------
# Abstract input specs per (arch x shape): dry-run inputs (no allocation)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Fake-tensor stand-ins for every model input of this cell (in
    ``transformer.fake_mode()``): ``{"batch": ...}`` for train and
    prefill, ``{"cache", "tokens", "pos"}`` for decode."""
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    with fake_mode():
        def leaf(dims, dtype):
            return torch.empty(dims, dtype=dtype)

        if shape.step == "train":
            if cfg.is_encdec:
                sd = cfg.decoder_len
                batch = {"frames": leaf((b, s, cfg.d_model), f32),
                         "tokens": leaf((b, sd), i32),
                         "labels": leaf((b, sd), i32),
                         "mask": leaf((b, sd), f32)}
            elif cfg.frontend.kind == "vision":
                npfx = cfg.frontend.num_prefix
                st = s - npfx
                batch = {"tokens": leaf((b, st), i32),
                         "patch_embeds": leaf((b, npfx,
                                               cfg.frontend.embed_dim), f32),
                         "labels": leaf((b, st), i32),
                         "mask": leaf((b, st), f32)}
            else:
                batch = {"tokens": leaf((b, s), i32),
                         "labels": leaf((b, s), i32),
                         "mask": leaf((b, s), f32)}
            return {"batch": batch}

        if shape.step == "prefill":
            if cfg.is_encdec:
                return {"batch": {
                    "frames": leaf((b, s, cfg.d_model), f32),
                    "tokens": leaf((b, cfg.decoder_len), i32)}}
            if cfg.frontend.kind == "vision":
                npfx = cfg.frontend.num_prefix
                return {"batch": {
                    "tokens": leaf((b, s - npfx), i32),
                    "patch_embeds": leaf((b, npfx, cfg.frontend.embed_dim),
                                         f32)}}
            return {"batch": {"tokens": leaf((b, s), i32)}}

        # decode: one token against a seq_len cache
        enc_len = min(s, cfg.encoder.max_source_len) if cfg.is_encdec else 0
        return {"cache": init_cache(cfg, b, s, enc_len=enc_len, device="cpu"),
                "tokens": leaf((b,), i32),
                "pos": leaf((), i32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec,
                   generator: torch.Generator) -> dict:
    """Real tensors matching :func:`input_specs`, on ``generator``'s
    device: int32 ids drawn in [0, vocab), float leaves N(0, 1) x 0.1, the
    mask ones and ``pos = seq_len // 2``. The draws are torch's, not the
    reference's."""
    dev = generator.device

    def fill(_, leaf):
        if leaf.dtype == torch.int32 and leaf.ndim >= 1:
            return torch.randint(0, cfg.vocab_size, tuple(leaf.shape),
                                 generator=generator, device=dev,
                                 dtype=torch.int32)
        if leaf.dtype == torch.int32:
            return torch.zeros((), dtype=torch.int32, device=dev)
        # drawn in the leaf's dtype and scaled in place: a full-size
        # decode cache is tens of GB
        return torch.randn(tuple(leaf.shape), generator=generator,
                           device=dev, dtype=leaf.dtype).mul_(0.1)

    tree = _map_named(fill, input_specs(cfg, shape))
    if "batch" in tree and "mask" in tree["batch"]:
        tree["batch"]["mask"] = torch.ones_like(tree["batch"]["mask"])
    if "pos" in tree:
        tree["pos"] = torch.tensor(shape.seq_len // 2, dtype=torch.int32,
                                   device=dev)
    return tree
