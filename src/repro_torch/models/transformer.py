"""Model assembly for all assigned architectures; port of
``repro.models.transformer``.

Parameters are nested dicts of fp32 tensors in the reference's layout:
layers are grouped into the config's repeating *pattern period*, every
leaf of a period is stacked on a leading ``num_periods`` axis, one
``block_{i}`` per pattern position, and whisper's encoder is an
``encoder`` subtree. So the reference's tree converts leaf for leaf
(``repro_torch.interop.lm_params_from_numpy``). The reference's
``lax.scan`` over periods is a loop over the leading axis, and
``cfg.remat`` checkpoints each period
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``). The
reference's ``constrain`` calls are placement hints for a device mesh;
the single-card port has no counterpart. :func:`abstract_params` is
:func:`init_params` under the process's :func:`fake_mode`: tensors with a
shape and dtype and no storage, the dry-run's counterpart of
``jax.eval_shape``.

Three entry points:
  forward_lm       decoder-only training forward (vision prefix optional)
  forward_encdec   whisper-style encoder-decoder training forward
  decode_step      one-token serve step against a KV/SSM cache, updated
                   in place
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.config import (
    ATTN_BIDIR,
    MAMBA,
    LayerSpec,
    ModelConfig,
)
from repro_torch.models.layers import (
    attention_decode,
    attention_train,
    compute_dtype,
    cross_attention_decode,
    cross_attention_train,
    mlp,
    moe_ffn,
    pos_tensor,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.models.ssm import mamba_decode, mamba_train
from repro_torch.train.adam import tree_leaves


# --------------------------------------------------------------------------
# Initialisation (random weights from an explicit generator; the tensors
# are made on the generator's device)
# --------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _full(gen: torch.Generator, shape, value: float) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=torch.float32,
                      device=gen.device)


def _dense(gen, lead, fan_in, fan_out):
    scale = 1.0 / math.sqrt(fan_in)
    return _normal(gen, lead + (fan_in, fan_out)) * scale


def _init_attn(gen, cfg: ModelConfig, lead: tuple) -> dict:
    d = cfg.d_model
    p = {
        "ln": _full(gen, lead + (d,), 0.0),
        "wq": _dense(gen, lead, d, cfg.q_dim),
        "wk": _dense(gen, lead, d, cfg.kv_dim),
        "wv": _dense(gen, lead, d, cfg.kv_dim),
        "wo": _dense(gen, lead, cfg.q_dim, d),
    }
    if cfg.qkv_bias:
        p["bq"] = _full(gen, lead + (cfg.q_dim,), 0.0)
        p["bk"] = _full(gen, lead + (cfg.kv_dim,), 0.0)
        p["bv"] = _full(gen, lead + (cfg.kv_dim,), 0.0)
    return p


def _init_ffn(gen, cfg: ModelConfig, lead: tuple,
              d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"ln": _full(gen, lead + (d,), 0.0)}
    if cfg.mlp_activation == "swiglu":
        p["wi_gate"] = _dense(gen, lead, d, f)
        p["wi_up"] = _dense(gen, lead, d, f)
        p["wo"] = _dense(gen, lead, f, d)
    else:
        p["wi"] = _dense(gen, lead, d, f)
        p["wo"] = _dense(gen, lead, f, d)
    return p


def _init_moe(gen, cfg: ModelConfig, lead: tuple) -> dict:
    moe = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, moe.num_experts
    p = {
        "ln": _full(gen, lead + (d,), 0.0),
        "router": _normal(gen, lead + (d, e)) * (1.0 / math.sqrt(d)),
    }
    if cfg.mlp_activation == "swiglu":
        p["wi_gate"] = _dense(gen, lead + (e,), d, f)
        p["wi_up"] = _dense(gen, lead + (e,), d, f)
        p["wo"] = _dense(gen, lead + (e,), f, d)
    else:
        p["wi"] = _dense(gen, lead + (e,), d, f)
        p["wo"] = _dense(gen, lead + (e,), f, d)
    if moe.shared_expert:
        for k2, v in _init_ffn(gen, cfg, lead).items():
            if k2 != "ln":
                p["shared_" + k2] = v
    return p


def _init_mamba(gen, cfg: ModelConfig, lead: tuple) -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    d_in = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    conv_dim = d_in + 2 * ssm.d_state
    d_proj = 2 * d_in + 2 * ssm.d_state + nh
    u = torch.rand(lead + (nh,), generator=gen, device=gen.device,
                   dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a_log = torch.log(1.0 + torch.arange(nh, dtype=torch.float32,
                                         device=gen.device))  # A in [-1, -nh]
    return {
        "ln": _full(gen, lead + (d,), 0.0),
        "in_proj": _dense(gen, lead, d, d_proj),
        "conv_w": _normal(gen, lead + (ssm.conv_width, conv_dim))
        / math.sqrt(ssm.conv_width),
        "conv_b": _full(gen, lead + (conv_dim,), 0.0),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D": _full(gen, lead + (nh,), 1.0),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": _full(gen, lead + (d_in,), 0.0),
        "out_proj": _dense(gen, lead, d_in, d),
    }


def _init_block(gen, cfg: ModelConfig, spec: LayerSpec, cross: bool,
                lead: tuple) -> dict:
    blk = {}
    if spec.kind == MAMBA:
        blk["mamba"] = _init_mamba(gen, cfg, lead)
    else:
        blk["attn"] = _init_attn(gen, cfg, lead)
    if cross:
        blk["cross"] = _init_attn(gen, cfg, lead)
    if cfg.d_ff > 0:
        blk["ffn"] = (_init_moe(gen, cfg, lead) if (spec.moe and cfg.moe)
                      else _init_ffn(gen, cfg, lead))
    return blk


def _init_period(gen, cfg: ModelConfig, cross: bool, lead: tuple) -> dict:
    return {
        f"block_{i}": _init_block(gen, cfg, spec, cross, lead)
        for i, spec in enumerate(cfg.pattern)
    }


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters in the reference's layout, on ``generator``'s
    device (the draws are torch's, not the reference's)."""
    params = _init_params_f32(generator, cfg, cfg.padded_vocab)
    if cfg.param_dtype == "bfloat16":
        # bf16 parameter storage (fp32 Adam moments remain the master
        # statistics; adam_update computes in fp32 and casts back).
        params = _tree_map(lambda a: a.to(torch.bfloat16), params)
    return params


_FAKE_MODE = None


def fake_mode():
    """The process's ``FakeTensorMode`` (made at first use): every abstract
    tree of the dry-run is made in it, so trees made apart combine."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE_MODE = FakeTensorMode()
    return _FAKE_MODE


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as fake tensors (no allocation): dry-run input."""
    with fake_mode():
        return init_params(torch.Generator().manual_seed(0), cfg)


def _init_params_f32(gen, cfg: ModelConfig, vp: int) -> dict:
    params = {
        "embed": _normal(gen, (vp, cfg.d_model)) * 0.02,
        "final_ln": _full(gen, (cfg.d_model,), 0.0),
        "layers": _init_period(gen, cfg, cfg.is_encdec, (cfg.num_periods,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (), cfg.d_model, vp)
    if cfg.frontend.kind == "vision":
        params["frontend_proj"] = _dense(gen, (), cfg.frontend.embed_dim,
                                         cfg.d_model)
    if cfg.is_encdec:
        enc_spec = LayerSpec(kind=ATTN_BIDIR)
        params["encoder"] = {
            "frontend_proj": _dense(gen, (), cfg.d_model, cfg.d_model),
            "final_ln": _full(gen, (cfg.d_model,), 0.0),
            "layers": {"block_0": _init_block(
                gen, cfg, enc_spec, False, (cfg.encoder.num_layers,))},
        }
    return params


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# Train forward
# --------------------------------------------------------------------------
def _apply_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 spec: LayerSpec, positions: torch.Tensor,
                 enc: Optional[torch.Tensor]) -> torch.Tensor:
    if spec.kind == MAMBA:
        x = x + mamba_train(params["mamba"],
                            rms_norm(x, params["mamba"]["ln"], cfg.norm_eps),
                            cfg)
    else:
        x = x + attention_train(
            params["attn"], rms_norm(x, params["attn"]["ln"], cfg.norm_eps),
            cfg, spec, positions)
    if enc is not None and "cross" in params:
        x = x + cross_attention_train(
            params["cross"], rms_norm(x, params["cross"]["ln"], cfg.norm_eps),
            enc, cfg)
    if "ffn" in params:
        h = rms_norm(x, params["ffn"]["ln"], cfg.norm_eps)
        if spec.moe and cfg.moe is not None:
            x = x + moe_ffn(params["ffn"], h, cfg)
        else:
            x = x + mlp(params["ffn"], h, cfg)
    return x


def _unstack(stacked: dict, count: int) -> list:
    """The period-stacked tree as ``count`` per-period trees (one
    ``unbind`` per leaf, so each leaf's gradient is stacked once)."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in parts} for i in range(count)]
        return torch.unbind(node, dim=0)

    return split(stacked)


def _dots_policy():
    """Selective checkpoint saving unbatched matmul outputs (the
    reference's ``checkpoint_dots_with_no_batch_dims``)."""
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _run_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig,
               pattern: tuple, positions: torch.Tensor,
               enc: Optional[torch.Tensor]) -> torch.Tensor:
    def period_body(h, period_params, enc_in):
        for i, spec in enumerate(pattern):
            h = _apply_block(period_params[f"block_{i}"], h, cfg, spec,
                             positions, enc_in)
        return h

    count = tree_leaves(stacked)[0].shape[0]
    for period_params in _unstack(stacked, count):
        if cfg.remat and torch.is_grad_enabled():
            kwargs = ({"context_fn": _dots_policy}
                      if cfg.remat_policy == "dots" else {})
            x = checkpoint(period_body, x, period_params, enc,
                           use_reentrant=False, **kwargs)
        else:
            x = period_body(x, period_params, enc)
    return x


def _head(params: dict) -> torch.Tensor:
    head = params.get("lm_head", None)
    return params["embed"].T if head is None else head


def forward_lm(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decoder-only LM forward -> logits (B, S_total, padded_vocab)."""
    x = F.embedding(tokens.long(), params["embed"]).to(compute_dtype(cfg))
    if patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params["frontend_proj"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if not cfg.use_rope:
        x = x + sinusoidal_positions(s, cfg.d_model, x.dtype, x.device)[None]
    x = _run_stack(params["layers"], x, cfg, cfg.pattern, positions, None)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ _head(params).to(x.dtype)


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (B, T, D)."""
    enc_p = params["encoder"]
    cd = compute_dtype(cfg)
    x = frames.to(cd) @ enc_p["frontend_proj"].to(cd)
    t = x.shape[1]
    x = x + sinusoidal_positions(t, cfg.d_model, x.dtype, x.device)[None]
    x = _run_stack(enc_p["layers"], x, cfg, (LayerSpec(kind=ATTN_BIDIR),),
                   torch.arange(t, device=x.device), None)
    return rms_norm(x, enc_p["final_ln"], cfg.norm_eps)


def forward_encdec(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder training forward -> decoder logits."""
    enc = encode(params, cfg, frames)
    x = F.embedding(tokens.long(), params["embed"]).to(enc.dtype)
    s = x.shape[1]
    x = x + sinusoidal_positions(s, cfg.d_model, x.dtype, x.device)[None]
    x = _run_stack(params["layers"], x, cfg, cfg.pattern,
                   torch.arange(s, device=x.device), enc)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ _head(params).to(x.dtype)


# --------------------------------------------------------------------------
# Decode (serving)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Per-period stacked cache tree of zeros on ``device``: per pattern
    position ``block_{i}``, attention ``k``/``v`` (P, B, L, KV, hd) with
    ``L = min(window, max_len)`` for windowed layers (ring buffers), or
    Mamba ``conv`` (P, B, W-1, conv_dim) in ``dtype`` and ``ssm`` (P, B,
    NH, HD, N) in fp32; encoder-decoder configs add ``ck``/``cv`` (P, B,
    enc_len, KV, hd)."""
    p = cfg.num_periods
    kv, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    period = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == MAMBA:
            ssm = cfg.ssm
            conv_dim = ssm.d_inner(cfg.d_model) + 2 * ssm.d_state
            blk = {
                "conv": zeros((p, batch, ssm.conv_width - 1, conv_dim)),
                "ssm": zeros((p, batch, ssm.num_heads(cfg.d_model),
                              ssm.head_dim, ssm.d_state), torch.float32),
            }
        else:
            length = max_len
            if spec.kind in ("swa", "chunked") and spec.window > 0:
                length = min(spec.window, max_len)
            blk = {"k": zeros((p, batch, length, kv, hd)),
                   "v": zeros((p, batch, length, kv, hd))}
        if cfg.is_encdec:
            blk["ck"] = zeros((p, batch, enc_len, kv, hd))
            blk["cv"] = zeros((p, batch, enc_len, kv, hd))
        period[f"block_{i}"] = blk
    return period


def prefill_cross_cache(params: dict, cfg: ModelConfig,
                        frames: torch.Tensor, cache: dict) -> dict:
    """Encode source frames and fill the decoder cross-attention K/V cache
    (whisper serving prefill), period by period, in place; returns
    ``cache``."""
    enc = encode(params, cfg, frames)  # (B, T, D)
    b, t, _ = enc.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    count = cfg.num_periods
    for p, period_params in enumerate(_unstack(params["layers"], count)):
        for i in range(len(cfg.pattern)):
            cross = period_params[f"block_{i}"]["cross"]
            blk_c = cache[f"block_{i}"]
            for name, wname in (("ck", "wk"), ("cv", "wv")):
                val = enc @ cross[wname].to(enc.dtype)
                blk_c[name][p].copy_(val.reshape(b, t, kv, hd))
    return cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos) -> tuple:
    """One serving step: next-token logits (B, padded_vocab) in fp32, and
    the cache.

    ``tokens``: (B,) current ids; ``pos``: the position, a Python int or a
    0-d integer tensor (never read back to the host). Every layer writes
    its new K/V slot, conv window and SSM state into the caller's cache
    tensors in place (the reference donates the cache), and the returned
    cache is the same dict: clone it first to keep the state before a
    step.
    """
    x = F.embedding(tokens.long(), params["embed"])[:, None, :].to(
        compute_dtype(cfg))
    pos = pos_tensor(pos, x.device)
    if not cfg.use_rope:
        x = x + _sinusoidal_at(pos, cfg.d_model, x.dtype)[None, None, :]
    count = cfg.num_periods
    for period_params, period_cache in zip(_unstack(params["layers"], count),
                                           _unstack(cache, count)):
        x = _decode_period(period_params, period_cache, x, pos, cfg)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, 0, :] @ _head(params).to(x.dtype)).float()
    return logits, cache


def _decode_period(period_params: dict, period_cache: dict, x: torch.Tensor,
                   pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One period of :func:`decode_step`: each block's one-token step
    against its slice of the cache (written in place)."""
    for i, spec in enumerate(cfg.pattern):
        blk_p = period_params[f"block_{i}"]
        blk_c = period_cache[f"block_{i}"]
        if spec.kind == MAMBA:
            y, _ = mamba_decode(
                blk_p["mamba"],
                rms_norm(x, blk_p["mamba"]["ln"], cfg.norm_eps), blk_c, cfg)
        else:
            y, _ = attention_decode(
                blk_p["attn"],
                rms_norm(x, blk_p["attn"]["ln"], cfg.norm_eps), blk_c, pos,
                cfg, spec)
        x = x + y
        if cfg.is_encdec and "cross" in blk_p:
            x = x + cross_attention_decode(
                blk_p["cross"],
                rms_norm(x, blk_p["cross"]["ln"], cfg.norm_eps), blk_c, cfg)
        if "ffn" in blk_p:
            z = rms_norm(x, blk_p["ffn"]["ln"], cfg.norm_eps)
            if spec.moe and cfg.moe is not None:
                x = x + moe_ffn(blk_p["ffn"], z, cfg)
            else:
                x = x + mlp(blk_p["ffn"], z, cfg)
    return x


def _sinusoidal_at(pos: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """Row ``pos`` of ``sinusoidal_positions(., dim)``, from a 0-d tensor."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    angles = pos.float() / torch.pow(10_000.0, 2.0 * i / dim)
    return torch.cat([torch.sin(angles), torch.cos(angles)]).to(dtype)
