"""Transformer building blocks shared by the 10 assigned architectures; port
of ``repro.models.layers``. Every block has a train path (full sequence)
and, for attention, a decode path (one token against a cache).

Pure functions over nested-dict parameter trees (fp32 storage, compute in
``cfg.compute_dtype``). Each block casts where the reference casts: the
block input to the compute dtype, weights at each use, RMS norms and the
MoE router in fp32, attention scores in fp32 from compute-dtype operands
(the reference's ``preferred_element_type=float32``; upcasting ``q`` and
``k`` gives the same products), probabilities back to ``v``'s dtype.

The reference's ``constrain`` calls are placement hints for a device
mesh; the port's blocks make none (the dry-run reads placements from the
policy). :func:`_tp_size` is the reference's: the "model" axis of the
global mesh, which picks head- or sequence-parallel attention in the
dry-run's accounting.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import TP, axis_size, get_global_mesh
from repro_torch.models.config import (
    ATTN_BIDIR,
    ATTN_CHUNKED,
    ATTN_SWA,
    LayerSpec,
    ModelConfig,
)

NEG_INF = -1e30


def _tp_size() -> int:
    """Positions along "model" of the global mesh (1 without one)."""
    mesh = get_global_mesh()
    return axis_size(mesh, TP) if mesh is not None else 1


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activations' dtype: bf16 when ``cfg.compute_dtype`` says so."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _to_compute(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``x.astype(bf16) if compute is bf16 else x``."""
    return x.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" else x


# --------------------------------------------------------------------------
# Normalisation, positions
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMS norm in fp32 with a ``1 + scale`` gain, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # A Python base: a tensor made from it on the card would be a
    # host-to-device copy, which synchronises (once per layer at decode).
    freq = 1.0 / torch.pow(float(theta), exponent)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(seq_len, dim) absolute positions: [sin | cos] of pos / 1e4^(2i/dim)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / torch.pow(10_000.0, 2.0 * i / dim)
    emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return emb.to(dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _attn_mask(seq_len: int, kind: str, window: int, dtype=torch.float32,
               device=None) -> Optional[torch.Tensor]:
    """(S, S) additive mask for the train path (None = no masking)."""
    if kind == ATTN_BIDIR:
        return None
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    allowed = j <= i  # causal
    if kind == ATTN_SWA and window > 0:
        allowed &= (i - j) < window
    elif kind == ATTN_CHUNKED and window > 0:
        allowed &= (i // window) == (j // window)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(allowed, zero, torch.full((), NEG_INF, dtype=dtype,
                                                 device=device))


def _gqa_scores_and_out(q, k, v, mask, scale):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd). Returns (B,S,H,hd).

    Scores are fp32 from fp32 copies of q and k (exact products of bf16
    operands), as the reference's fp32-accumulated einsum; probabilities
    are cast to ``v``'s dtype before the second product. ``mask`` is
    additive and broadcasts against (G, S, T).

    One KV head at a time, with its G query heads folded into the rows:
    (B, G*S, hd) against that head's (B, T, hd) slice of k and v, which
    are strided views that a batched GEMM on the card reads in place. No
    tensor carries a broadcast group axis (``matmul`` would materialise
    K and V G times over), and the fp32 copy of K is one head's at a
    time: at llama3-8b's decode_32k 2.15 GB instead of 17.18 GB a layer.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    outs = []
    for j in range(kv):
        qj = q[:, :, j * g:(j + 1) * g].float().permute(0, 2, 1, 3)
        qj = qj.reshape(b, g * s, hd)  # rows (g, s)
        scores = torch.matmul(qj, k[:, :, j].float().transpose(1, 2))
        scores = scores.view(b, g, s, t) * scale  # (B,G,S,T) fp32
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.matmul(probs.view(b, g * s, t), v[:, :, j]))
    out = torch.stack(outs, dim=1).view(b, kv, g, s, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def attention_train(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    spec: LayerSpec, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (GQA) attention; x: (B, S, D)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = _to_compute(x, cfg)

    def w(name):
        return params[name].to(xc.dtype)

    q = xc @ w("wq")
    k = xc @ w("wk")
    v = xc @ w("wv")
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    mask = _attn_mask(s, spec.kind, spec.window, dtype=torch.float32,
                      device=x.device)
    out = _gqa_scores_and_out(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = out.reshape(b, s, h * hd)
    return (out @ w("wo")).to(x.dtype)


def cross_attention_train(params: dict, x: torch.Tensor, enc: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention (whisper); x: (B,S,D), enc: (B,T,D)."""
    b, s, _ = x.shape
    t = enc.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = _to_compute(x, cfg)
    ec = enc.to(xc.dtype)

    def w(name):
        return params[name].to(xc.dtype)

    q = (xc @ w("wq")).reshape(b, s, h, hd)
    k = (ec @ w("wk")).reshape(b, t, kv, hd)
    v = (ec @ w("wv")).reshape(b, t, kv, hd)
    out = _gqa_scores_and_out(q, k, v, None, 1.0 / math.sqrt(hd))
    return (out.reshape(b, s, h * hd) @ w("wo")).to(x.dtype)


def pos_tensor(pos, device) -> torch.Tensor:
    """A decode position (a Python int or a 0-d integer tensor) as a 0-d
    int64 tensor on ``device``: an int is filled in on the device, so no
    host-to-device copy and no synchronise."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), pos, dtype=torch.int64, device=device)


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, spec: LayerSpec) -> tuple:
    """One-token GQA step. x: (B, 1, D); cache {"k", "v"}: (B, S_max, KV,
    hd); pos: the token's index (an int or a 0-d integer tensor).

    The new K/V row is written into the caller's cache tensors in place
    (the reference donates its cache; a functional copy of llama3-8b's
    decode_32k cache would be another 34.4 GB) and ``(y, cache)`` returns
    those same tensors. Windowed layers (SWA or chunked, ``window > 0``,
    ``S_max <= window``) are ring buffers: slot ``pos % S_max``. Any other
    slot is ``pos`` clamped to ``S_max - 1``, as ``dynamic_update_slice``
    clamps its start. Masks: slots ``j <= pos``; every slot once an SWA
    ring is full; under chunked attention ``j <= pos % S_max``.
    """
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[1]
    pos = pos_tensor(pos, x.device)
    xc = _to_compute(x, cfg)

    def w(name):
        return params[name].to(xc.dtype)

    q = xc @ w("wq")
    k_new = xc @ w("wk")
    v_new = xc @ w("wv")
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k_new = k_new + params["bk"].to(k_new.dtype)
        v_new = v_new + params["bv"].to(v_new.dtype)
    q = q.reshape(b, 1, h, hd)
    k_new = k_new.reshape(b, 1, kv, hd)
    v_new = v_new.reshape(b, 1, kv, hd)
    if cfg.use_rope:
        q = rope(q, pos.reshape(1), cfg.rope_theta)
        k_new = rope(k_new, pos.reshape(1), cfg.rope_theta)

    windowed = (spec.kind in (ATTN_SWA, ATTN_CHUNKED) and spec.window > 0
                and s_max <= spec.window)
    slot = torch.clamp(pos % s_max if windowed else pos, 0, s_max - 1)
    k_cache.index_copy_(1, slot.reshape(1), k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot.reshape(1), v_new.to(v_cache.dtype))

    j = torch.arange(s_max, device=x.device)
    if not windowed:
        valid = j <= pos
    elif spec.kind == ATTN_SWA:
        # every written slot is inside the sliding window by construction
        valid = (j <= pos) | (pos >= s_max)
    else:  # chunked: only slots written in the current chunk
        valid = j <= pos % s_max
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    out = _gqa_scores_and_out(q, k_cache, v_cache, mask, 1.0 / math.sqrt(hd))
    # JAX promotes a bf16 output (bf16 cache) against fp32 weights to fp32
    dt = torch.promote_types(out.dtype, xc.dtype)
    y = (out.reshape(b, 1, h * hd).to(dt) @ w("wo").to(dt)).to(x.dtype)
    return y, {"k": k_cache, "v": v_cache}


def cross_attention_decode(params: dict, x: torch.Tensor, cache: dict,
                           cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (whisper decode);
    x: (B, 1, D), cache {"ck", "cv"}: (B, T_enc, KV, hd)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    xc = _to_compute(x, cfg)

    def w(name):
        return params[name].to(xc.dtype)

    q = (xc @ w("wq")).reshape(b, 1, h, hd)
    out = _gqa_scores_and_out(q, cache["ck"].to(xc.dtype),
                              cache["cv"].to(xc.dtype), None,
                              1.0 / math.sqrt(hd))
    return (out.reshape(b, 1, h * hd) @ w("wo")).to(x.dtype)


# --------------------------------------------------------------------------
# FFN: dense + MoE
# --------------------------------------------------------------------------
def _ffn_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (..., D) -> (..., D), weights fetched from p (fp32->compute dtype).

    GELU is the tanh approximation, ``jax.nn.gelu``'s default."""
    def w(name):
        return p[name].to(x.dtype)

    if activation == "swiglu":
        g = F.silu(x @ w("wi_gate"))
        u = x @ w("wi_up")
        return (g * u) @ w("wo")
    hid = F.gelu(x @ w("wi"), approximate="tanh")
    return hid @ w("wo")


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense FFN in the compute dtype, cast back to x's dtype."""
    return _ffn_apply(params, _to_compute(x, cfg), cfg.mlp_activation).to(
        x.dtype)


def top_k_ordered(values: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties
    broken towards the lower index (XLA's TopK order; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE with static per-expert capacity (loop-over-experts dispatch).

    Each expert gathers its top-C tokens by combine weight and scatter-adds
    its output. Capacity C = ceil(S * top_k * cf / E); lower-weight overflow
    tokens are dropped, and among equal weights (every routed token weighs
    1.0 under top-1) the later positions go first, as in the reference.
    Expert FFN weights are stacked (E, D, F).
    """
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    xc = _to_compute(x, cfg)

    router_logits = xc.float() @ params["router"].float()  # (B,S,E) fp32
    probs = torch.softmax(router_logits, dim=-1)
    top_vals, top_idx = top_k_ordered(probs, k)  # (B,S,k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)

    # Per-expert combine weight (B,S): sum of top-k weights routed to e.
    onehot = F.one_hot(top_idx, e).float()  # (B,S,k,E)
    combine = torch.einsum("bske,bsk->bse", onehot, top_vals)  # (B,S,E)

    cap = max(1, int(math.ceil(s * k * moe.capacity_factor / e)))
    cap = min(cap, s)
    batch_ix = torch.arange(b, device=x.device)[:, None]
    outs, idxs = [], []
    for ei in range(e):
        scores, idx = top_k_ordered(combine[:, :, ei], cap)  # (B,C)
        xg = torch.gather(xc, 1, idx[:, :, None].expand(b, cap, d))  # (B,C,D)
        pe = {key: params[key][ei] for key in params
              if key.startswith("wi") or key == "wo"}
        out = _ffn_apply(pe, xg, cfg.mlp_activation)  # (B,C,D)
        outs.append(out * scores[:, :, None].to(out.dtype))
        idxs.append(idx)
    y = torch.zeros((b, s, d), dtype=xc.dtype, device=x.device)
    if cfg.moe_single_scatter:
        # One combined scatter-add over all experts' outputs.
        all_out = torch.cat(outs, dim=1)  # (B, E*C, D)
        all_idx = torch.cat(idxs, dim=1)  # (B, E*C)
        y = torch.index_put(y, (batch_ix, all_idx), all_out, accumulate=True)
    else:  # naive per-expert combine (the reference's A/B baseline)
        for out, idx in zip(outs, idxs):
            y = torch.index_put(y, (batch_ix, idx), out, accumulate=True)
    if moe.shared_expert:
        shared = {key[7:]: params[key] for key in params
                  if key.startswith("shared_")}
        y = y + _ffn_apply(shared, xc, cfg.mlp_activation)
    return y.to(x.dtype)
