"""Model configuration for the assigned architecture pool.

Port of ``repro.models.config``, field for field and default for default
(the reference module imports no JAX, but the port keeps its own copy).
One `ModelConfig` describes any of the 10 assigned LM-family architectures:
dense / GQA transformers, sliding-window & local:global & chunked-local
attention variants, MoE (top-k with optional shared expert), Mamba2 SSD
blocks and hybrid interleavings, encoder-decoder (Whisper), and stubbed
audio/vision frontends (per spec the modality frontend supplies precomputed
frame/patch embeddings).

Layer heterogeneity is expressed as a *pattern*: a period of `LayerSpec`s
repeated `num_layers / len(pattern)` times. Parameters of a period are
stacked on a leading axis and the model loops over periods (true
interleaving order preserved).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Attention kinds
ATTN_FULL = "full"  # causal full attention
ATTN_SWA = "swa"  # sliding-window causal
ATTN_CHUNKED = "chunked"  # causal within fixed chunks (llama4-style local)
ATTN_BIDIR = "bidir"  # encoder (non-causal) attention
MAMBA = "mamba"  # Mamba2 SSD block (attention-free)


@dataclass(frozen=True)
class LayerSpec:
    kind: str = ATTN_FULL  # full | swa | chunked | mamba
    window: int = 0  # swa window / chunk size (tokens)
    moe: bool = False  # MoE FFN instead of dense FFN


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length (train path)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (self-attention only, bidirectional)."""

    num_layers: int = 32
    # Decoder cross-attends to the encoded sequence; the conv frontend is a
    # stub (identity-shaped linear) fed precomputed frame embeddings.
    max_source_len: int = 4096


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: precomputed embeddings enter via input_specs."""

    kind: str = "none"  # none | audio | vision
    num_prefix: int = 0  # vision: patches prepended to the text sequence
    embed_dim: int = 0  # incoming embedding dim (projected to d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab_size: int = 32_000
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True  # False -> sinusoidal absolute positions (whisper)
    norm_eps: float = 1e-5
    mlp_activation: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    decoder_len: int = 448  # enc-dec only: decoder text length in training
    # Numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # MoE combine: one fused scatter-add over all experts (True) vs one
    # read-modify-write per expert (False; the naive baseline — E x the
    # combine HBM traffic, kept for the §Perf A/B).
    moe_single_scatter: bool = True
    # Rematerialisation policy for the period loop body:
    #   "full" — save only period boundaries, recompute everything (min
    #            memory, +1 forward of flops AND weight re-reads in bwd)
    #   "dots" — save the outputs of unbatched matmuls (a selective
    #            checkpoint), skip their recompute at the cost of
    #            activation memory
    remat_policy: str = "full"

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (TP divisibility; Megatron rule)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def num_periods(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern period {len(self.pattern)}"
        )
        return self.num_layers // len(self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def has_subquadratic_path(self) -> bool:
        """True unless the arch is PURE full attention — hybrids (jamba,
        llama4, gemma3) and SSM/windowed archs run long_500k; the few full
        layers they retain are O(S) per decoded token, which is the shape's
        point (DESIGN.md §5 skip rule)."""
        return any(
            spec.kind in (MAMBA, ATTN_SWA, ATTN_CHUNKED)
            for spec in self.pattern
        )

    def active_params_per_token_layers(self) -> int:
        """Approximate ACTIVE parameter count (MoE counts top_k+shared experts
        only) — used for MODEL_FLOPS = 6 * N_active * D in the roofline."""
        n = 0
        # embeddings (counted once, not per layer here)
        n += self.padded_vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            per = 0
            if spec.kind == MAMBA:
                ssm = self.ssm
                d_in = ssm.d_inner(self.d_model)
                nh = ssm.num_heads(self.d_model)
                d_proj = 2 * d_in + 2 * ssm.d_state + nh
                per += self.d_model * d_proj  # in_proj
                per += d_in * self.d_model  # out_proj
                per += ssm.conv_width * (d_in + 2 * ssm.d_state)  # conv
            else:
                per += self.d_model * (self.q_dim + 2 * self.kv_dim)
                per += self.q_dim * self.d_model
            # FFN
            mults = 3 if self.mlp_activation == "swiglu" else 2
            if spec.moe and self.moe is not None:
                active = self.moe.top_k + (1 if self.moe.shared_expert else 0)
                per += active * mults * self.d_model * self.d_ff
                per += self.d_model * self.moe.num_experts  # router
            elif self.d_ff > 0:
                per += mults * self.d_model * self.d_ff
            n += per * self.num_periods
        if self.is_encdec:
            # encoder layers: self-attn + dense FFN each; cross-attn in decoder
            enc_per = self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model
            mults = 3 if self.mlp_activation == "swiglu" else 2
            enc_per += mults * self.d_model * self.d_ff
            n += enc_per * self.encoder.num_layers
            n += self.num_layers * (
                self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model
            )  # cross-attention blocks
        return n

    def total_params(self) -> int:
        """Approximate TOTAL parameter count (all experts)."""
        if self.moe is None:
            return self.active_params_per_token_layers()
        base = dataclasses.replace(
            self,
            moe=MoEConfig(
                num_experts=self.moe.num_experts,
                top_k=self.moe.num_experts,  # count all experts
                shared_expert=self.moe.shared_expert,
            ),
        )
        return base.active_params_per_token_layers()
