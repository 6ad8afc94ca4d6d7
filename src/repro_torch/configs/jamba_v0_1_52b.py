"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887 (hf).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba+attention 1:7 interleave (one attention layer per 8-layer Jamba
block, at index 4), MoE every other layer.
"""
from repro_torch.models.config import (
    ATTN_FULL,
    MAMBA,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

_PATTERN = tuple(
    LayerSpec(
        kind=ATTN_FULL if i == 4 else MAMBA,
        moe=(i % 2 == 1),
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=256),
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=_PATTERN,
    moe=MoEConfig(num_experts=4, top_k=2),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    mlp_activation="swiglu",
)
