"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 + always-on shared expert. Chunked local attention (8192-token
chunks) 3:1 against global layers (iRoPE-style). Early-fusion multimodality
is a stub (text path exercised; vision enters as precomputed embeddings in
multimodal deployments).
"""
from repro_torch.models.config import (
    ATTN_CHUNKED,
    ATTN_FULL,
    LayerSpec,
    ModelConfig,
    MoEConfig,
)

_C = LayerSpec(kind=ATTN_CHUNKED, window=8192, moe=True)
_G = LayerSpec(kind=ATTN_FULL, moe=True)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(_C, _C, _C, _G),
    moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True),
    rope_theta=500_000.0,
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(
        LayerSpec(kind=ATTN_CHUNKED, window=16, moe=True),
        LayerSpec(kind=ATTN_CHUNKED, window=16, moe=True),
        LayerSpec(kind=ATTN_CHUNKED, window=16, moe=True),
        LayerSpec(kind=ATTN_FULL, moe=True),
    ),
    moe=MoEConfig(num_experts=4, top_k=1, shared_expert=True),
    mlp_activation="swiglu",
)
