"""mixtral-8x22b [moe] — arXiv:2401.04088 (hf).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts
top-2, sliding-window attention (4096) per spec.
"""
from repro_torch.models.config import ATTN_SWA, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec(kind=ATTN_SWA, window=4096, moe=True),),
    moe=MoEConfig(num_experts=8, top_k=2),
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_SWA, window=16, moe=True),),
    moe=MoEConfig(num_experts=4, top_k=2),
    mlp_activation="swiglu",
)
