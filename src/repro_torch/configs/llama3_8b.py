"""llama3-8b [dense] — arXiv:2407.21783 (unverified).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. RoPE, SwiGLU.
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    rope_theta=500_000.0,
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    mlp_activation="swiglu",
)
