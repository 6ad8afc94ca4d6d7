"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5 family (hf).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936. QKV bias, RoPE,
SwiGLU.
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    qkv_bias=True,
    mlp_activation="swiglu",
)
