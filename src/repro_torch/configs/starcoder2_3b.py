"""starcoder2-3b [dense] — arXiv:2402.19173 (hf).

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. GQA, RoPE,
GELU MLP with QKV bias (starcoder2 style).
"""
from repro_torch.models.config import ATTN_FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    qkv_bias=True,
    mlp_activation="gelu",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    qkv_bias=True,
    mlp_activation="gelu",
)
