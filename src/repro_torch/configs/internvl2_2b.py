"""internvl2-2b [vlm] — arXiv:2404.16821 (hf).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 (padded to 92672 for
TP). InternViT frontend is a STUB per spec: input_specs supplies
precomputed patch embeddings (B, 256, 1024) projected into the sequence.
Backbone is the InternLM2-style decoder (SwiGLU + RoPE).
"""
from repro_torch.models.config import (
    ATTN_FULL,
    FrontendConfig,
    LayerSpec,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="internvl2-2b",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    frontend=FrontendConfig(kind="vision", num_prefix=256, embed_dim=1024),
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=517,  # odd on purpose: exercises vocab padding
    pattern=(LayerSpec(kind=ATTN_FULL),),
    frontend=FrontendConfig(kind="vision", num_prefix=8, embed_dim=32),
    mlp_activation="swiglu",
)
