"""whisper-large-v3 [audio] — arXiv:2212.04356 (unverified).

32L d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866. Encoder-decoder;
conv frontend is a STUB per spec: input_specs supplies precomputed frame
embeddings (B, S, d_model). Sinusoidal positions (no RoPE), GELU MLP.
"""
from repro_torch.models.config import (
    ATTN_FULL,
    EncoderConfig,
    FrontendConfig,
    LayerSpec,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="whisper-large-v3",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    encoder=EncoderConfig(num_layers=32, max_source_len=4096),
    frontend=FrontendConfig(kind="audio", embed_dim=1280),
    use_rope=False,
    mlp_activation="gelu",
    decoder_len=448,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_FULL),),
    encoder=EncoderConfig(num_layers=2, max_source_len=64),
    frontend=FrontendConfig(kind="audio", embed_dim=64),
    use_rope=False,
    mlp_activation="gelu",
    decoder_len=16,
)
