"""mamba2-780m [ssm] — arXiv:2405.21060 (unverified).

48L d_model=1536, attention-free (SSD blocks only, no FFN: d_ff=0),
vocab=50280 (padded to 50432), ssm_state=128, head_dim=64, expand=2
(d_inner=3072 -> 48 SSD heads), conv width 4, SSD chunk 256.
"""
from repro_torch.models.config import MAMBA, LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    num_layers=48,
    d_model=1536,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(kind=MAMBA),),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    num_layers=4,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    pattern=(LayerSpec(kind=MAMBA),),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    tie_embeddings=True,
)
