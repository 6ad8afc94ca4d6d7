"""gemma3-4b [dense] — hf:google/gemma-3-1b-pt family (unverified).

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144,
~5:1 local(1024-window SWA):global interleave, 128k context class.

34 layers = 2 periods of 17 with globals at in-period indices 5, 11, 16
(30 local : 4 global per period pair -> 28:6 over the checkpoint-faithful
ordering; documented approximation of the 5:1 rule at 34 layers).
"""
from repro_torch.models.config import ATTN_FULL, ATTN_SWA, LayerSpec, ModelConfig

_L = LayerSpec(kind=ATTN_SWA, window=1024)
_G = LayerSpec(kind=ATTN_FULL)
_PATTERN = (_L,) * 5 + (_G,) + (_L,) * 5 + (_G,) + (_L,) * 4 + (_G,)

CONFIG = ModelConfig(
    name="gemma3-4b",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=_PATTERN,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(kind=ATTN_SWA, window=8),) * 5
    + (LayerSpec(kind=ATTN_FULL),),
    mlp_activation="swiglu",
)
