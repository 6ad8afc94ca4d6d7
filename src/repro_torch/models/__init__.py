"""The LM substrate's models; port of ``repro.models``.

Configs, layers, the Mamba2 SSD block, model assembly, the train and
prefill steps, and decoding: caches (``init_cache``; whisper's
``transformer.prefill_cross_cache``), ``decode_step`` and
``make_serve_step``, which update the cache in place. The dry-run's
``abstract_params``, sharding rules and abstract input specs are not
ported yet.
"""
from repro_torch.models.config import (
    ATTN_BIDIR,
    ATTN_CHUNKED,
    ATTN_FULL,
    ATTN_SWA,
    MAMBA,
    EncoderConfig,
    FrontendConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.models.transformer import (
    decode_step,
    encode,
    forward_encdec,
    forward_lm,
    init_cache,
    init_params,
)
from repro_torch.models.steps import (
    lm_loss,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "ATTN_BIDIR", "ATTN_CHUNKED", "ATTN_FULL", "ATTN_SWA", "MAMBA",
    "EncoderConfig", "FrontendConfig", "LayerSpec", "ModelConfig",
    "MoEConfig", "SSMConfig",
    "decode_step", "encode", "forward_encdec", "forward_lm", "init_cache",
    "init_params",
    "lm_loss", "make_prefill_step", "make_serve_step", "make_train_step",
]
