"""The LM substrate's models, train half; port of ``repro.models``.

Configs, layers, the Mamba2 SSD block, model assembly and the train and
prefill steps. Decoding (caches, ``decode_step``, ``make_serve_step``) and
the dry-run's sharding rules and abstract input specs are not ported yet.
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
    encode,
    forward_encdec,
    forward_lm,
    init_params,
)
from repro_torch.models.steps import (
    lm_loss,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "ATTN_BIDIR", "ATTN_CHUNKED", "ATTN_FULL", "ATTN_SWA", "MAMBA",
    "EncoderConfig", "FrontendConfig", "LayerSpec", "ModelConfig",
    "MoEConfig", "SSMConfig",
    "encode", "forward_encdec", "forward_lm", "init_params",
    "lm_loss", "make_prefill_step", "make_train_step",
]
