"""The LM substrate's models; port of ``repro.models``.

Configs, layers, the Mamba2 SSD block, model assembly, the train and
prefill steps, and decoding: caches (``init_cache``; whisper's
``transformer.prefill_cross_cache``), ``decode_step`` and
``make_serve_step``, which update the cache in place; and the dry-run's
inputs: ``abstract_params``, the sharding rules and the abstract input
specs.
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
    abstract_params,
    decode_step,
    encode,
    forward_encdec,
    forward_lm,
    init_cache,
    init_params,
)
from repro_torch.models.steps import (
    batch_pspec,
    cache_shardings,
    concrete_batch,
    input_specs,
    lm_loss,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    param_pspec_tree,
    param_shardings,
)

__all__ = [
    "ATTN_BIDIR", "ATTN_CHUNKED", "ATTN_FULL", "ATTN_SWA", "MAMBA",
    "EncoderConfig", "FrontendConfig", "LayerSpec", "ModelConfig",
    "MoEConfig", "SSMConfig",
    "abstract_params", "decode_step", "encode", "forward_encdec",
    "forward_lm", "init_cache", "init_params",
    "batch_pspec", "cache_shardings", "concrete_batch", "input_specs",
    "lm_loss", "make_prefill_step", "make_serve_step", "make_train_step",
    "param_pspec_tree", "param_shardings",
]
