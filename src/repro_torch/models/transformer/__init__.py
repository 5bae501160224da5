from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import (
    KVCache,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    lm_loss,
    logits_from_hidden,
    prefill,
)

__all__ = [
    "TransformerConfig",
    "KVCache",
    "decode_step",
    "forward_hidden",
    "init_cache",
    "init_params",
    "lm_loss",
    "logits_from_hidden",
    "prefill",
]
