"""The model zoo's configuration schema for all 10 architectures, and the
models built from it: the dense family, mamba2 (ssm), zamba2 (hybrid),
hubert (encoder), pixtral (vlm), and deepseek-moe and deepseek-v2-lite
(moe, the latter with multi-head latent attention)."""
from .config import (FrontendConfig, HybridConfig, MLAConfig, ModelConfig,
                     MoEConfig, SSMConfig, param_count)
from .transformer import (Transformer, cache_slot_view, decode_step, encode,
                          forward, init_cache, init_params,
                          logits_from_hidden, prefill, train_loss)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "FrontendConfig", "param_count", "Transformer", "init_params", "forward",
    "prefill", "decode_step", "init_cache", "cache_slot_view",
    "logits_from_hidden", "encode", "train_loss",
]
