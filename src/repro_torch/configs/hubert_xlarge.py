"""hubert-xlarge [audio] — encoder-only, w2v2 arch (arXiv:2106.07447).

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-prediction codebook).
The conv waveform frontend is a stub: input_specs() delivers precomputed
frame embeddings (d_in=512, the w2v2 feature-extractor width); the model owns
the feature projection + conv positional embedding.
"""
from ..models.config import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_kind="gelu",
    norm_kind="layernorm",
    causal=False,
    qkv_bias=True,
    max_seq_len=131_072,
    frontend=FrontendConfig(kind="audio", d_in=512),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=32, max_seq_len=128,
                         frontend=FrontendConfig(kind="audio", d_in=24))
