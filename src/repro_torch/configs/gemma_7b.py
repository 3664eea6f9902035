"""gemma-7b [dense] — GeGLU, head_dim=256, tied embeddings
(arXiv:2403.08295; hf).

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="geglu",
    tie_embeddings=True,
    embed_scale_by_dim=True,
    rope_theta=10_000.0,
    max_seq_len=8192,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=32, d_ff=128, vocab_size=256,
                         max_seq_len=128)
