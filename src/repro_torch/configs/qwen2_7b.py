"""qwen2-7b [dense] — GQA with QKV bias (arXiv:2407.10671; hf).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=56, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, max_seq_len=128)
