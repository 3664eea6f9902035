"""deepseek-7b [dense] — llama-arch (arXiv:2401.02954; hf).

30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    max_seq_len=32_768,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, max_seq_len=128)
