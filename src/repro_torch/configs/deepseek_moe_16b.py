"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
(arXiv:2401.06066; hf).

28L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=102400; layer 0 keeps
a dense FFN (width 10944, per the released checkpoint).
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    max_seq_len=32_768,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  first_dense_layers=1, d_ff_dense=10944),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256, max_seq_len=128,
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=96,
                      capacity_factor=4.0,  # drop-free at smoke scale
                      first_dense_layers=1, d_ff_dense=192))
