"""zamba2-2.7b [hybrid] — Mamba2 backbone + one shared attention block
applied every 6 layers on concat(hidden, embedding) (arXiv:2411.15242; hf).

54L d_model=2560 32H d_ff=10240 vocab=32000, ssm_state=64.
"""
from ..models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp_kind="geglu",
    tie_embeddings=True,
    max_seq_len=1_048_576,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    hybrid=HybridConfig(period=6, shared_n_heads=32, shared_d_ff=10240),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, max_seq_len=128,
                         ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                       head_dim=16, n_groups=1, chunk=16),
                         hybrid=HybridConfig(period=2, shared_n_heads=4,
                                             shared_d_ff=128))
