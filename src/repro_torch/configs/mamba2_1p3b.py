"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060).

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128, head_dim=64, expand=2.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    max_seq_len=1_048_576,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, vocab_size=256,
                         max_seq_len=128,
                         ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                       head_dim=16, n_groups=1, chunk=16))
