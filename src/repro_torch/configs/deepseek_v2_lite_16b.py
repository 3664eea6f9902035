"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE
(arXiv:2405.04434; hf).

27L d_model=2048 16H expert d_ff=1408 vocab=102400, 2 shared + 64 routed
top-6, layer 0 dense FFN (10944). The assignment note mentions "160 routed"
(DeepSeek-V2-full's count); both the assignment config line and the released
V2-Lite checkpoint say 64 routed, which we follow (see DESIGN.md).
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,     # informational: MLA replaces per-head KV
    d_ff=1408,
    vocab_size=102400,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    max_seq_len=163_840,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  first_dense_layers=1, d_ff_dense=10944),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256, max_seq_len=128,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=96,
                      capacity_factor=4.0,  # drop-free at smoke scale
                      first_dense_layers=1, d_ff_dense=192))
