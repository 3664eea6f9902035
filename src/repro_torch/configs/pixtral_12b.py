"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone
(hf:mistralai/Pixtral-12B-2409).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The vision tower is
a stub per the assignment: input_specs() provides precomputed patch
embeddings (d_in=1024, the pixtral ViT width) that occupy a sequence prefix;
the model owns the two-layer multimodal projector.
"""
from ..models.config import FrontendConfig, ModelConfig

#: patch tokens per request in the dry-run shapes (a 1024x1024 image at
#: 16x16 patches -> 4096; we budget one 512-patch tile by default).
PATCH_PREFIX = 512

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    frontend=FrontendConfig(kind="vision", d_in=1024,
                            prefix_len=PATCH_PREFIX),
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=256,
                         max_seq_len=128,
                         frontend=FrontendConfig(kind="vision", d_in=32,
                                                 prefix_len=8))
