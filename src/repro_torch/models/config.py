"""Architecture configuration schema covering all 10 assigned families.

A copy of the reference's ``repro/models/config.py``, pure dataclasses.
Only ``attention_impl`` differs: the reference's ``"pallas"`` is the port's
``"kernel"``, and it is the default, so the normal entry points launch the
port's hand-written kernels on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int                 # routed experts
    n_shared: int                 # always-on shared experts
    top_k: int
    d_expert: int                 # per-expert FFN width (fine-grained MoE)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_coef: float = 1e-2
    first_dense_layers: int = 1   # deepseek: layer 0 keeps a dense FFN
    d_ff_dense: int = 0           # width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: a single shared attention+MLP block applied every
    ``period`` Mamba2 layers, consuming concat(hidden, initial embedding)."""
    period: int = 6
    shared_n_heads: int = 32
    shared_d_ff: int = 10240


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontends are stubs: input_specs() provides precomputed
    frame/patch embeddings of ``d_in``; the model owns only the projector."""
    kind: str                      # "audio" | "vision"
    d_in: int                      # embedding dim delivered by the stub
    prefix_len: int = 0            # vision: patch tokens occupy a prefix


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp_kind: str = "swiglu"       # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"
    qkv_bias: bool = False         # qwen2
    rope_theta: float = 10_000.0
    causal: bool = True            # False: encoder-only (hubert)
    tie_embeddings: bool = False
    embed_scale_by_dim: bool = False   # gemma
    max_seq_len: int = 131_072
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: Optional[FrontendConfig] = None
    #: attention implementation: "reference" (the plain torch attention, on
    #: any device) or "kernel" (:mod:`repro_torch.kernels.ops`: the CUDA
    #: kernel for CUDA tensors, its plain version for CPU tensors)
    attention_impl: str = "kernel"
    dtype: str = "bfloat16"
    #: The fields below steer the reference's jit and training paths
    #: (rematerialization, scan unrolling, the chunked loss); the port's
    #: serving path reads none of them, and keeps them so that a reference
    #: config carries across field for field.
    #: remat policy for the scanned blocks: none | dots | full
    remat: str = "dots"
    #: scan unroll factor for the layer stack. 1 = rolled (compact HLO,
    #: production default); >= n_layers = fully unrolled (dry-run roofline
    #: pass: exact per-step HLO FLOP/collective accounting).
    scan_unroll: int = 1
    #: sequence-chunked cross-entropy: compute lm_head logits + CE over
    #: chunks of this many positions so only one chunk of (tokens, vocab)
    #: logits is ever live — the vocab-sized loss traffic is the dominant
    #: memory-roofline term for big-vocab training cells. 0 = off.
    loss_chunk: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/wiring, tiny sizes)."""
        return replace(self, **overrides)


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embeddings + blocks), for roofline
    MODEL_FLOPS = 6·N·D accounting."""
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d * (1 if cfg.tie_embeddings else 2)
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    for layer in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            s = cfg.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            gn = 2 * s.n_groups * s.d_state
            total += d * (2 * d_in + gn + nheads)         # z/x/BC/dt projs
            total += (d_in + gn) * (s.d_conv + 1)         # depthwise convs
            total += d_in * d                             # out proj
            total += d_in + nheads * 3                    # norm, A, dt, D
            total += 2 * d                                # block norms
            continue
        if cfg.mla is not None:
            m = cfg.mla
            q_dim = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
            total += d * q_dim if not m.q_lora_rank else \
                d * m.q_lora_rank + m.q_lora_rank * q_dim
            total += d * (m.kv_lora_rank + m.rope_head_dim)
            total += m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim
                                                     + m.v_head_dim)
            total += cfg.n_heads * m.v_head_dim * d
        else:
            total += d * cfg.n_heads * hd          # q
            total += 2 * d * cfg.n_kv_heads * hd   # k, v
            total += cfg.n_heads * hd * d          # o
        if cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
            e = cfg.moe
            gates = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            total += (e.n_routed + e.n_shared) * gates * d * e.d_expert
            total += d * e.n_routed                # router
        else:
            ff = (cfg.moe.d_ff_dense if cfg.moe and cfg.moe.d_ff_dense
                  else cfg.d_ff)
            gates = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            total += gates * d * ff
        total += 2 * d                             # norms
    if cfg.hybrid is not None:
        h = cfg.hybrid
        dd = 2 * d                                  # concat(h, emb) width
        total += 4 * dd * dd                        # shared attn qkv + o
        gates = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        total += gates * dd * h.shared_d_ff         # shared MLP
        total += dd * d                             # projection back to d
    return int(total)
