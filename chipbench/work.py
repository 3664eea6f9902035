"""Operation and byte counts behind every roofline share and ``model.mfu``,
and the published peaks of one NVIDIA H100.

Each count is of the work that a layer's inputs need, from shapes, valid
context lengths and the router's assignments: the same whatever
implements the layer. A roofline share is the least time the chip could
take for that work (the larger of operations over the bf16 peak and bytes
over the HBM bandwidth) over the device time the layer took.

``cfg`` is a configuration file's JSON object (``chipbench/configs``):
the published key names (``hidden_size``, ``num_hidden_layers``, ...).
"""
from __future__ import annotations

from typing import Iterable

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W: the
#: bf16 tensor-core rate (the configurations' dtype, so no sound
#: implementation of a layer can beat it) and the HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: bytes of a bf16 value, the configurations' weights, cache and activations
BF16 = 2


def is_mla(cfg: dict) -> bool:
    return bool(cfg.get("kv_lora_rank"))


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def kv_bytes_per_token(cfg: dict) -> int:
    """Cache bytes one token holds over all layers: the keys and values of
    every KV head, or with MLA the latent and the shared RoPE key."""
    layers = cfg["num_hidden_layers"]
    if is_mla(cfg):
        return layers * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * BF16
    return layers * 2 * cfg["num_key_value_heads"] * head_dim(cfg) * BF16


def attention_params(cfg: dict) -> int:
    """Parameters of one layer's attention projections."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if is_mla(cfg):
        r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        q = d * h * (dn + dr) if not cfg.get("q_lora_rank") else \
            d * cfg["q_lora_rank"] + cfg["q_lora_rank"] * h * (dn + dr)
        return q + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    hd = head_dim(cfg)
    return d * h * hd * 2 + d * cfg["num_key_value_heads"] * hd * 2


def expert_params(cfg: dict) -> int:
    """Parameters of one expert (gate, up and down)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def ffn_active_params(cfg: dict, layer: int) -> int:
    """Parameters one token meets in layer ``layer``'s FFN: the dense MLP
    of the first layers, else its top-k routed experts, the shared experts
    and the router."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * d * cfg["intermediate_size"]
    return ((cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
            * expert_params(cfg) + d * cfg["n_routed_experts"])


def active_params(cfg: dict) -> int:
    """Parameters one token meets through the layers (no embedding, no LM
    head)."""
    layers = cfg["num_hidden_layers"]
    return layers * attention_params(cfg) + sum(
        ffn_active_params(cfg, i) for i in range(layers))


def total_params(cfg: dict) -> int:
    """Every parameter: embedding, layers (all experts), norms, LM head."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    total = 2 * cfg["vocab_size"] * d + d          # embedding, head, norm
    for i in range(layers):
        total += attention_params(cfg) + 2 * d
        if is_mla(cfg):
            total += cfg["kv_lora_rank"]           # the latent's norm
        if i < cfg["first_k_dense_replace"]:
            total += 3 * d * cfg["intermediate_size"]
        else:
            total += ((cfg["n_routed_experts"] + cfg["n_shared_experts"])
                      * expert_params(cfg) + d * cfg["n_routed_experts"])
    return total


def attn_pair_flops(cfg: dict) -> int:
    """Operations of one (query, key) pair in one layer: the score and the
    value products over every head."""
    h = cfg["num_attention_heads"]
    if is_mla(cfg):
        return 2 * h * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) \
            + 2 * h * cfg["v_head_dim"]
    return 4 * h * head_dim(cfg)


def lm_head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(cfg: dict, n: int) -> int:
    """Model operations of a prefill of ``n`` tokens: every token through
    the layers, attention over each token's causal context, and the LM
    head at the last position (the one sampled token)."""
    return (2 * active_params(cfg) * n
            + cfg["num_hidden_layers"] * attn_pair_flops(cfg)
            * causal_pairs(n) + lm_head_flops(cfg))


def decode_flops(cfg: dict, contexts: Iterable[int]) -> int:
    """Model operations of a decode step whose rows attend to
    ``contexts`` positions each (their own token included): a token and a
    sampled token a row."""
    ctx = list(contexts)
    return (len(ctx) * (2 * active_params(cfg) + lm_head_flops(cfg))
            + cfg["num_hidden_layers"] * attn_pair_flops(cfg) * sum(ctx))


def attn_prefill_work(cfg: dict, n: int) -> tuple:
    """(operations, bytes) of one layer's attention over a prompt of ``n``
    tokens at cursor 0: the causal pairs, and the queries, keys and values
    read once and the output written once. With MLA the per-head keys and
    values come from the latents (their up-projection counted) and the
    inputs are the latents, the RoPE keys and the up-projection weights."""
    h = cfg["num_attention_heads"]
    pairs = causal_pairs(n)
    if is_mla(cfg):
        r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        flops = 2 * n * r * h * (dn + dv) + attn_pair_flops(cfg) * pairs
        values = n * (r + dr) + r * h * (dn + dv) + n * h * (dn + dr) \
            + n * h * dv
        return flops, values * BF16
    hd, hkv = head_dim(cfg), cfg["num_key_value_heads"]
    values = 2 * n * h * hd + 2 * n * hkv * hd
    return attn_pair_flops(cfg) * pairs, values * BF16


def attn_decode_work(cfg: dict, contexts: Iterable[int]) -> tuple:
    """(operations, bytes) of one layer's attention in a decode step whose
    rows attend to ``contexts`` positions: the cache read once at each
    row's valid length; with MLA's absorbed form also the up-projection
    weights (read once a step) and the fold of each query into the latent
    space and of each context out of it."""
    ctx = list(contexts)
    rows, total = len(ctx), sum(ctx)
    h = cfg["num_attention_heads"]
    if is_mla(cfg):
        r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        flops = (rows * 2 * h * r * (dn + dv)
                 + total * (2 * h * (r + dr) + 2 * h * r))
        values = total * (r + dr) + r * h * (dn + dv) \
            + rows * h * (dn + dr + dv)
        return flops, values * BF16
    hd, hkv = head_dim(cfg), cfg["num_key_value_heads"]
    values = total * 2 * hkv * hd + rows * 2 * h * hd
    return attn_pair_flops(cfg) * total, values * BF16


def experts_work(cfg: dict, kept: int, reached: int) -> tuple:
    """(operations, bytes) of the routed experts over ``kept`` assignments
    that reach ``reached`` distinct experts: gate, up and down of each
    assignment; each reached expert's weights read once, and each
    assignment's input row read and output row written once."""
    d, de = cfg["hidden_size"], cfg["moe_intermediate_size"]
    flops = kept * 2 * 3 * d * de
    values = reached * 3 * d * de + kept * 2 * d
    return flops, values * BF16


def roofline_s(flops: float, n_bytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_HBM_BYTES)
