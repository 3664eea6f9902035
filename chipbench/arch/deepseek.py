"""The DeepSeek MoE architectures (``"arch": "deepseek"``): DeepSeekMoE with
multi-head attention and DeepSeek-V2 with multi-head latent attention.

What the harness asks of an architecture file (``chipbench/arch``): the
port's configuration of a configuration file, the weights a model of it
holds, and the model operations of a prefill and of a decode step. The
plain reference of the same architecture is ``chipbench/reference/
deepseek.py``.
"""
from __future__ import annotations

from typing import List

from chipbench import work
from chipbench.weights import Weight

#: published settings the port implements, each with the one value it
#: runs; a configuration file that states another value keeps it (its
#: published value) and names the key among its ``departures``
PORT = {"hidden_act": "silu", "rms_norm_eps": 1e-6, "attention_bias": False,
        "tie_word_embeddings": False, "moe_layer_freq": 1,
        "scoring_func": "softmax", "norm_topk_prob": True,
        "rope_scaling": None, "routed_scaling_factor": 1,
        "topk_method": "greedy", "n_group": 1, "topk_group": 1,
        "q_lora_rank": None}

#: scale of the embedding rows and of the norms' scales
EMBED_SCALE = 0.02
NORM_SCALE = 0.1


def model_config(cfg: dict):
    """The port's :class:`ModelConfig` of a configuration file."""
    from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
    departs = cfg.get("departures", {})
    for key, runs in PORT.items():
        if key in cfg and cfg[key] != runs and key not in departs:
            raise ValueError(f"{cfg['name']}: the port runs {key} = "
                             f"{runs!r}, the file states {cfg[key]!r} and "
                             f"lists no departure")
    mla = None
    if cfg.get("kv_lora_rank"):
        mla = MLAConfig(kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=0,
                        rope_head_dim=cfg["qk_rope_head_dim"],
                        nope_head_dim=cfg["qk_nope_head_dim"],
                        v_head_dim=cfg["v_head_dim"])
    moe = MoEConfig(n_routed=cfg["n_routed_experts"],
                    n_shared=cfg["n_shared_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    d_expert=cfg["moe_intermediate_size"],
                    capacity_factor=cfg["capacity_factor"],
                    first_dense_layers=cfg["first_k_dense_replace"],
                    d_ff_dense=cfg["intermediate_size"])
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_kind="swiglu", rope_theta=float(cfg["rope_theta"]),
        max_seq_len=cfg["max_position_embeddings"], mla=mla, moe=moe,
        dtype=cfg["dtype"])


def _dense(name: str, d_in: int, d_out: int) -> Weight:
    return name, (d_in, d_out), d_in ** -0.5


def spec(cfg: dict) -> List[Weight]:
    """Every weight (name, shape, scale of its normal draw); the names are
    the parameter paths of the port's model."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h = cfg["num_attention_heads"]
    out: List[Weight] = [("embed.table", (v, d), EMBED_SCALE)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.norm1.scale", (d,), NORM_SCALE),
                (f"{b}.norm2.scale", (d,), NORM_SCALE)]
        if cfg.get("kv_lora_rank"):
            r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
            dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
            out += [_dense(f"{b}.mixer.wdkv.w", d, r + dr),
                    (f"{b}.mixer.kv_norm.scale", (r,), NORM_SCALE),
                    _dense(f"{b}.mixer.wuk.w", r, h * dn),
                    _dense(f"{b}.mixer.wuv.w", r, h * dv),
                    _dense(f"{b}.mixer.wo.w", h * dv, d),
                    _dense(f"{b}.mixer.wq.w", d, h * (dn + dr))]
        else:
            hd, hkv = d // h, cfg["num_key_value_heads"]
            out += [_dense(f"{b}.mixer.wq.w", d, h * hd),
                    _dense(f"{b}.mixer.wk.w", d, hkv * hd),
                    _dense(f"{b}.mixer.wv.w", d, hkv * hd),
                    _dense(f"{b}.mixer.wo.w", h * hd, d)]
        if i < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            out += [_dense(f"{b}.ffn.gate.w", d, f),
                    _dense(f"{b}.ffn.up.w", d, f),
                    _dense(f"{b}.ffn.down.w", f, d)]
        else:
            e, de = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            ds = cfg["n_shared_experts"] * de
            out += [_dense(f"{b}.ffn.router.w", d, e),
                    (f"{b}.ffn.experts.gate.w", (e, d, de), d ** -0.5),
                    (f"{b}.ffn.experts.up.w", (e, d, de), d ** -0.5),
                    (f"{b}.ffn.experts.down.w", (e, de, d), de ** -0.5),
                    _dense(f"{b}.ffn.shared.gate.w", d, ds),
                    _dense(f"{b}.ffn.shared.up.w", d, ds),
                    _dense(f"{b}.ffn.shared.down.w", ds, d)]
    out += [("final_norm.scale", (d,), NORM_SCALE),
            _dense("lm_head.w", d, v)]
    return out


prefill_flops = work.prefill_flops
decode_flops = work.decode_flops
