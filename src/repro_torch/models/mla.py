"""Multi-head Latent Attention (the DeepSeek-V2 family).

The port of ``repro/models/mla.py``. The KV state is a ``kv_lora_rank``
latent per token plus one shared RoPE key of ``rope_head_dim``: the cache
holds 512 + 64 values a token whatever the head count. Training and
prefill materialise per-head keys and values from the latents (the naive
path); a one-token decode step uses the absorbed form (``W_uk`` folded
into the query, ``W_uv`` applied after attention in latent space), which
reads only the compressed cache. The reference has no Pallas kernel on
this path, and the port's is plain batched torch: the score products take
float32 operands (the reference's ``preferred_element_type=float32``),
the other products round once to the activations' dtype. The cache views
are written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..distributed.sharding import local_region
from .attention import NEG_INF, Index, attention_mask, cache_update
from .config import ModelConfig
from .layers import Dense, Norm, apply_rope, dense

#: a layer's cache: (c_kv (B, S_max, rank), k_rope (B, S_max, rope_dim))
MLACache = Tuple[torch.Tensor, torch.Tensor]


class MLA(nn.Module):
    """The reference's ``mla_init``: the latent down-projection ``wdkv``
    (to ``rank + rope_dim``) and its RMSNorm, the up-projections ``wuk``
    and ``wuv`` of the latent, the output ``wo``, and the queries: ``wq``
    where ``q_lora_rank == 0`` (V2-Lite), else ``wdq``, ``q_norm`` and
    ``wuq``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        m, h = cfg.mla, cfg.n_heads
        kw = dict(generator=generator, dtype=dtype, device=device)
        q_dim = h * (m.nope_head_dim + m.rope_head_dim)
        self.wdkv = Dense(cfg.d_model, m.kv_lora_rank + m.rope_head_dim, **kw)
        self.kv_norm = Norm("rmsnorm", m.kv_lora_rank, dtype=dtype,
                            device=device)
        self.wuk = Dense(m.kv_lora_rank, h * m.nope_head_dim, **kw)
        self.wuv = Dense(m.kv_lora_rank, h * m.v_head_dim, **kw)
        self.wo = Dense(h * m.v_head_dim, cfg.d_model, **kw)
        if m.q_lora_rank:
            self.wdq = Dense(cfg.d_model, m.q_lora_rank, **kw)
            self.q_norm = Norm("rmsnorm", m.q_lora_rank, dtype=dtype,
                               device=device)
            self.wuq = Dense(m.q_lora_rank, q_dim, **kw)
        else:
            self.wq = Dense(cfg.d_model, q_dim, **kw)


def _scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope head dims), rounded to float32 as the
    reference computes it."""
    m = cfg.mla
    return (1.0 / torch.sqrt(torch.tensor(
        float(m.nope_head_dim + m.rope_head_dim)))).item()


def _split_queries(q, positions, theta, nope, width):
    q = q.unflatten(-1, (-1, width))
    return q[..., :nope], apply_rope(q[..., nope:], positions, theta)


def _queries(p: MLA, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """(q_nope, q_rope), each (B, S, H, ...): a region over the heads."""
    m = cfg.mla
    q = p.wuq(p.q_norm(p.wdq(x))) if m.q_lora_rank else p.wq(x)
    width = m.nope_head_dim + m.rope_head_dim
    heads = ("batch", None, "heads", None)
    return local_region(_split_queries,
                        (("batch", None, ("heads", width)), ("batch", None)),
                        (heads, heads))(q, positions, cfg.rope_theta,
                                        m.nope_head_dim, width)


def _latents(p: MLA, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    ckr = p.wdkv(x)
    c_kv = p.kv_norm(ckr[..., :m.kv_lora_rank])
    k_rope = ckr[..., m.kv_lora_rank:][..., None, :]        # one shared head
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """scores (B, H, Sq, Skv) float32, mask (B, Sq, Skv): the reference's
    ``softmax(where(mask, scores, NEG_INF))`` cast to ``dtype``."""
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _naive_heads(cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, wuk, wuv,
                 q_positions, kv_valid_len) -> torch.Tensor:
    m = cfg.mla
    b, skv = c_kv.shape[0], c_kv.shape[1]
    k_nope = dense(c_kv, wuk).unflatten(-1, (-1, m.nope_head_dim))
    v = dense(c_kv, wuv).unflatten(-1, (-1, m.v_head_dim))
    scores = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * _scale(cfg)
    mask = attention_mask(b, q_nope.shape[1], skv, causal=True,
                          q_positions=q_positions, kv_valid_len=kv_valid_len,
                          device=c_kv.device)
    w = _masked_softmax(scores, mask, v.dtype)
    return torch.einsum("bhst,bthd->bshd", w.float(),
                        v.float()).to(v.dtype).flatten(-2)


def _absorbed_heads(cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, wuk,
                    wuv, valid_len) -> torch.Tensor:
    m = cfg.mla
    b = q_nope.shape[0]
    dtype = c_kv.dtype
    wuk = wuk.unflatten(1, (-1, m.nope_head_dim))
    # fold W_uk into the query: q_c = q_nope W_uk^T, in latent space
    q_c = torch.einsum("bshd,chd->bshc", q_nope.float(),
                       wuk.float()).to(q_nope.dtype)           # (B,1,H,rank)
    scores = (torch.einsum("bshc,btc->bhst", q_c.float(), c_kv.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * _scale(cfg)
    mask = attention_mask(b, 1, c_kv.shape[1], causal=False,
                          kv_valid_len=valid_len, device=c_kv.device)
    w = _masked_softmax(scores, mask, dtype)
    ctx = torch.einsum("bhst,btc->bshc", w.float(),
                       c_kv.float()).to(dtype)                 # latent context
    wuv = wuv.unflatten(1, (-1, m.v_head_dim))
    return torch.einsum("bshc,chd->bshd", ctx.float(),
                        wuv.float()).to(dtype).flatten(-2)


def _latent_attention(body, p: MLA, cfg: ModelConfig, q_nope, q_rope, c_kv,
                      k_rope, *lengths) -> torch.Tensor:
    """``body`` as a region over the heads: each rank's query heads with
    their columns of W_uk and W_uv against the whole latents."""
    m = cfg.mla
    heads = ("batch", None, "heads", None)
    latent = ("batch", None, None)
    masks = (("batch", None), ("batch",))[-len(lengths):]
    return local_region(
        body, (None, heads, heads, latent, latent,
               (None, ("heads", m.nope_head_dim)),
               (None, ("heads", m.v_head_dim)), *masks),
        (("batch", None, ("heads", m.v_head_dim)),))(
            cfg, q_nope, q_rope, c_kv, k_rope, p.wuk.w, p.wuv.w, *lengths)


def _naive(p: MLA, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, *,
           q_positions: Optional[torch.Tensor] = None,
           kv_valid_len: Optional[Index] = None) -> torch.Tensor:
    """Per-head keys and values materialised from the latents (training
    and prefill): (B, Sq, H v_head_dim), the heads merged."""
    return _latent_attention(_naive_heads, p, cfg, q_nope, q_rope, c_kv,
                             k_rope, q_positions, kv_valid_len)


def _absorbed_decode(p: MLA, cfg: ModelConfig, q_nope, q_rope, c_kv,
                     k_rope, valid_len: Index) -> torch.Tensor:
    """Attention in latent space for one-token queries, reading only the
    compressed cache (``valid_len``: scalar or per-row (B,) lengths):
    (B, 1, H v_head_dim), the heads merged."""
    return _latent_attention(_absorbed_heads, p, cfg, q_nope, q_rope, c_kv,
                             k_rope, valid_len)


def mla_apply(p: MLA, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, cache: Optional[MLACache] = None,
              cache_index: Optional[Index] = None) -> torch.Tensor:
    """The attention block body (no norms or residual). ``cache``: the
    layer's (c_kv, k_rope) views, written in place at ``cache_index`` (0
    when None; per-row (B,) ages for a ragged decode step); a one-token
    step then attends in latent space over the first ``cache_index + 1``
    positions of each row, a longer input through the naive path over the
    first ``cache_index + s``. Without a cache, ``x`` attends causally to
    itself."""
    s = x.shape[1]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    if cache is not None:
        idx = cache_index if cache_index is not None else 0
        cc, cr = cache
        cache_update(cc, c_kv, idx)
        cache_update(cr, k_rope, idx)
        if s == 1:
            out = _absorbed_decode(p, cfg, q_nope, q_rope, cc, cr, idx + 1)
        else:
            out = _naive(p, cfg, q_nope, q_rope, cc, cr,
                         q_positions=positions, kv_valid_len=idx + s)
    else:
        out = _naive(p, cfg, q_nope, q_rope, c_kv, k_rope)
    return p.wo(out)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device="cuda",
                   n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer latent cache: ``{"c_kv": (L, B, S_max, rank),
    "k_rope": (L, B, S_max, rope_dim)}``, zeros on ``device``."""
    m = cfg.mla
    layers = n_layers if n_layers is not None else cfg.n_layers
    return {"c_kv": torch.zeros((layers, batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((layers, batch, max_len, m.rope_head_dim),
                                  dtype=dtype, device=device)}
