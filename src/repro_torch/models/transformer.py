"""Model assembly for the dense decoders: blocks, the layer loop and the
serving entry points.

The port of ``repro/models/transformer.py`` for the dense family
(deepseek-7b, mistral-nemo-12b, qwen2-7b, gemma-7b): ``[attn + MLP] x L``
with pre-norm residuals. The reference scans stacked layer parameters with
``lax.scan``; here the layers are an ``nn.ModuleList`` run by a Python loop.
The KV cache keeps the reference's stacked layout, ``(L, B, S_max, Hkv,
hd)``, and every write lands in place: a slot's prefill writes through a
view of the arena (:func:`cache_slot_view`), never through a copy.

The other families (moe, mla, ssm, hybrid, encoder, vlm) are ported in a
later slice (ROADMAP.md, slice 11): :func:`init_params` refuses them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.executor import resolve_device
from .attention import Attention, Index, attention_apply, init_kv_cache
from .config import ModelConfig
from .layers import (Dense, Embedding, MLP, Norm, dense, embed, unembed)

#: a decode cache: {"index": int, "k": (L, B, S, Hkv, hd), "v": ...}
Cache = Dict[str, Any]

#: the families this slice builds
PORTED_FAMILIES = ("dense",)


class Block(nn.Module):
    """Pre-norm residual ``[attention + MLP]`` block (the reference's
    ``block_init`` for the ``attn_mlp`` kind)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.norm2 = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.mixer = Attention(cfg, generator=generator, **kw)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                       generator=generator, **kw)


def block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_index: Optional[Index] = None) -> torch.Tensor:
    """One block; ``cache`` is the layer's (k, v) views, written in place."""
    h = p.norm1(x)
    x = x + attention_apply(p.mixer, cfg, h, positions, cache=cache,
                            cache_index=cache_index)
    return x + p.ffn(p.norm2(x))


class Transformer(nn.Module):
    """A dense decoder: embedding, ``L`` blocks, final norm and LM head
    (tied to the embedding where the config says so)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
                f"this port builds {PORTED_FAMILIES} (the other families "
                f"follow in ROADMAP.md, slice 11)")
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model,
                               generator=generator, **kw)
        self.blocks = nn.ModuleList(
            Block(cfg, generator=generator, **kw)
            for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size,
                              generator=generator, **kw))


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """A randomly initialised model of ``cfg`` on ``device`` (the card
    unless the caller passes ``device="cpu"``), drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device; ``dtype``
    defaults to ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, generator=generator, dtype=dtype,
                           device=device)


def forward(model: Transformer, tokens: torch.Tensor, *,
            cache: Optional[Cache] = None,
            cache_index: Optional[Index] = None) -> torch.Tensor:
    """Hidden states after the final norm, ``(B, S, d_model)``.

    With ``cache``, every layer writes its keys and values in place at
    ``cache_index`` (an int, or per-row ``(B,)`` ages under ragged decode)
    and attends to the cache; without, the tokens attend to each other."""
    cfg = model.cfg
    h = embed(model.embed.table, tokens, scale_by_dim=cfg.embed_scale_by_dim)
    b, s = tokens.shape
    offset = cache_index if cache_index is not None else 0
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        offset = offset.to(h.device)[:, None]   # ragged decode: per-row ages
    positions = (offset + torch.arange(s, device=h.device)[None, :]
                 ).expand(b, s)
    for i, block in enumerate(model.blocks):
        layer_cache = (None if cache is None
                       else (cache["k"][i], cache["v"][i]))
        h = block_apply(block, cfg, h, positions, cache=layer_cache,
                        cache_index=cache_index)
    return model.final_norm(h)


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    if model.lm_head is None:
        return unembed(model.embed.table, h)
    return dense(h, model.lm_head.w, model.lm_head.b)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """The decode cache of the dense family: a write cursor ``index`` and
    the stacked ``(L, B, S_max, Hkv, hd)`` keys and values."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"no decode cache for the {cfg.family!r} "
                                  f"family yet (ROADMAP.md, slice 11)")
    return {"index": 0, **init_kv_cache(cfg, batch, max_len, dtype,
                                         device=device)}


def cache_slot_view(cache: Cache, slot: int) -> Cache:
    """A single-sequence view of slot ``slot`` of a batched cache, cursor
    at 0: a prefill through it writes straight into the arena (the
    reference's ``cache_slot_slice`` + ``cache_slot_put`` without the
    copies)."""
    return {"index": 0, "k": cache["k"][:, slot:slot + 1],
            "v": cache["v"][:, slot:slot + 1]}


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: Cache):
    """Process the prompt ``tokens`` (B, S) at the cache's cursor; returns
    ``(last-position logits (B, vocab), cache)`` with the cache written in
    place and its cursor advanced by S."""
    h = forward(model, tokens, cache=cache, cache_index=cache["index"])
    logits = logits_from_hidden(model, h[:, -1:])
    cache["index"] += tokens.shape[1]
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: Cache,
                lengths: Optional[torch.Tensor] = None):
    """One autoregressive step; tokens: (B, 1). ``lengths`` (B,) enables
    ragged continuous batching: each row writes and attends at its own age
    instead of the uniform cursor (pass them on the host: they are moved to
    the device once, and the cursor is read from the host copy). Returns ``(logits (B, vocab), cache)``;
    the cursor becomes ``max(age) + 1``, as in the reference."""
    idx, cursor = cache["index"], cache["index"] + 1
    if lengths is not None:
        lengths = torch.as_tensor(lengths)
        cursor = int(lengths.max()) + 1   # no device sync for host lengths
        idx = lengths.to(device=tokens.device, dtype=torch.int64)
    h = forward(model, tokens, cache=cache, cache_index=idx)
    logits = logits_from_hidden(model, h[:, -1:])
    cache["index"] = cursor
    return logits[:, 0], cache
