"""Model assembly: blocks, the layer loops and the entry points.

The port of ``repro/models/transformer.py`` for all six families:

* dense decoders (deepseek-7b, mistral-nemo-12b, qwen2-7b, gemma-7b):
  ``[attn + MLP] x L`` with pre-norm residuals;
* SSM (mamba2-1.3b): ``[norm + mamba2] x L``, attention-free;
* hybrid (zamba2-2.7b): ``L / period`` super-layers, each the one shared
  attention block (on ``concat(hidden, embedding)``, width 2d, projected
  back to d) then ``period`` mamba2 blocks;
* encoder (hubert-xlarge): bidirectional ``[attn + MLP] x L`` over frame
  embeddings, through the feature projection and the convolutional
  positional embedding, with a per-frame classification head (``encode``);
* VLM (pixtral-12b): the dense decoder with projected patch embeddings in
  the sequence prefix;
* MoE (deepseek-moe-16b, deepseek-v2-lite-16b): ``[attn + FFN] x L`` whose
  first ``first_dense_layers`` blocks keep a dense MLP of width
  ``d_ff_dense`` and the rest an MoE FFN (:mod:`.moe`: the expert-grouped
  matmul, kernel K6, on the kernel route); the mixer is multi-head latent
  attention (:mod:`.mla`) where the config has ``mla``.

The reference scans stacked layer parameters with ``lax.scan``; here the
layers are an ``nn.ModuleList`` run by a Python loop. The caches keep the
reference's stacked layouts (the KV cache ``(L, B, S_max, Hkv, hd)``, the
MLA latents ``(L, B, S_max, rank)`` and ``(L, B, S_max, rope_dim)``, the
mamba state ``(L, B, ...)``, the hybrid's ``(groups, ...)`` KV and
``(groups, period, B, ...)`` mamba leaves), except that the MoE family's
dense first layers share the stack (the reference keeps their caches in a
list beside it), and every write lands in place:
a slot's prefill writes through a view of the arena
(:func:`cache_slot_view`), never through a copy. The forward without a
cache (``train_loss``, ``encode``) sends every attention layer to flash
attention (kernel K4 on the card).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.executor import resolve_device
from ..distributed.sharding import local_region, shard
from .attention import (Attention, Index, attend, attention_apply,
                        cache_update, init_kv_cache, qkv_heads,
                        sdpa_reference)
from .config import ModelConfig
from .layers import (Dense, Embedding, MLP, Norm, dense, embed,
                     gelu_tanh, softmax_cross_entropy, unembed)
from .mamba2 import Mamba2, MambaCache, init_mamba_cache, mamba2_apply
from .mla import MLA, init_mla_cache, mla_apply
from .moe import MoE, moe_apply

#: a decode cache: {"index": int} and the family's stacked leaves ("k",
#: "v" for attention; "c_kv", "k_rope" for MLA; "conv_x", "conv_bc", "ssd"
#: for mamba layers)
Cache = Dict[str, Any]

#: the families this port builds
PORTED_FAMILIES = ("dense", "ssm", "hybrid", "encoder", "vlm", "moe")

#: trailing dims after the batch axis of each cache leaf (the leading
#: dims are layers, or groups and period)
_CACHE_TRAILING = {"k": 3, "v": 3, "c_kv": 2, "k_rope": 2, "conv_x": 2,
                   "conv_bc": 2, "ssd": 3}


class Block(nn.Module):
    """Pre-norm residual ``[attention + FFN]`` block, layer ``layer`` of the
    model (the reference's ``block_init`` for the kind ``_block_kind``
    gives it): the mixer is :class:`~.mla.MLA` where the config has
    ``mla``, else :class:`~.attention.Attention`; the FFN is an
    :class:`~.moe.MoE` from layer ``first_dense_layers`` on where the
    config has ``moe``, else an MLP (of width ``d_ff_dense`` in an MoE
    model's dense first layers)."""

    def __init__(self, cfg: ModelConfig, layer: int = 0, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.norm2 = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.mixer = (MLA if cfg.mla is not None else Attention)(
            cfg, generator=generator, **kw)
        moe = cfg.moe
        if moe is not None and layer >= moe.first_dense_layers:
            self.ffn = MoE(cfg, generator=generator, **kw)
        else:
            d_ff = (moe.d_ff_dense if moe is not None and moe.d_ff_dense
                    else cfg.d_ff)
            self.ffn = MLP(cfg.d_model, d_ff, cfg.mlp_kind,
                           generator=generator, **kw)


class MambaBlock(nn.Module):
    """Pre-norm residual mamba2 block, no FFN (the reference's
    ``block_init`` for the ``mamba`` kind)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.norm_kind, cfg.d_model, dtype=dtype,
                          device=device)
        self.mixer = Mamba2(cfg, generator=generator, dtype=dtype,
                            device=device)


def block_apply(p: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_index: Optional[Index] = None, with_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block; ``cache`` is the layer's views (the (k, v) pair of an
    attention block, the (c_kv, k_rope) pair of an MLA block, a
    :class:`MambaCache` of a mamba block), written in place. Returns
    ``(x, aux)``: ``aux`` is an MoE FFN's ``moe_aux_loss + moe_z_loss``
    (float32) when ``with_aux``, None otherwise and for any other block. A
    one-token step's MoE FFN is drop-free, as the reference's
    (``drop_free=h.shape[1] == 1``)."""
    h = p.norm1(x)
    if isinstance(p, MambaBlock):
        return x + mamba2_apply(p.mixer, cfg, h, cache=cache,
                                cache_index=cache_index), None
    mix = mla_apply if isinstance(p.mixer, MLA) else attention_apply
    x = x + mix(p.mixer, cfg, h, positions, cache=cache,
                cache_index=cache_index)
    h = p.norm2(x)
    if isinstance(p.ffn, MoE):
        out, aux = moe_apply(p.ffn, cfg, h, drop_free=h.shape[1] == 1,
                             with_aux=with_aux)
        return x + out, (None if aux is None
                         else aux["moe_aux_loss"] + aux["moe_z_loss"])
    return x + p.ffn(h), None


class SharedBlock(nn.Module):
    """zamba2's shared attention block (the reference's
    ``shared_block_init``): attention and MLP at width ``2 d_model`` on
    ``concat(hidden, embedding)``, and the projection back to ``d_model``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        hcfg = cfg.hybrid
        dd = 2 * cfg.d_model
        width = hcfg.shared_n_heads * (dd // hcfg.shared_n_heads)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = Norm(cfg.norm_kind, dd, dtype=dtype, device=device)
        self.wq = Dense(dd, width, **kw)
        self.wk = Dense(dd, width, **kw)
        self.wv = Dense(dd, width, **kw)
        self.wo = Dense(width, dd, **kw)
        self.norm2 = Norm(cfg.norm_kind, dd, dtype=dtype, device=device)
        self.ffn = MLP(dd, hcfg.shared_d_ff, cfg.mlp_kind, **kw)
        self.proj = Dense(dd, cfg.d_model, **kw)


def shared_block_apply(p: SharedBlock, cfg: ModelConfig, x: torch.Tensor,
                       emb0: torch.Tensor, positions: torch.Tensor, *,
                       cache=None, cache_index: Optional[Index] = None
                       ) -> torch.Tensor:
    """x, emb0: (B, S, d). The shared block on ``concat(x, emb0)`` (width
    2d), projected back to d and added to x. ``cache``: the group's (k, v)
    views, written in place at ``cache_index`` (0 when None). Its attention
    is the plain one (:func:`sdpa_reference`), as in the reference: its
    head dim (160 at zamba2-2.7b) is not one K3 is built for."""
    hcfg = cfg.hybrid
    dd = 2 * cfg.d_model
    nh = hcfg.shared_n_heads
    hd = dd // nh
    s = x.shape[1]
    z = torch.cat([x, emb0], dim=-1)
    h = p.norm1(z)
    q, k, v = qkv_heads(p.wq(h), p.wk(h), p.wv(h), positions,
                        cfg.rope_theta, hd)
    if cache is not None:
        idx = cache_index if cache_index is not None else 0
        ck, cv = cache
        cache_update(ck, k, idx)
        cache_update(cv, v, idx)
        out = attend(sdpa_reference, q, ck, cv, causal=True,
                     q_positions=positions, kv_valid_len=idx + s)
    else:
        out = attend(sdpa_reference, q, k, v, causal=True)
    z = z + p.wo(out)
    z = z + p.ffn(p.norm2(z))
    return x + p.proj(z)


class AudioFrontend(nn.Module):
    """hubert's feature projection of the frame embeddings and its
    depthwise convolutional positional embedding (31 taps per channel)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.proj = Dense(cfg.frontend.d_in, d, generator=generator,
                          dtype=dtype, device=device)
        w = torch.empty((31, d), dtype=dtype, device=device)
        self.pos_conv_w = nn.Parameter(w.normal_(generator=generator)
                                       .mul_(0.02))
        self.pos_conv_b = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                   device=device))


class VisionFrontend(nn.Module):
    """pixtral's two-layer projector of the patch embeddings."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.proj1 = Dense(cfg.frontend.d_in, cfg.d_model, **kw)
        self.proj2 = Dense(cfg.d_model, cfg.d_model, **kw)


def _pos_conv(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor
              ) -> torch.Tensor:
    k, s = w.shape[0], h.shape[1]
    pad = k // 2
    padded = F.pad(h, (0, 0, pad, k - 1 - pad))
    out = padded[:, :s] * w[0]
    for i in range(1, k):
        out = out + padded[:, i:i + s] * w[i]
    return h + gelu_tanh(out + b)


def _conv_pos_embed(p: AudioFrontend, h: torch.Tensor) -> torch.Tensor:
    """``h + gelu(conv(h) + b)``: the bidirectional depthwise convolution
    over the sequence as the reference writes it, the sum of 31 shifted
    products taken in tap order in h's dtype (each product and each
    addition rounds there, so a bfloat16 result is the reference's), and
    the reference's tanh GELU (:func:`gelu_tanh`). ``F.conv1d`` would sum
    in another order. A region: each rank convolves its sequences whole."""
    return local_region(_pos_conv, ((None, None), (None,),
                                    ("batch", None, None)),
                        (("batch", None, None),))(
                            p.pos_conv_w, p.pos_conv_b, h)


class Transformer(nn.Module):
    """A model of one family: the token embedding (none for an audio
    frontend), the frontend's projector where the config has one, ``L``
    blocks (attention blocks for the dense, encoder and vlm families, mamba
    blocks for ``ssm`` and ``hybrid``, attention or MLA blocks with dense
    or MoE FFNs for ``moe``), the hybrid's shared block, final norm and LM
    head (tied to the embedding where the config says so)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported; "
                f"this port builds {PORTED_FAMILIES}")
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        front = cfg.frontend
        self.embed = (None if front is not None and front.kind == "audio"
                      else Embedding(cfg.vocab_size, cfg.d_model,
                                     generator=generator, **kw))
        self.frontend = (None if front is None else
                         (AudioFrontend if front.kind == "audio"
                          else VisionFrontend)(cfg, generator=generator,
                                               **kw))
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"split into super-layers of "
                             f"{cfg.hybrid.period}")
        self.blocks = nn.ModuleList(
            MambaBlock(cfg, generator=generator, **kw)
            if cfg.family in ("ssm", "hybrid")
            else Block(cfg, i, generator=generator, **kw)
            for i in range(cfg.n_layers))
        self.shared = (SharedBlock(cfg, generator=generator, **kw)
                       if cfg.family == "hybrid" else None)
        self.final_norm = Norm(cfg.norm_kind, cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size,
                              generator=generator, **kw))


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """A randomly initialised model of ``cfg`` on ``device`` (the card
    unless the caller passes ``device="cpu"``), drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device; ``dtype``
    defaults to ``cfg.dtype``. ``device="meta"`` builds the shapes alone
    (the dry-run's parameter structs): no generator, nothing drawn or
    allocated."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if torch.device(device).type == "meta":
        with torch.no_grad():
            return Transformer(cfg, generator=None, dtype=dtype,
                               device="meta")
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, generator=generator, dtype=dtype,
                           device=device)


def forward(model: Transformer, tokens: Optional[torch.Tensor] = None, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            cache: Optional[Cache] = None,
            cache_index: Optional[Index] = None) -> torch.Tensor:
    """Hidden states after the final norm, ``(B, S, d_model)``.

    The input is ``tokens`` (B, S); for an audio frontend (hubert) it is
    ``frames`` (B, S, d_in) instead, in the model's dtype. A vision model
    (pixtral) takes optional ``patches`` (B, P, d_in), whose projections
    replace the embeddings of the first P positions.

    With ``cache``, every layer writes its state in place at
    ``cache_index`` (an int, or per-row ``(B,)`` ages under ragged decode):
    attention layers their keys and values, attending to the cache; mamba
    layers their conv and SSD state, from zero state at a cursor of 0.
    Without, the positions attend to each other (flash attention on the
    kernel route) and mamba layers start from zero state."""
    return _forward(model, tokens, frames=frames, patches=patches,
                    cache=cache, cache_index=cache_index)[0]


def _forward(model: Transformer, tokens: Optional[torch.Tensor] = None, *,
             frames: Optional[torch.Tensor] = None,
             patches: Optional[torch.Tensor] = None,
             cache: Optional[Cache] = None,
             cache_index: Optional[Index] = None, with_aux: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`forward` and the MoE layers' auxiliary loss: ``(hidden
    states, the sum of every MoE layer's moe_aux_loss + moe_z_loss)``, a
    float32 scalar (zero without MoE layers), summed in layer order as the
    reference's scan sums it. Without ``with_aux`` (every caller but
    :func:`train_loss`) the losses are not computed and the sum is None."""
    cfg = model.cfg
    front = cfg.frontend
    if front is not None and front.kind == "audio":
        if frames is None:
            raise ValueError(f"{cfg.name} takes frames (B, S, "
                             f"{front.d_in}), not tokens")
        h = _conv_pos_embed(model.frontend, model.frontend.proj(frames))
    else:
        h = embed(model.embed.table, tokens,
                  scale_by_dim=cfg.embed_scale_by_dim)
        if front is not None and front.kind == "vision" \
                and patches is not None:
            f = model.frontend
            pp = gelu_tanh(f.proj1(patches))
            pp = f.proj2(pp).to(h.dtype)
            h = torch.cat([pp, h[:, pp.shape[1]:]], dim=1)
    h = shard(h, "batch", None, "embed")
    b, s = h.shape[:2]
    offset = cache_index if cache_index is not None else 0
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        offset = offset.to(h.device)[:, None]   # ragged decode: per-row ages
    positions = (offset + torch.arange(s, device=h.device)[None, :]
                 ).expand(b, s)
    aux = (torch.zeros((), dtype=torch.float32, device=h.device)
           if with_aux else None)
    if cfg.family == "hybrid":
        emb0, period = h, cfg.hybrid.period
        for g in range(cfg.n_layers // period):
            h = shared_block_apply(
                model.shared, cfg, h, emb0, positions,
                cache=None if cache is None else (cache["k"][g],
                                                  cache["v"][g]),
                cache_index=cache_index)
            for i in range(period):
                h, _ = block_apply(
                    model.blocks[g * period + i], cfg, h, positions,
                    cache=None if cache is None else _mamba_layer(cache,
                                                                  g, i),
                    cache_index=cache_index)
    else:
        for i, block in enumerate(model.blocks):
            layer_cache = None
            if cache is not None:
                layer_cache = (_mamba_layer(cache, i) if cfg.family == "ssm"
                               else (cache["c_kv"][i], cache["k_rope"][i])
                               if cfg.mla is not None
                               else (cache["k"][i], cache["v"][i]))
            h, a = block_apply(block, cfg, h, positions, cache=layer_cache,
                               cache_index=cache_index, with_aux=with_aux)
            if a is not None:
                aux = aux + a
    return model.final_norm(h), aux


def _mamba_layer(cache: Cache, *layer: int) -> MambaCache:
    """One mamba layer's views: ``layer`` is ``(i,)`` into ``(L, ...)``
    leaves or ``(group, i)`` into the hybrid's ``(groups, period, ...)``."""
    return MambaCache(*(cache[k][layer] for k in MambaCache._fields))


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    logits = (unembed(model.embed.table, h) if model.lm_head is None
              else dense(h, model.lm_head.w, model.lm_head.b))
    return shard(logits, "batch", None, "vocab")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """The family's decode cache, zeros on ``device``, with a write cursor
    ``index``:

    * dense, vlm and moe: keys and values ``(L, B, S_max, Hkv, hd)`` in
      ``dtype``; with MLA (deepseek-v2-lite) the latents ``c_kv`` ``(L, B,
      S_max, kv_lora_rank)`` and ``k_rope`` ``(L, B, S_max,
      rope_head_dim)`` instead (the reference keeps its first dense
      layers' caches in a list beside an ``(L - first_dense_layers, ...)``
      stack; here all ``L`` layers share one stack);
    * ssm: the mamba state of :func:`init_mamba_cache`, ``(L, B, ...)``
      (float32, as the reference's);
    * hybrid: the shared block's keys and values ``(groups, B, S_max,
      heads, hd)`` in ``dtype`` and the mamba state ``(groups, period, B,
      ...)``.

    An encoder has no decode step and so no cache: it raises
    ``ValueError``, the reference's rule (``launch/specs.py``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"no decode cache for the {cfg.family!r} "
                                  f"family: it is not ported")
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name}: encoder-only: no decode step")
    if cfg.family in ("dense", "vlm", "moe"):
        init = init_mla_cache if cfg.mla is not None else init_kv_cache
        return {"index": 0, **init(cfg, batch, max_len, dtype,
                                   device=device)}
    if cfg.family == "ssm":
        return {"index": 0, **init_mamba_cache(cfg, batch, device=device)}
    hcfg = cfg.hybrid
    groups = cfg.n_layers // hcfg.period
    hd = 2 * cfg.d_model // hcfg.shared_n_heads
    shape = (groups, batch, max_len, hcfg.shared_n_heads, hd)
    mamba = init_mamba_cache(cfg, batch, n_layers=groups * hcfg.period,
                             device=device)
    return {"index": 0,
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            **{k: v.view(groups, hcfg.period, *v.shape[1:])
               for k, v in mamba.items()}}


def cache_slot_view(cache: Cache, slot: int) -> Cache:
    """A single-sequence view of slot ``slot`` of a batched cache, cursor
    at 0: a prefill through it writes straight into the arena (the
    reference's ``cache_slot_slice`` + ``cache_slot_put`` without the
    copies). The batch axis of each leaf is found from its trailing dims,
    so the layouts of every family share this view."""
    view = {"index": 0}
    for key, leaf in cache.items():
        if key != "index":
            axis = leaf.dim() - 1 - _CACHE_TRAILING[key]
            view[key] = leaf.narrow(axis, slot, 1)
    return view


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: Cache, *,
            patches: Optional[torch.Tensor] = None):
    """Process the prompt ``tokens`` (B, S) at the cache's cursor; returns
    ``(last-position logits (B, vocab), cache)`` with the cache written in
    place and its cursor advanced by S. A vision model's ``patches`` (B, P,
    d_in) take the first P positions, as in :func:`forward`. At cursor 0
    the mamba layers start from zero state; a multi-token prompt at a
    cursor > 0 of a model with mamba layers raises
    ``NotImplementedError``."""
    h = forward(model, tokens, patches=patches, cache=cache,
                cache_index=cache["index"])
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


def _batch_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"tokens": batch.get("tokens"), "frames": batch.get("frames"),
            "patches": batch.get("patches")}


def train_loss(model: Transformer, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training objective of the reference's ``train_loss``: token-mean
    cross-entropy of ``batch["labels"]`` (B, S) under the optional
    ``loss_mask`` (B, S), chunked over the sequence when ``cfg.loss_chunk``
    divides S (and is shorter), plus the auxiliary loss (the MoE layers'
    ``moe_aux_loss + moe_z_loss``, zero for the other families). ``batch``
    holds the :func:`forward` inputs
    (``tokens``, ``frames``, ``patches``). Returns ``(loss, {"ce",
    "aux"})``, float32 scalars.

    On the kernel route (``attention_impl == "kernel"``) it runs under
    ``torch.no_grad()``: flash attention (K4) and the grouped matmul (K6)
    have no backward kernels, as the reference's have none; differentiate
    through ``attention_impl="reference"``."""
    cfg = model.cfg
    grad = (torch.no_grad() if cfg.attention_impl == "kernel"
            else contextlib.nullcontext())
    with grad:
        h, aux = _forward(model, **_batch_inputs(batch), with_aux=True)
        labels, mask = batch["labels"], batch.get("loss_mask")
        c = cfg.loss_chunk
        if c and h.shape[1] % c == 0 and h.shape[1] > c:
            ce = _chunked_ce(model, h, labels, mask)
        else:
            ce = softmax_cross_entropy(logits_from_hidden(model, h), labels,
                                       mask)
        loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def _chunked_ce(model: Transformer, h: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Sequence-chunked cross-entropy: one chunk of ``loss_chunk``
    positions' (tokens, vocab) logits is live at a time; the chunks' sums
    add in order, as the reference's scan adds them."""
    c = model.cfg.loss_chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[1], c):
        # replicated vocab for the gather, as in softmax_cross_entropy
        logits = shard(logits_from_hidden(model, h[:, i:i + c]),
                       "batch", None, None).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, i:i + c, None].long())[..., 0]
        m = (torch.ones_like(lse) if mask is None
             else mask[:, i:i + c].float())
        total = total + ((lse - ll) * m).sum()
        count = count + m.sum()
    return total / count.clamp_min(1.0)


@torch.no_grad()
def encode(model: Transformer, batch: Dict[str, torch.Tensor]
           ) -> torch.Tensor:
    """Encoder-only forward (hubert): per-frame class logits ``(B, S,
    vocab)`` from ``batch["frames"]`` (B, S, d_in)."""
    return logits_from_hidden(model, forward(model, **_batch_inputs(batch)))
