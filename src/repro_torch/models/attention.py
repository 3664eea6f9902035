"""Grouped-query attention with a KV cache written in place.

The port of ``repro/models/attention.py``. ``sdpa_reference`` is the plain
torch attention (the reference's einsum formulation and its "lean
softmax"); with ``cfg.attention_impl == "kernel"`` a one-token query
against the cache goes through :func:`repro_torch.kernels.ops.decode_attention`
(kernel K3 on the card) and a query with no cache through
:func:`repro_torch.kernels.ops.flash_attention` (kernel K4), as the
reference's ``"pallas"`` goes to its Pallas kernels; a prefill against a
cache takes the plain attention, as in the reference. The cache is a per-layer ``(B, S_max, Hkv, hd)`` view of the
model's arena, updated in place where the reference returns a new array.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..distributed.sharding import local_region
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import Dense, apply_rope

#: Score of a masked position (the reference's ``NEG_INF``).
NEG_INF = -2.0 ** 30

#: a layer's cache: (k, v) views, each (B, S_max, Hkv, hd)
LayerCache = Tuple[torch.Tensor, torch.Tensor]
#: a write offset: one for every row, or one per row (B,)
Index = Union[int, torch.Tensor]


class Attention(nn.Module):
    """The q/k/v/o projections (the reference's ``attention_init``)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        **kw)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        **kw)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, **kw)


def attention_mask(batch: int, sq: int, skv: int, *, causal: bool,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_valid_len: Optional[Index] = None,
                   device=None) -> torch.Tensor:
    """(B, Sq, Skv) boolean mask. ``q_positions``: (Sq,) or (B, Sq) absolute
    query positions; ``kv_valid_len``: scalar or (B,) valid cache length."""
    kv_pos = torch.arange(skv, device=device)
    if causal:
        qp = (torch.arange(sq, device=device) if q_positions is None
              else q_positions)
        if qp.dim() == 1:
            qp = qp[None, :].expand(batch, sq)
        mask = qp[:, :, None] >= kv_pos[None, None, :]
    else:
        mask = torch.ones((batch, sq, skv), dtype=torch.bool, device=device)
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=device)
        if valid.dim() == 0:
            valid = valid[None].expand(batch)
        mask = mask & (kv_pos[None, None, :] < valid[:, None, None])
    return mask


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_positions: Optional[torch.Tensor] = None,
                   kv_valid_len: Optional[Index] = None) -> torch.Tensor:
    """Grouped-query scaled dot-product attention.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd). ``q_positions`` are the
    absolute positions of the queries (causal masking against a cache,
    (Sq,) or ragged (B, Sq)); ``kv_valid_len`` masks unwritten cache slots
    (scalar or (B,)). The products take their operands in float32, as the
    reference's ``preferred_element_type=float32`` einsums accumulate."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    # 1/sqrt(hd) rounded to float32, as the reference (and K3) computes it
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd)))).item()
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    mask = attention_mask(b, sq, skv, causal=causal, q_positions=q_positions,
                          kv_valid_len=kv_valid_len, device=q.device)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    # Lean softmax: exponentials materialize once (in v's dtype); the
    # normalizer divides the (S x hd) output instead of the (S x S) weights.
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m).to(v.dtype)
    l = p.sum(-1, dtype=torch.float32)                     # (b,k,g,s)
    out = torch.einsum("bkgst,btkh->bskgh", p.float(), v.float())
    out = out / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype).reshape(b, sq, hq, hd)


def cache_update(buf: torch.Tensor, new: torch.Tensor, idx: Index) -> None:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S_max, ...) in place at
    offset ``idx``: an int or 0-d tensor (uniform slice) or a (B,) tensor
    (per-row scatter, the continuous-batching path; needs s == 1)."""
    new = new.to(buf.dtype)
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        if new.shape[1] != 1:
            raise ValueError(f"a per-row write takes one position, got "
                             f"{new.shape[1]}")
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, idx.to(buf.device).long()] = new[:, 0]
        return
    i = int(idx)
    if not 0 <= i <= buf.shape[1] - new.shape[1]:
        raise ValueError(f"cannot write {new.shape[1]} positions at {i} into "
                         f"a cache of {buf.shape[1]}")
    buf[:, i:i + new.shape[1]] = new


def _sdpa(cfg: ModelConfig, q, k, v, *, causal, q_positions=None,
          kv_valid_len=None):
    if cfg.attention_impl == "kernel":
        if q.shape[1] == 1 and kv_valid_len is not None:
            return kops.decode_attention(q, k, v, kv_valid_len)
        if q_positions is None and kv_valid_len is None:
            return kops.flash_attention(q, k, v, causal=causal)
    elif cfg.attention_impl != "reference":
        raise ValueError(f"attention_impl must be 'kernel' or 'reference', "
                         f"got {cfg.attention_impl!r}")
    return sdpa_reference(q, k, v, causal=causal, q_positions=q_positions,
                          kv_valid_len=kv_valid_len)


def _qkv_heads(q, k, v, positions, theta, hd):
    q = apply_rope(q.unflatten(-1, (-1, hd)), positions, theta)
    k = apply_rope(k.unflatten(-1, (-1, hd)), positions, theta)
    return q, k, v.unflatten(-1, (-1, hd))


def qkv_heads(q, k, v, positions: torch.Tensor, theta: float, hd: int):
    """The projections ``q`` (B, S, Hq hd), ``k`` and ``v`` (B, S, Hkv hd)
    split into heads of ``hd``, RoPE on q and k: a region (one logical
    ``heads`` axis for all three, so q's heads replicate where the KV
    heads cannot shard)."""
    packed = ("batch", None, ("heads", hd))
    heads = ("batch", None, "heads", None)
    return local_region(_qkv_heads, (packed, packed, packed,
                                     ("batch", None), None, None),
                        (heads, heads, heads))(q, k, v, positions, theta, hd)


def _attend(sdpa, q, k, v, causal, q_positions, kv_valid_len):
    return sdpa(q, k, v, causal=causal, q_positions=q_positions,
                kv_valid_len=kv_valid_len).flatten(-2)


def attend(sdpa, q, k, v, *, causal: bool,
           q_positions: Optional[torch.Tensor] = None,
           kv_valid_len: Optional[Index] = None) -> torch.Tensor:
    """``sdpa(q, k, v, ...)`` with the heads merged, (B, Sq, Hq hd): a
    region, each rank's query heads against their own KV heads (q and the
    KV heads shard together or both replicate); the masks' positions and
    lengths enter by batch."""
    heads = ("batch", None, "heads", None)
    return local_region(
        _attend, (None, heads, heads, heads, None, ("batch", None),
                  ("batch",)),
        (("batch", None, ("heads", q.shape[-1])),))(
            sdpa, q, k, v, causal, q_positions, kv_valid_len)


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    cache: Optional[LayerCache] = None,
                    cache_index: Optional[Index] = None) -> torch.Tensor:
    """Attention block body (no norms or residual: the block wires those).

    ``cache``: the layer's (k, v) views, written in place at
    ``cache_index`` (0 when None) before the queries attend to the first
    ``cache_index + s`` positions; None attends within ``x`` only.
    """
    s = x.shape[1]
    q, k, v = qkv_heads(p.wq(x), p.wk(x), p.wv(x), positions,
                        cfg.rope_theta, cfg.resolved_head_dim)
    sdpa = functools.partial(_sdpa, cfg)
    if cache is not None:
        idx = cache_index if cache_index is not None else 0
        ck, cv = cache
        cache_update(ck, k, idx)
        cache_update(cv, v, idx)
        out = attend(sdpa, q, ck, cv, causal=cfg.causal,
                     q_positions=positions, kv_valid_len=idx + s)
    else:
        out = attend(sdpa, q, k, v, causal=cfg.causal)
    return p.wo(out)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device="cuda",
                  n_layers: Optional[int] = None):
    """Stacked per-layer KV cache: ``{"k", "v"}``, each
    ``(L, B, S_max, Hkv, hd)`` zeros on ``device``."""
    hd = cfg.resolved_head_dim
    layers = n_layers if n_layers is not None else cfg.n_layers
    shape = (layers, batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
