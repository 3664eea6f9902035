"""Mixture-of-Experts FFN (DeepSeekMoE-style: shared and fine-grained
routed experts).

The port of ``repro/models/moe.py``. Routing runs in float32: softmax over
the router's logits, the top-k experts of each token (ties to the lower
expert id, as ``jax.lax.top_k`` breaks them), weights renormalised over
the k. Each expert takes at most ``capacity`` assignments, counted in
k-major order so that earlier top-k slots win (``capacity = n`` with
``drop_free``, the decode steps'); a dropped assignment contributes
nothing. The expert FFN has two routes, chosen by ``cfg.attention_impl``:

* ``"reference"``: the reference's capacity buffer. Tokens are scattered
  into an ``(E, C, d)`` buffer (an add of zeros for the dropped ones), the
  stacked expert weights run as three batched products, and each
  assignment's row is gathered back;
* ``"kernel"`` (the default): only the kept assignments, sorted by expert
  into a buffer of static size (:func:`~repro_torch.kernels.grouped_matmul.
  sort_assignments`), run gate, up and down as three expert-grouped
  matmuls (:func:`repro_torch.kernels.ops.grouped_matmul`: kernel K6 on
  the card, its plain version on the CPU), and are gathered back.

Both compute the same function: every kept row meets the same weights with
float32 sums rounded once, and a dropped or padding row meets a weight of
zero. The k weighted rows of a token add in float32 and round once, as
XLA's reduction does. The activations are the reference's
(:func:`~repro_torch.models.layers.silu`, :func:`~repro_torch.models.
layers.gelu_tanh`), rounding where ``jax.nn`` rounds.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import local_region, region_block, shard
from ..kernels import ops as kops
from ..kernels.grouped_matmul import BLOCK_MS, sort_assignments
from .config import ModelConfig
from .layers import MLP, Dense, _normal, dense, gelu_tanh, silu


class ExpertWeight(nn.Module):
    """One projection stacked over the experts, ``w`` (E, d_in, d_out),
    drawn from N(0, 1/d_in)."""

    def __init__(self, n: int, d_in: int, d_out: int, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        self.w = _normal((n, d_in, d_out), float(d_in) ** -0.5,
                         generator=generator, dtype=dtype, device=device)


class Experts(nn.Module):
    """The routed experts' stacked ``gate`` (gated kinds only), ``up`` and
    ``down`` projections."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        e = cfg.moe
        kw = dict(generator=generator, dtype=dtype, device=device)
        gated = cfg.mlp_kind in ("swiglu", "geglu")
        self.gate = (ExpertWeight(e.n_routed, cfg.d_model, e.d_expert, **kw)
                     if gated else None)
        self.up = ExpertWeight(e.n_routed, cfg.d_model, e.d_expert, **kw)
        self.down = ExpertWeight(e.n_routed, e.d_expert, cfg.d_model, **kw)


class MoE(nn.Module):
    """The router ``(d_model, E)``, the routed experts and, where the config
    has shared experts, one always-on MLP of width ``n_shared * d_expert``
    (the reference's ``moe_init``)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        e = cfg.moe
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.router = Dense(cfg.d_model, e.n_routed, **kw)
        self.experts = Experts(cfg, **kw)
        self.shared = (MLP(cfg.d_model, e.n_shared * e.d_expert,
                           cfg.mlp_kind, **kw) if e.n_shared > 0 else None)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none among ties)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def block_m(assignments: int, n_experts: int) -> int:
    """The kernel route's M-tile: the smallest of
    :data:`~repro_torch.kernels.grouped_matmul.BLOCK_MS` that holds a mean
    group of ``assignments / n_experts`` rows (at most 128). A decode step
    (16 tokens x top-6 over 64 experts) takes 16, so a group of one or two
    rows is not padded to 128; a 2048-token prompt takes 128."""
    mean = assignments / n_experts
    return next((b for b in BLOCK_MS if b >= mean), BLOCK_MS[-1])


def _activation(kind: str):
    return silu if kind == "swiglu" else gelu_tanh


def _expert_ffn(gate, up, down, h: torch.Tensor, kind: str) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d) through the stacked expert weights."""
    def proj(x, w):
        return torch.einsum("ecd,edf->ecf", x, w)
    if kind in ("swiglu", "geglu"):
        inner = _activation(kind)(proj(h, gate)) * proj(h, up)
    else:
        inner = gelu_tanh(proj(h, up))
    return proj(inner, down)


def _routed_buffer(kind: str, top_k: int, capacity: int, x, flat_e,
                   flat_pos, keep, flat_w, gate, up, down) -> torch.Tensor:
    """The reference's route: scatter the tokens of x (..., d) into (E, C,
    d), the batched expert FFN, gather each assignment's weighted row back
    and add a token's k rows in float32: x's shape, float32.

    In a region each rank holds a block of the experts and takes a block
    of each one's capacity rows (:func:`region_block`): it fills and runs
    only those rows, and an assignment outside them adds a zero row, so
    the ranks' results are partial sums."""
    xt = x.reshape(-1, x.shape[-1])
    n_exp, n = up.shape[0], xt.shape[0]
    e_blk, e_count = region_block("experts")
    c_blk, c_count = region_block("batch")
    rows = -(-capacity // c_count)
    if e_count * c_count > 1:
        e0, c0 = e_blk * n_exp, c_blk * rows
        keep = keep & (flat_e >= e0) & (flat_e < e0 + n_exp) \
            & (flat_pos >= c0) & (flat_pos < c0 + rows)
        flat_e = torch.where(keep, flat_e - e0, 0)
        flat_pos = flat_pos - c0
        flat_w = flat_w * keep
    token_idx = torch.arange(n, device=xt.device).repeat(top_k)
    safe_pos = torch.where(keep, flat_pos, rows - 1)
    buf = xt.new_zeros((n_exp, rows, xt.shape[1]))
    # an add, not a write: a dropped assignment adds zeros at rows - 1
    buf.index_put_((flat_e, safe_pos),
                   xt[token_idx] * keep[:, None].to(xt.dtype),
                   accumulate=True)
    h = _expert_ffn(gate, up, down, buf, kind)
    y = h[flat_e, safe_pos] * flat_w[:, None].to(xt.dtype)
    return y.reshape(top_k, *x.shape).sum(0, dtype=torch.float32)


def _routed_sorted(ex: Experts, kind: str, xt, flat_e, keep, token_idx,
                   flat_w) -> torch.Tensor:
    """The kernel route: the kept assignments sorted by expert through
    three expert-grouped matmuls, each assignment's weighted row gathered
    back (a dropped one reads some row times a weight of zero). (k n, d)."""
    n_experts = ex.up.w.shape[0]
    blk = block_m(flat_e.numel(), n_experts)
    srt = sort_assignments(flat_e, keep, n_experts, blk)
    lhs = xt.new_zeros((srt.rows + 1, xt.shape[1]))
    lhs[srt.dest] = xt[token_idx]          # dropped ones land on row `rows`
    lhs = lhs[:srt.rows]

    def gmm(x, w):
        return kops.grouped_matmul(x, w.w, srt.tile_expert, blk_m=blk)
    if kind in ("swiglu", "geglu"):
        inner = _activation(kind)(gmm(lhs, ex.gate)) * gmm(lhs, ex.up)
    else:
        inner = gelu_tanh(gmm(lhs, ex.up))
    out = gmm(inner, ex.down)
    return out[srt.dest.clamp(max=srt.rows - 1)] \
        * flat_w[:, None].to(xt.dtype)


def _route(e, logits: torch.Tensor, capacity: int, with_aux: bool):
    """Routing in float32 from the router's logits (..., E) of N tokens:
    each
    assignment's expert, position in its expert's buffer (k-major, so that
    earlier top-k slots win capacity), whether it is kept and its weight,
    each (k N,); ``with_aux``, also the Switch-style load-balancing loss
    and the router z-loss."""
    logits = logits.reshape(-1, logits.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, e.top_k)                     # (N, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_i.T.reshape(-1)                             # (k N,)
    onehot = F.one_hot(flat_e, e.n_routed)
    flat_pos = (torch.cumsum(onehot, 0) * onehot - 1).amax(-1)
    keep = flat_pos < capacity
    flat_w = top_w.T.reshape(-1) * keep
    if not with_aux:
        return flat_e, flat_pos, keep, flat_w
    me = probs.mean(0)                                       # (E,)
    ce = F.one_hot(top_i, e.n_routed).float().mean((0, 1)) * e.top_k
    return (flat_e, flat_pos, keep, flat_w,
            e.aux_loss_coef * e.n_routed * (me * ce).sum(),
            e.router_z_loss * torch.logsumexp(logits, -1).square().mean())


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
              drop_free: bool = False, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (..., d) -> (y in x's shape and dtype, {"moe_aux_loss",
    "moe_z_loss"} as float32 scalars). Routing in float32.

    ``drop_free`` sizes the capacity at the worst case (``n`` tokens), so
    no assignment is ever dropped: the decode steps' setting, where
    capacity dropping would make a token's output depend on its batch.
    ``with_aux=False`` skips the two losses and returns None in their
    place: only training reads them, and serving would pay their launches
    in every layer and step."""
    e = cfg.moe
    d = x.shape[-1]
    n = x.numel() // d
    # the tokens keep their leading dimensions: a DTensor's reshape, and
    # the gradients' on the way back, stays inside the regions
    logits = dense(x, p.router.w).float()                    # (..., E)
    capacity = n if drop_free else max(
        math.ceil(n * e.top_k * e.capacity_factor / e.n_routed), e.top_k)
    capacity = min(capacity, n)
    # routing sees every token (the capacity counts them in order)
    flat = (None,)
    routed = local_region(_route, (None, (None,) * logits.ndim, None, None),
                          (flat,) * 4 + (((), ()) if with_aux else ()))(
                              e, logits, capacity, with_aux)
    flat_e, flat_pos, keep, flat_w = routed[:4]

    if cfg.attention_impl == "kernel":
        token_idx = torch.arange(n, device=x.device).repeat(e.top_k)
        y = _routed_sorted(p.experts, cfg.mlp_kind, x.reshape(-1, d), flat_e,
                           keep, token_idx, flat_w)
        y = y.reshape(e.top_k, *x.shape).sum(0, dtype=torch.float32)
    elif cfg.attention_impl == "reference":
        ex = p.experts
        stacked = ("experts", None, None)
        tokens = (None,) * x.ndim
        # sharding E on "model" is expert parallelism: each rank runs its
        # experts over all tokens (gathered on the batch axes), the
        # capacity rows split over those axes
        y = local_region(_routed_buffer, (None,) * 3 + (tokens,) + (flat,) * 4
                         + (stacked,) * 3, (tokens,),
                         partial=("experts", "batch"))(
            cfg.mlp_kind, e.top_k, capacity, x, flat_e, flat_pos, keep,
            flat_w, None if ex.gate is None else ex.gate.w, ex.up.w,
            ex.down.w)
    else:
        raise ValueError(f"attention_impl must be 'kernel' or 'reference', "
                         f"got {cfg.attention_impl!r}")
    y = shard(y, "batch", None, "embed").to(x.dtype)
    if p.shared is not None:
        y = y + p.shared(x)
    if not with_aux:
        return y, None
    return y, {"moe_aux_loss": routed[4], "moe_z_loss": routed[5]}
