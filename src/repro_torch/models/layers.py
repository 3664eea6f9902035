"""Shared neural building blocks of the models.

The port of ``repro/models/layers.py``: plain functions on tensors that
keep the reference's casts operation for operation (so bfloat16 rounds
where the reference rounds), and the ``nn.Module``s that hold their
parameters. Weights keep the reference's layouts — a dense layer's ``w``
is ``(d_in, d_out)`` and computes ``x @ w`` — so the reference's parameters
carry across unchanged (:func:`repro_torch.interop.model_params_from_reference`).

Initialisation is seeded: every module draws from an explicit
``torch.Generator`` on the device it is built on. Its numbers differ from
``jax.random``'s; tests that compare the two packages carry the
reference's parameters across instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..distributed.sharding import (is_sharded, local_region, region_block,
                                    shard)


def _normal(shape, scale: float, *, generator: torch.Generator,
            dtype: torch.dtype, device) -> nn.Parameter:
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(generator=generator)
    return nn.Parameter(w.mul_(scale))


# -- dense -------------------------------------------------------------------
class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.dim() > 2 and (is_sharded(x) or is_sharded(w)):
        # matmul's fold of the leading dimensions with views (its own, and
        # the reshape of a strided gradient, end in aten._unsafe_view,
        # whose sharding rules differ across PyTorch versions). Plain
        # tensors keep x @ w: the fold's three more calls cost 4.6 us of
        # host time a projection and 1.1% of a qwen2-7b decode step on an
        # H100 80GB HBM3 at 700 W (scripts/dense_fold_ab.py)
        y = (x.contiguous().view(-1, x.shape[-1]) @ w).view(
            *x.shape[:-1], w.shape[-1])
        if y.requires_grad:
            y = _ContiguousGrad.apply(y)
    else:
        y = x @ w
    if b is not None:
        y = y + b
    return y


class Dense(nn.Module):
    """``x @ w (+ b)``; ``w`` is ``(d_in, d_out)``, drawn from N(0, 1/d_in)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator: torch.Generator, dtype: torch.dtype, device,
                 scale: Optional[float] = None):
        super().__init__()
        scale = float(scale) if scale is not None else float(d_in) ** -0.5
        self.w = _normal((d_in, d_out), scale, generator=generator,
                         dtype=dtype, device=device)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


# -- norms -------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Gemma-style RMSNorm, ``x / rms(x) * (1 + scale)``: the statistic in
    float32, the rescale in ``x``'s dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * (1.0 + scale).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (``scale`` starts at 0, applied as ``1 + scale``) or
    LayerNorm (``scale`` 1, ``bias`` 0), by ``kind``."""

    def __init__(self, kind: str, d: int, *, dtype: torch.dtype, device):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind
        if kind == "rmsnorm":
            self.scale = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                  device=device))
        else:
            self.scale = nn.Parameter(torch.ones(d, dtype=dtype,
                                                 device=device))
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale)
        return layernorm(x, self.scale, self.bias)


# -- RoPE --------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate pairs ``(x[..., ::2], x[..., 1::2])`` in float32 and cast
    back. x: ``(..., seq, heads, hd)``, positions: ``(..., seq)``."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# -- activations ---------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    operation rounding in x's dtype: the reference's ``jax.nn.silu`` as XLA
    computes it. In bfloat16, ``F.silu`` (one rounding) differs from it by
    an ulp in about a quarter of the values, which a mamba2 layer's chain
    of bfloat16 operations carries to its output."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU, ``x * 0.5 * (1 + tanh(c0 * (x + c1 * x**3)))``, as
    ``jax.nn.gelu(approximate=True)`` computes it: its constants rounded to
    x's dtype and every operation rounding there. In bfloat16,
    ``F.gelu(approximate="tanh")`` (one rounding) differs from it by an ulp
    in about 45% of the values."""
    c0 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype).item()
    c1 = torch.tensor(0.044715, dtype=x.dtype).item()
    cdf = 0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * x * x))))
    return x * cdf


# -- gated MLPs ---------------------------------------------------------------
def mlp(x: torch.Tensor, kind: str, up: Dense, down: Dense,
        gate: Optional[Dense] = None) -> torch.Tensor:
    """SwiGLU, GeGLU (tanh GELU) or plain tanh-GELU feed-forward, with the
    reference's activations (:func:`silu`, :func:`gelu_tanh`), which round
    where ``jax.nn`` rounds."""
    if kind == "swiglu":
        h = silu(gate(x)) * up(x)
    elif kind == "geglu":
        h = gelu_tanh(gate(x)) * up(x)
    elif kind == "gelu":
        h = gelu_tanh(up(x))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return down(shard(h, "batch", None, "mlp"))


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, kind: str, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        self.kind = kind
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.gate = (Dense(d_model, d_ff, **kw)
                     if kind in ("swiglu", "geglu") else None)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.kind, self.up, self.down, self.gate)


# -- embeddings ---------------------------------------------------------------
def _lookup(table: torch.Tensor, tokens: torch.Tensor,
            scale_by_dim: bool) -> torch.Tensor:
    block, blocks = region_block("vocab")
    if blocks == 1:
        h = table[tokens]
    else:  # this rank's block of rows: its tokens' rows, zeros for the rest
        rows = table.shape[0]
        local = tokens - block * rows
        inside = (local >= 0) & (local < rows)
        h = table[local.clamp(0, rows - 1)] * inside[..., None].to(
            table.dtype)
    if scale_by_dim:  # gemma multiplies embeddings by sqrt(d_model)
        h = h * torch.sqrt(torch.tensor(h.shape[-1], dtype=h.dtype,
                                        device=h.device))
    return h


def embed(table: torch.Tensor, tokens: torch.Tensor, *,
          scale_by_dim: bool = False) -> torch.Tensor:
    """``table[tokens]``; in a sharding context a vocab-parallel lookup
    (a region): each rank looks up the tokens in its block of rows, and the
    result is a partial sum over the vocab's axes (a vocab that does not
    divide them is replicated, and the lookup plain)."""
    return local_region(_lookup, (("vocab", None), ("batch", None), None),
                        (("batch", None, None),), partial=("vocab",))(
                            table, tokens, scale_by_dim)


def unembed(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return dense(h, table.T)


# -- losses -------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross-entropy in float32, with an optional z-loss
    (``z_loss * lse**2``) and a mask (the masked sum over
    ``max(sum(mask), 1)``); the reference's ``softmax_cross_entropy``."""
    # DTensor has no gather along a sharded vocab (inside a sharding
    # context the logits shard it): replicate the vocab first, an identity
    # outside a context
    logits = shard(logits, "batch", None, None).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss > 0.0:
        loss = loss + z_loss * lse.square()
    if mask is not None:
        mask = mask.float()
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)
    return loss.mean()


class Embedding(nn.Module):
    """Token table ``(vocab, d_model)`` drawn from N(0, 0.02²)."""

    def __init__(self, vocab: int, d_model: int, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        self.table = _normal((vocab, d_model), 0.02, generator=generator,
                             dtype=dtype, device=device)
