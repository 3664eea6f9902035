"""Mamba2 SSD mixer (state-space duality, arXiv:2405.21060).

The port of ``repro/models/mamba2.py``. A prefill runs the chunked scan:
within a chunk the dual (attention-like) quadratic form, across chunks a
linear recurrence on the per-head state ``(H, P, N)``. With
``cfg.attention_impl == "kernel"`` the scan goes through
:func:`repro_torch.kernels.ops.ssd_scan` (kernel K5 on the card, its plain
version on the CPU), as the reference's ``"pallas"`` goes to its Pallas
kernel. Decode is the one-token recurrence on the cached state, in plain
torch, as in the reference.

The input projection is split into (z, x, BC, dt) weights, as in the
reference, so its parameters carry across leaf for leaf; ``a_log``,
``dt_bias`` and ``d_skip`` stay float32 in a bfloat16 model.

The cache is a layer's views of the model's arena (:class:`MambaCache`),
written in place. A sequence starts from zero state: a prefill at cursor 0
ignores what the slot held before. (The reference's prefill pads its conv
with the cache's conv state and sends a one-token prompt through the
recurrence on the cached SSD state, so a request admitted into a reused
slot reads the previous occupant's state; and its multi-token prefill at a
cursor > 0 restarts the scan from zeros. The port refuses the latter.)
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import local_region
from ..kernels import ops as kops
from ..kernels.ref import ssd_scan_ref
from .attention import Index
from .config import ModelConfig
from .layers import Dense, Norm, _normal, rmsnorm, silu


class MambaCache(NamedTuple):
    """A layer's decode state, views into the model's arena."""
    conv_x: torch.Tensor     # (B, d_conv - 1, d_in) float32
    conv_bc: torch.Tensor    # (B, d_conv - 1, 2 G N) float32
    ssd: torch.Tensor        # (B, H, P, N) float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    gn = 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, gn


class Mamba2(nn.Module):
    """The mixer's parameters (the reference's ``mamba2_init``): the
    (z, x, BC, dt) projections, the depthwise convs, the per-head decay
    ``a_log`` (A uniform in [1, 16]), ``dt_bias`` (softplus⁻¹ of a
    log-uniform dt in [dt_min, dt_max]), the skip ``d_skip``, the gated
    RMSNorm and the output projection."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype, device):
        super().__init__()
        s, d_in, n_heads, gn = _dims(cfg)
        kw = dict(generator=generator, dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_z = Dense(cfg.d_model, d_in, **kw)
        self.in_x = Dense(cfg.d_model, d_in, **kw)
        self.in_bc = Dense(cfg.d_model, gn, **kw)
        self.in_dt = Dense(cfg.d_model, n_heads, **kw)
        self.conv_x_w = _normal((s.d_conv, d_in), 0.1, **kw)
        self.conv_x_b = nn.Parameter(torch.zeros(d_in, dtype=dtype,
                                                 device=device))
        self.conv_bc_w = _normal((s.d_conv, gn), 0.1, **kw)
        self.conv_bc_b = nn.Parameter(torch.zeros(gn, dtype=dtype,
                                                  device=device))
        dt = torch.empty(n_heads, **f32).uniform_(
            math.log(s.dt_min), math.log(s.dt_max),
            generator=generator).exp_()
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        a = torch.empty(n_heads, **f32).uniform_(1.0, 16.0,
                                                 generator=generator)
        self.a_log = nn.Parameter(torch.log(a))
        self.d_skip = nn.Parameter(torch.ones(n_heads, **f32))
        self.norm = Norm("rmsnorm", d_in, dtype=dtype, device=device)
        self.out_proj = Dense(d_in, cfg.d_model, **kw)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width ``K = w.shape[0]`` then SiLU. x:
    ``(B, S, CH)``, w: ``(K, CH)``; ``conv_state`` ``(B, K-1, CH)`` holds
    the previous K-1 inputs (zeros when None). Returns ``(out, new_state)``
    with ``new_state`` the last K-1 inputs."""
    k, s = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)
    out = full[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + full[:, i:i + s] * w[i]
    new_state = full[:, full.shape[1] - (k - 1):]
    return silu(out + b), new_state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state: (B, H, P, N) float32; x: (B, H, P); dt:
    (B, H); b, c: (B, G, N). Returns ``(y (B, H, P) in x's dtype,
    state)``, the state updated in place (the reference returns a new
    array; the cache's state is 2 MB per sequence and layer at
    mamba2-1.3b)."""
    h, g = x.shape[1], b.shape[1]
    rep = h // g
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    decay = torch.exp(dtf * a)                               # (B, H)
    bh = b.float().repeat_interleave(rep, dim=1)             # (B, H, N)
    ch = c.float().repeat_interleave(rep, dim=1)
    xdt = x.float() * dtf[..., None]
    state.mul_(decay[..., None, None]).addcmul_(xdt[..., None],
                                                bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    return y.to(x.dtype), state


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` zero positions appended, contiguous."""
    if not pad:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def _starts_sequence(cache_index: Optional[Index]) -> bool:
    """Whether a call at ``cache_index`` begins a new sequence: a uniform
    cursor of 0. Per-row ages (ragged decode) always continue."""
    if cache_index is None:
        return True
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() > 0:
        return False
    return int(cache_index) == 0


def _ssd_heads(cfg: ModelConfig, xr, bc, dt, dt_bias, a_log, d_skip,
               ssd: Optional[torch.Tensor], fresh: bool) -> torch.Tensor:
    """From the projections after their convs to the skip-added output,
    heads merged: the chunked scan, or with a cache the one-token
    recurrence (``ssd`` updated in place; zeroed first where ``fresh``)."""
    s = cfg.ssm
    seq = xr.shape[1]
    dt = F.softplus(dt.float() + dt_bias)
    half = bc.shape[-1] // 2
    xs = xr.unflatten(-1, (-1, s.head_dim))
    bs = bc[..., :half].unflatten(-1, (s.n_groups, s.d_state))
    cs = bc[..., half:].unflatten(-1, (s.n_groups, s.d_state))

    if ssd is not None and seq == 1:
        if fresh:
            ssd.zero_()
        y, _ = ssd_decode_step(ssd, xs[:, 0], dt[:, 0], a_log, bs[:, 0],
                               cs[:, 0])
        y = y[:, None]
    else:
        # Pad to a chunk multiple; dt = 0 on pads makes them exact no-ops
        # (decay exp(0) = 1, zero input contribution).
        pad = (-seq) % s.chunk
        args = [_pad_seq(t, pad) for t in (xs, dt, bs, cs)]
        if cfg.attention_impl == "kernel":
            y, final = kops.ssd_scan(args[0], args[1], a_log, args[2],
                                     args[3], chunk=s.chunk)
        elif cfg.attention_impl == "reference":
            y, final = ssd_scan_ref(args[0], args[1], a_log, args[2],
                                    args[3], s.chunk)
        else:
            raise ValueError(f"attention_impl must be 'kernel' or "
                             f"'reference', got {cfg.attention_impl!r}")
        y = y[:, :seq]
        if ssd is not None:
            ssd.copy_(final)
    y = y + xs * d_skip[:, None].to(y.dtype)
    return y.flatten(-2)


def mamba2_apply(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[MambaCache] = None,
                 cache_index: Optional[Index] = None) -> torch.Tensor:
    """The mixer on x: (B, S, d_model); returns (B, S, d_model).

    ``cache``: the layer's views, written in place. At a uniform cursor
    ``cache_index`` of 0 (a prefill) the sequence starts from zero conv and
    SSD state, whatever the cache held; a one-token call otherwise
    continues from the cache (decode). A multi-token call at a cursor > 0
    raises.

    The SSD body is a region over the SSM heads (``bc`` replicated: one
    group of B and C serves every head; with more groups the heads do not
    split)."""
    s = cfg.ssm
    seq = x.shape[1]
    fresh = _starts_sequence(cache_index)
    if cache is not None and seq > 1 and not fresh:
        raise NotImplementedError(
            "a multi-token prefill at a cursor > 0 would continue the "
            "sequence's SSD state; the reference restarts the chunked scan "
            "from zeros there (ssd_chunked_reference), so the port refuses "
            "it rather than copy that")
    z = p.in_z(x)
    xr = p.in_x(x)
    bc = p.in_bc(x)
    dt = p.in_dt(x)

    keep = cache is not None and not fresh
    xr, new_cx = _causal_conv(xr, p.conv_x_w, p.conv_x_b,
                              cache.conv_x if keep else None)
    bc, new_cbc = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b,
                               cache.conv_bc if keep else None)

    heads = "ssm_heads" if s.n_groups == 1 else None
    per_head = ("batch", None, (heads, s.head_dim))
    y = local_region(_ssd_heads, (
        None, per_head, ("batch", None, None), ("batch", None, heads),
        (heads,), (heads,), (heads,), ("batch", heads, None, None), None),
        (per_head,))(cfg, xr, bc, dt, p.dt_bias, p.a_log, p.d_skip,
                     None if cache is None else cache.ssd, fresh)
    if cache is not None:
        cache.conv_x.copy_(new_cx)
        cache.conv_bc.copy_(new_cbc)
    y = rmsnorm(y * silu(z), p.norm.scale)
    return p.out_proj(y)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     n_layers: Optional[int] = None, device="cuda"):
    """Stacked per-layer mamba state, zeros on ``device``: ``conv_x``
    ``(L, B, d_conv-1, d_in)`` and ``conv_bc`` ``(L, B, d_conv-1, 2GN)``
    in ``dtype`` (float32 by default, as the reference's), ``ssd``
    ``(L, B, H, P, N)`` float32."""
    s, d_in, n_heads, gn = _dims(cfg)
    layers = n_layers if n_layers is not None else cfg.n_layers
    return {
        "conv_x": torch.zeros((layers, batch, s.d_conv - 1, d_in),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((layers, batch, s.d_conv - 1, gn),
                               dtype=dtype, device=device),
        "ssd": torch.zeros((layers, batch, n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }
