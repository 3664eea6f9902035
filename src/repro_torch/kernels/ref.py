"""Plain PyTorch versions of the port's kernels.

Each one computes its kernel's function with ordinary tensor operations.
The CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold
them against the reference's kernels, and ``chip_smoke.py`` holds each
CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch


def rls_rank1_update_ref(P: torch.Tensor, phi: torch.Tensor,
                         lam: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched RLS gain and forgetting-factor covariance update.

    ``P`` is ``(B, k, k)``, ``phi`` ``(B, k)``, ``lam`` ``(B,)``; returns
    ``(g, P')`` with ``g = Pφ / (λ + φᵀPφ)`` and ``P' = (P − g(Pφ)ᵀ) / λ``.
    """
    Pphi = (P * phi[:, None, :]).sum(-1)
    denom = lam + (phi * Pphi).sum(-1)
    gain = Pphi / denom[:, None]
    pnew = (P - gain[:, :, None] * Pphi[:, None, :]) / lam[:, None, None]
    return gain, pnew


def fused_tick_ref(lag: torch.Tensor, lag_add: torch.Tensor,
                   rates: torch.Tensor, cap: torch.Tensor,
                   down_pre: torch.Tensor, w: torch.Tensor, P: torch.Tensor,
                   y_prev: torch.Tensor, lam: float, thresh: float, dt: float):
    """One fused-engine tick: consumer-lag update, anomaly-detector observe
    and rank-1 RLS update.

    The lag update is :func:`repro_torch.dsp.simulator.step_batch_arrays`'
    arithmetic, expression for expression, so the engine's lag carry (from
    this tick) and its metrics (from ``step_batch_arrays``) agree bit for
    bit. The detector is an AR(1)+bias RLS predictor on ``y = log1p(lag)``;
    ``flag`` marks prediction errors beyond ``thresh``.

    Shapes: ``lag/lag_add/rates/cap/down_pre/y_prev`` are ``(B,)``
    (``down_pre`` bool), ``w`` is ``(B, 2)``, ``P`` is ``(B, 2, 2)``.
    Returns ``(new_lag, w', P', err, flag)``.
    """
    lag0 = lag + lag_add
    demand = rates * dt + lag0
    processed = torch.minimum(cap * dt, demand)
    new_lag = torch.where(down_pre, lag0 + rates * dt, demand - processed)

    y = torch.log1p(new_lag)
    phi = torch.stack([torch.ones_like(y_prev), y_prev], dim=-1)
    err = y - (w * phi).sum(-1)
    flag = err.abs() > thresh
    gain, pnew = rls_rank1_update_ref(P, phi, torch.full_like(y, lam))
    w2 = w + gain * err[:, None]
    return new_lag, w2, pnew, err, flag


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token grouped-query attention over each row's first
    ``lengths[b]`` cache entries: the model's plain attention
    (:func:`repro_torch.models.attention.sdpa_reference`, which casts the
    normalised softmax weights to v's dtype before the weighted sum; the
    CUDA kernel rounds its unnormalised weights to bf16 instead, and keeps
    them in float32 for float32), with rows of length 0 set to zeros.

    q: ``(B, 1, Hq, D)``; k, v: ``(B, S_max, Hkv, D)`` with ``Hq = G·Hkv``
    (query head ``h·G + g`` reads KV head ``h``); lengths: an int, a 0-d
    tensor or ``(B,)``, clamped to ``[0, S_max]``. Returns ``(B, 1, Hq, D)``.

    A row of length 0 returns zeros, as the reference's Pallas kernel does
    (it skips every block). The reference's oracle
    ``repro/kernels/ref.py::decode_attention_ref`` returns the mean of all
    of V there instead, since it masks every score and then normalises; the
    two agree at every length >= 1, and serving never asks for length 0.
    """
    from ..models.attention import sdpa_reference  # models import kernels
    lengths = torch.as_tensor(lengths, device=q.device)
    out = sdpa_reference(q, k, v, causal=False, kv_valid_len=lengths)
    empty = (lengths <= 0).reshape(-1, 1, 1, 1)
    return out.masked_fill(empty, 0.0)


#: the reference's NEG_INF: the masked score, and a chunk's empty maximum
NEG_INF = -2.0 ** 30


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: Union[int, torch.Tensor],
                               n_split: int) -> torch.Tensor:
    """K3's split-and-merge algorithm in plain torch, float32 throughout:
    the function of :func:`decode_attention_ref`, computed as the CUDA
    kernel computes it. Nothing on the serving path calls it; the tests
    hold it against :func:`decode_attention_ref` and the reference's
    Pallas kernel.

    Each row's cache is cut into ``n_split`` chunks of ``ceil(S_max /
    n_split)`` positions. Chunk ``i`` keeps its own softmax state over its
    valid positions: ``m_i`` (the largest scaled score, ``NEG_INF`` when
    the chunk holds none), ``l_i`` (the sum of ``exp(s - m_i)``, 0 when
    empty) and ``o_i`` (the weighted sum of V, zeros when empty). The
    merge takes ``m = max m_i``, rescales every chunk by ``exp(m_i - m)``
    and adds them in chunk order, then divides by ``max(l, 1e-30)``: a row
    of length 0 gives zeros. Shapes as :func:`decode_attention_ref`.
    """
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk = -(-S // n_split)
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1)
    lengths = lengths.expand(B).clamp(0, S)
    qf = q[:, 0].float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float()) / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    valid = valid[:, None, None, :]                      # (B, 1, 1, S)
    s = torch.where(valid, s, NEG_INF)
    vf = v.float()
    states = []
    for i in range(n_split):      # each chunk's own softmax state
        sl = slice(i * chunk, min((i + 1) * chunk, S))
        s_i = s[..., sl]
        m_i = s_i.amax(-1, keepdim=True)          # NEG_INF when empty
        p_i = torch.where(valid[..., sl], torch.exp(s_i - m_i), 0.0)
        states.append((m_i, p_i.sum(-1, keepdim=True),
                       torch.einsum("bhgt,bthd->bhgd", p_i, vf[:, sl])))
    m = torch.stack([m_i for m_i, _, _ in states]).amax(0)
    l = torch.zeros_like(m)
    o = torch.zeros((B, Hkv, G, D), device=q.device)
    for m_i, l_i, o_i in states:  # the merge, in chunk order
        f = torch.exp(m_i - m)
        l = l + l_i * f
        o = o + o_i * f
    out = o / l.clamp_min(1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool) -> torch.Tensor:
    """Grouped-query attention without a cache: the model's plain attention
    (:func:`repro_torch.models.attention.sdpa_reference`) with no positions
    and no lengths, as the reference's oracle
    ``repro/kernels/ref.py::flash_attention_ref``.

    q: ``(B, Sq, Hq, D)``; k, v: ``(B, Skv, Hkv, D)`` with ``Hq = G·Hkv``
    (query head ``h`` reads KV head ``h // G``). ``causal`` is top-left
    aligned: query row i sees key columns j <= i, as in the Pallas kernel.
    Scores and sums are float32; the softmax weights are cast to v's dtype
    before the weighted sum. Returns ``(B, Sq, Hq, D)`` in v's dtype.
    """
    from ..models.attention import sdpa_reference  # models import kernels
    return sdpa_reference(q, k, v, causal=causal)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's chunked SSD scan (state-space duality) from a zero state:
    ``repro/models/mamba2.py::ssd_chunked_reference`` operation for
    operation, in float32.

    x: ``(B, S, H, P)``; dt: ``(B, S, H)``; a_log: ``(H,)``; b, c:
    ``(B, S, G, N)`` with the H heads split evenly over G groups (head h
    reads group ``h // (H / G)``); ``S % chunk == 0``. Returns ``(y (B, S,
    H, P) in x's dtype, final_state (B, H, P, N) float32)``.

    Per chunk of Q positions: the intra-chunk dual (attention-like) form,
    the readout of the state carried in from earlier chunks, and the state
    update. The decay between positions is ``exp(cum_i - cum_j)`` over the
    chunk's cumulative log-decay; above the diagonal it is dropped by the
    ``where`` (there it may overflow to inf, and the ``where`` keeps the
    inf out of the sum).
    """
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if seq % chunk:
        raise ValueError(f"sequence length {seq} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc, q = seq // chunk, chunk
    rep = h // g

    a = -torch.exp(a_log.float())                            # (H,) negative
    dtf = dt.float()
    da = (dtf * a).reshape(bsz, nc, q, h)                    # log-decay/step
    cum = torch.cumsum(da, dim=2)                            # (B,NC,Q,H)

    xdt = (x.float() * dtf[..., None]).reshape(bsz, nc, q, h, p)
    bg = b.float().reshape(bsz, nc, q, g, n)
    cg = c.float().reshape(bsz, nc, q, g, n)

    # Intra-chunk dual form: scores shared per group, decay per head.
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cg, bg)          # (B,NC,G,Q,Q)
    cb = cb.repeat_interleave(rep, dim=2)                    # (B,NC,H,Q,Q)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # q - k
    l = torch.exp(li.permute(0, 1, 4, 2, 3))                 # (B,NC,H,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    m = torch.where(mask, cb * l, 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", m, xdt)

    # Chunk-final states + inter-chunk linear recurrence.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,NC,Q,H)
    bh = bg.repeat_interleave(rep, dim=3).reshape(bsz, nc, q, h, n)
    states = torch.einsum("bckh,bckhp,bckhn->bchpn", decay_to_end, xdt, bh)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,NC,H)

    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for i in range(nc):
        h_prevs.append(state)
        state = chunk_decay[:, i, :, None, None] * state + states[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,NC,H,P,N)

    ch = cg.repeat_interleave(rep, dim=3).reshape(bsz, nc, q, h, n)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", ch, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, seq, h, p)
    return y.to(x.dtype), state


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       tile_expert: torch.Tensor, blk_m: int
                       ) -> torch.Tensor:
    """Expert-grouped matmul: ``out[i] = lhs[i] @ rhs[tile_expert[i //
    blk_m]]``, a loop over the M-tiles as the reference's oracle
    ``repro/kernels/ref.py::grouped_matmul_ref``, each product in float32
    and rounded once to lhs's dtype. A tile whose expert id is negative
    (past the last group of a statically sized buffer) is zeros.

    lhs: ``(M, K)`` with ``M = len(tile_expert) * blk_m``; rhs: ``(E, K,
    N)``; tile_expert: ``(M / blk_m,)`` integers. Returns ``(M, N)``.
    """
    m = lhs.shape[0]
    if m != tile_expert.numel() * blk_m:
        raise ValueError(f"lhs has {m} rows, tile_expert "
                         f"{tile_expert.numel()} tiles of {blk_m}")
    out = torch.zeros((m, rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
    for t, e in enumerate(tile_expert.tolist()):
        if e >= 0:
            rows = slice(t * blk_m, (t + 1) * blk_m)
            out[rows] = (lhs[rows].float() @ rhs[e].float()).to(lhs.dtype)
    return out


def fused_rmsnorm_ref(x: torch.Tensor, res: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add and RMSNorm, the reference's oracle
    ``repro/kernels/ref.py::fused_rmsnorm_ref``: ``s = x + res`` in
    float32, ``y = s · rsqrt(mean(s²) + eps) · (1 + scale)``; returns
    ``(y, s)``, both rounded once to x's dtype. x, res: ``(..., d)``;
    scale: ``(d,)``."""
    s = x.float() + res.float()
    var = s.square().mean(-1, keepdim=True)
    y = s * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(x.dtype), s.to(x.dtype)
