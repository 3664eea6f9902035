"""Plain PyTorch versions of the port's kernels.

Each one computes its kernel's function with ordinary tensor operations.
The CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold
them against the reference's kernels, and ``chip_smoke.py`` holds each
CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple, Union

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


#: The metric keys a fused-engine interval returns, in the order they are
#: stacked (the rows of :func:`fused_interval_ref`'s result).
METRIC_KEYS = ("rate", "throughput", "capacity", "consumer_lag", "latency",
               "utilization", "usage_cpu", "usage_mem_mb", "down")


def fused_interval_ref(model, lag: torch.Tensor, det_w: torch.Tensor,
                       det_p: torch.Tensor, det_y: torch.Tensor,
                       det_trig: torch.Tensor, rates: torch.Tensor,
                       lag_add: torch.Tensor, down_pre: torch.Tensor,
                       down_post: torch.Tensor, z1: torch.Tensor,
                       z2: torch.Tensor, workers: torch.Tensor,
                       cpu_cores: torch.Tensor, memory_mb: torch.Tensor,
                       task_slots: torch.Tensor, cap_base: torch.Tensor,
                       det_lam: float, det_thresh: float,
                       dt: float) -> torch.Tensor:
    """K fused-engine ticks: each tick runs
    :func:`~repro_torch.dsp.simulator.step_batch_arrays` for the metrics
    and :func:`fused_tick_ref` for the lag carry and the detector.

    ``lag [S]``, ``det_w [S, 2]``, ``det_p [S, 2, 2]``, ``det_y [S]`` and
    ``det_trig [S]`` (int64) are the persistent state and are updated in
    place; the ``[K, S]`` planes ``rates``/``lag_add``/``down_pre``/
    ``down_post``/``z1``/``z2`` are the host-precomputed control state of
    the K ticks, ``workers``..``cap_base`` the ``[S]`` config operands.
    Returns the metrics stacked to ``[len(METRIC_KEYS), K, S]``.
    """
    from ..dsp.simulator import step_batch_arrays  # dsp imports kernels
    per_tick = []
    for k in range(rates.shape[0]):
        _, m = step_batch_arrays(
            model, lag, lag_add[k], rates[k], workers, cpu_cores, memory_mb,
            task_slots, cap_base, down_pre[k], down_post[k], z1[k], z2[k], dt)
        # The tick's new_lag is the authoritative carry; its arithmetic is
        # step_batch_arrays', op for op.
        lag_k, w2, p2, _, flag = fused_tick_ref(
            lag, lag_add[k], rates[k], m["capacity"], down_pre[k], det_w,
            det_p, det_y, det_lam, det_thresh, dt)
        lag.copy_(lag_k)
        det_w.copy_(w2)
        det_p.copy_(p2)
        torch.log1p(lag_k, out=det_y)
        det_trig += flag
        per_tick.append(torch.stack([m[key] for key in METRIC_KEYS]))
    return torch.stack(per_tick, dim=1)


class _ArimaMasks(NamedTuple):
    """A chunk's constants of the ARIMA step, from the streams' orders."""
    dims: torch.Tensor    # (B, p_max) bool: active lag dims
    adim: torch.Tensor    # (B, k) bool: active dims incl. the bias
    amask: torch.Tensor   # (B, k, k) bool: active block of P
    cap: torch.Tensor     # (B,) trace cap
    P_pin: torch.Tensor   # (B, k, k) ridge * I
    ones: torch.Tensor    # (B, 1) the bias column of phi
    d_lt: List[torch.Tensor]   # d_lt[j] = j < d, (B,) bool, j < d_max
    pd: torch.Tensor      # (B,) p + d


def _arima_masks(p: torch.Tensor, d: torch.Tensor, ridge: torch.Tensor,
                 cap: torch.Tensor, k: int, d_max: int) -> _ArimaMasks:
    B, p_max = p.shape[0], k - 1
    dev = p.device
    dims = torch.arange(p_max, device=dev)[None, :] < p[:, None]
    adim = torch.cat([dims, torch.ones((B, 1), dtype=torch.bool,
                                       device=dev)], dim=1)
    P_pin = ridge[:, None, None] * torch.eye(k, dtype=torch.float64,
                                             device=dev)
    return _ArimaMasks(dims, adim, adim[:, :, None] & adim[:, None, :], cap,
                       P_pin, torch.ones((B, 1), dtype=torch.float64,
                                         device=dev),
                       [j < d for j in range(d_max)], p + d)


def _arima_step(core, params, c: _ArimaMasks, values: torch.Tensor):
    """One masked online step for every stream (mirror of
    :meth:`repro_torch.core.forecast.OnlineARIMA.update`), minus the residual
    ring: the chunk pushes every tick's ``(resid, do_rls)`` in one scatter.
    A non-finite value is a no-op for its stream."""
    w, P, lags, tails, count, last = core
    p, d, lam, _ridge = params
    d_max = tails.shape[1]
    valid = torch.isfinite(values)
    v = torch.where(valid, values, 0.0)

    # Incremental differencing cascade: diffs[j] = the new sample's
    # j-times-differenced value, from the per-order tails.
    diffs = [v]
    for j in range(d_max):
        diffs.append(diffs[j] - tails[:, j])
    target = torch.gather(torch.stack(diffs, dim=1), 1, d[:, None])[:, 0]

    phi = torch.cat([torch.where(c.dims, lags, 0.0), c.ones], dim=1)
    gain, P_new = rls_rank1_update_ref(P, phi, lam)
    resid = target - (w * phi).sum(-1)
    w_new = w + gain * resid[:, None]
    # Re-symmetrize (the rank-1 downdate is symmetric in exact arithmetic;
    # roundoff would otherwise accumulate into an indefinite P), then apply
    # the anti-windup trace clamp over the active dims (P_TRACE_CAP).
    P_new = 0.5 * (P_new + P_new.transpose(1, 2))
    diag = torch.diagonal(P_new, dim1=1, dim2=2)
    tr = torch.where(c.adim, diag, 0.0).sum(1)
    P_new = P_new * torch.where(tr > c.cap, c.cap / tr, 1.0)[:, None, None]
    # Padded dims stay pinned at their ridge * I initialization (the /λ in
    # the covariance update would otherwise inflate them without bound).
    P_new = torch.where(c.amask, P_new, c.P_pin)
    # Safety net, mirroring the scalar oracle: a diverged stream restarts
    # its tracker from the prior instead of poisoning later updates.
    ok = (torch.isfinite(w_new).all(1)
          & torch.isfinite(P_new).flatten(1).all(1))
    w_new = torch.where(ok[:, None], w_new, 0.0)
    P_new = torch.where(ok[:, None, None], P_new, c.P_pin)

    # RLS fires once p + d + 1 samples exist (count is pre-increment).
    do_rls = valid & (count >= c.pd)
    w = torch.where(do_rls[:, None], w_new, w)
    P = torch.where(do_rls[:, None, None], P_new, P)

    # The differenced series gains a value once count >= d.
    defined = valid & (count >= d)
    shifted = torch.cat([target[:, None], lags[:, :-1]], dim=1)
    lags = torch.where(defined[:, None], shifted, lags)
    if d_max:
        tails = torch.stack([
            torch.where(valid & (count >= j) & c.d_lt[j], diffs[j],
                        tails[:, j]) for j in range(d_max)], dim=1)
    last = torch.where(valid, v, last)
    count = count + valid.to(count.dtype)
    return (w, P, lags, tails, count, last), resid, do_rls


def arima_chunk_ref(w: torch.Tensor, P: torch.Tensor, lags: torch.Tensor,
                    tails: torch.Tensor, count: torch.Tensor,
                    last: torch.Tensor, p: torch.Tensor, d: torch.Tensor,
                    lam: torch.Tensor, ridge: torch.Tensor, cap: torch.Tensor,
                    vals: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T ticks of the forecast bank's ARIMA step (AR(p) on the
    d-differenced series, RLS-tracked) for B streams, one batched step a
    tick.

    State ``w (B, k)``, ``P (B, k, k)``, ``lags (B, k - 1)`` (the
    differenced lags, newest first), ``tails (B, d_max)`` (the last value
    of each differenced series), ``count (B,)`` int64 and ``last (B,)`` is
    updated in place. ``p``, ``d`` (int64), ``lam`` (forgetting), ``ridge``
    (the prior's scale) and ``cap`` (the trace cap) are ``(B,)``;
    ``vals (T, B)`` holds the ticks, NaN where a stream has none (a no-op
    for it). Returns ``(resid (T, B), do_rls (T, B))``: each tick's
    residual and whether its RLS update fired.
    """
    c = _arima_masks(p, d, ridge, cap, w.shape[1], tails.shape[1])
    params = (p, d, lam, ridge)
    core = (w, P, lags, tails, count, last)
    resids, dos = [], []
    for t in range(vals.shape[0]):
        core, resid, do = _arima_step(core, params, c, vals[t])
        resids.append(resid)
        dos.append(do)
    for buf, new in zip((w, P, lags, tails, count, last), core):
        buf.copy_(new)
    return torch.stack(resids), torch.stack(dos)


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


#: rows of K5's output tiles: the CUDA kernel's third pass takes one tile
#: of a chunk per CTA
SSD_ROW_TILE = 64


def ssd_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                         a_log: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's three-pass chunked algorithm in plain torch, float32
    throughout: the function of :func:`ssd_scan_ref`, computed as the CUDA
    kernel computes it. Nothing on the serving path calls it; the tests
    hold it against :func:`ssd_scan_ref` and the reference's Pallas
    kernel. Shapes as :func:`ssd_scan_ref`.

    1. Chunk states: each chunk's cumulative log-decay ``cum`` (summed in
       position order) and its own state ``sum_j (dt_j x_j) (x) (B_j
       exp(cum_last - cum_j))``, from a zero state.
    2. State passing, chunk by chunk: the state entering chunk ``c`` is
       ``exp(cum_last of c - 1)`` times the one entering ``c - 1`` plus
       that chunk's own state; after the last chunk it is the final state.
    3. Chunk outputs, one tile of :data:`SSD_ROW_TILE` rows at a time: the
       readout ``exp(cum_i) C_i . S_c``, then for each tile J at or before
       the row tile the scores ``C B^T``, decayed by ``exp(cum_i -
       cum_j)`` where ``j <= i`` only (above the diagonal the exponent may
       overflow), times ``dt x``.
    """
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if seq % chunk:
        raise ValueError(f"sequence length {seq} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc, rep, t = seq // chunk, h // g, SSD_ROW_TILE
    a = -torch.exp(a_log.float())
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    xdt = (x.float() * dt.float()[..., None]).reshape(bsz, nc, chunk, h, p)
    bh = b.float().repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)
    ch = c.float().repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)

    # 1. chunk states
    cum = torch.cumsum(dtf * a, dim=2)                       # (B,NC,Q,H)
    last = cum[:, :, -1]                                     # (B,NC,H)
    bdecay = bh * torch.exp(last[:, :, None] - cum)[..., None]
    local = torch.einsum("bcqhp,bcqhn->bchpn", xdt, bdecay)

    # 2. state passing, in chunk order
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(state)
        state = torch.exp(last[:, i])[..., None, None] * state + local[:, i]

    # 3. chunk outputs, by tiles of rows
    y = torch.empty((bsz, nc, chunk, h, p), dtype=torch.float32,
                    device=x.device)
    for i in range(nc):
        for i0 in range(0, chunk, t):
            rows = slice(i0, min(i0 + t, chunk))
            cum_i = cum[:, i, rows]                          # (B,R,H)
            acc = torch.einsum("brhn,bhpn->brhp", ch[:, i, rows],
                               entering[i]) * torch.exp(cum_i)[..., None]
            for j0 in range(0, i0 + 1, t):
                cols = slice(j0, min(j0 + t, chunk))
                scores = torch.einsum("brhn,bkhn->bhrk", ch[:, i, rows],
                                      bh[:, i, cols])
                li = cum_i.permute(0, 2, 1)[..., :, None] \
                    - cum[:, i, cols].permute(0, 2, 1)[..., None, :]
                ii = torch.arange(rows.start, rows.stop)[:, None]
                jj = torch.arange(cols.start, cols.stop)[None, :]
                lower = (jj <= ii).to(x.device)
                decay = torch.exp(torch.where(lower, li, 0.0))
                m = torch.where(lower, scores * decay, 0.0)
                acc = acc + torch.einsum("bhrk,bkhp->brhp", m,
                                         xdt[:, i, cols])
            y[:, i, rows] = acc
    return y.reshape(bsz, seq, h, p).to(x.dtype), state


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


def gp_lbfgs_ref(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 t0: torch.Tensor, restarts: int, max_iter: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GP bank's fit: optax's L-BFGS with the zoom line search
    (:func:`repro_torch.core.gp_bank.lbfgs_batched`) over the masked
    marginal-likelihood objective
    (:func:`repro_torch.core.gp.neg_mll_and_grad`), a row per (member,
    restart). x: ``(B, n, d)``, y and mask: ``(B, n)``, t0: ``(B *
    restarts, d + 2)``, float32. Returns the fitted thetas and each row's
    iteration count."""
    # imported here: the modelling layer imports the kernels' dispatch
    from ..core.gp import neg_mll_and_grad
    from ..core.gp_bank import lbfgs_batched
    xr, yr, mr = (t.repeat_interleave(restarts, dim=0) for t in (x, y, mask))

    def fun(theta: torch.Tensor, rows):
        if rows is None:
            return neg_mll_and_grad(theta, xr, yr, mr)
        return neg_mll_and_grad(theta, xr[rows], yr[rows], mr[rows])
    return lbfgs_batched(fun, t0, max_iter=max_iter)


def gp_objective_sweep_ref(theta: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fit kernel's tiled objective in plain torch: the GP objective of
    :func:`repro_torch.core.gp.neg_mll_and_grad` and its gradient, computed
    as ``csrc/gp_fit.cu``'s tiled body computes them: d2 summed over the
    scaled differences (not as the plain version's ``|z_i|^2 + |z_c|^2 -
    2 z_i.z_c``); K^-1, the log-determinant and the positive-definite test
    come from one symmetric sweep (Dempster's sweep operator: after the
    steps 0..j the swept block holds -K^-1) over the rows up to the last
    real one, the masked rows past it starting swept (diagonal -1); the
    gradient is 0.5 tr((K^-1 - alpha
    alpha^T) dK/dtheta) in closed form, plus the priors'. theta ``(B, d +
    2)``, x ``(B, n, d)``, y and mask ``(B, n)``, float32. Returns the values
    ``(B,)`` and gradients ``(B, d + 2)``, NaN on a row whose sweep meets a
    pivot that is not positive (or NaN)."""
    B, n, dim = x.shape
    ls, sig, noise = (theta[:, :dim].exp(), theta[:, dim].exp(),
                      theta[:, dim + 1].exp())
    z = x / ls[:, None, :]
    dz2 = (z[:, :, None, :] - z[:, None, :, :]) ** 2
    d2 = dz2.sum(-1)
    s5r = math.sqrt(5.0) * torch.sqrt(torch.clamp(d2, min=1e-12))
    e = torch.exp(-s5r)
    km = sig[:, None, None] * (1.0 + s5r + 5.0 * d2 / 3.0) * e
    dk = torch.where(d2 > 1e-12, -(5.0 / 6.0) * sig[:, None, None] * e
                     * (1.0 + s5r), (5.0 / 3.0) * sig[:, None, None] * e)
    real = mask > 0
    pair = real[:, :, None] & real[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    idx = torch.arange(n, device=x.device)
    n_sweep = torch.where(real, idx, -1).max(1).values + 1
    diag0 = torch.where(idx[None, :] < n_sweep[:, None], 1.0, -1.0)
    a = torch.where(pair, km + torch.where(eye, noise[:, None, None] + 1e-6,
                                           0.0), 0.0)
    a = torch.where(pair | ~eye, a, torch.diag_embed(diag0))
    logdet = torch.zeros(B, dtype=x.dtype, device=x.device)
    ok = torch.ones(B, dtype=torch.bool, device=x.device)
    for j in range(n):
        piv = a[:, j, j]
        step = ok & (j < n_sweep)
        ok = ok & ~(step & ~(piv > 0))
        step = step & ok
        inv = 1.0 / piv
        c = a[:, :, j]
        u = c * inv[:, None]
        swept = a - c[:, :, None] * u[:, None, :]
        swept[:, j, :] = u
        swept[:, :, j] = u
        swept[:, j, j] = -inv
        a = torch.where(step[:, None, None], swept, a)
        logdet = logdet + torch.where(
            step, torch.log(torch.sqrt(piv)) * mask[:, j], 0.0)
    kinv = -a
    alpha = (kinv @ y[:, :, None])[:, :, 0]
    w = torch.where(pair, kinv - alpha[:, :, None] * alpha[:, None, :], 0.0)
    tr_ls = ((w * dk)[..., None] * (-2.0 * dz2)).sum((1, 2))
    tr_sig = (w * km).sum((1, 2))
    tr_noise = torch.where(eye, w, 0.0).sum((1, 2)) * noise
    mll = -0.5 * (y * alpha).sum(1) - logdet \
        - 0.5 * mask.sum(1) * math.log(2.0 * math.pi)
    t_ls, t_sig, t_noise = theta[:, :dim], theta[:, dim], theta[:, dim + 1]
    prior = (((t_ls - math.log(0.5)) ** 2).sum(1) / 8.0 + t_sig ** 2 / 8.0
             + (t_noise - math.log(1e-2)) ** 2 / 18.0)
    grad = torch.cat([0.5 * tr_ls + 2.0 * (t_ls - math.log(0.5)) / 8.0,
                      (0.5 * tr_sig + 2.0 * t_sig / 8.0)[:, None],
                      (0.5 * tr_noise + 2.0 * (t_noise - math.log(1e-2))
                       / 18.0)[:, None]], 1)
    value = torch.where(ok, -(mll - prior), torch.nan)
    return value, torch.where(ok[:, None], grad, torch.nan)
