"""Batched online forecasting and anomaly detection (paper §2.2-2.3) in
float64 torch.

* :class:`ForecastBank` packs every (scenario x stream) online forecaster
  of a sweep into stacked tensors on one device and advances all of them
  together. Streams are grouped by family (``arima`` / ``holt`` /
  ``seasonal``, mirroring the scalar zoo in
  :mod:`repro_torch.core.forecast`). Updates are *staged* per stream into
  write-behind queues; when the next forecast is read,
  :meth:`ForecastBank.flush` replays every queued tick of every stream as
  one chunk, with the family's state tensors updated in place (the
  reference's ``lax.scan`` with donated buffers). A read that finds staged
  ticks replays them and rolls out the horizon in one pass.
* :class:`DetectorBank` is the §2.3 one-step-error anomaly detectors,
  batched: one call per sample advances every stream's ARIMA predictor,
  compares the absolute one-step error against a median + k·MAD threshold
  over a fixed ring of past healthy errors, and coasts anomalous streams
  on their own prediction.

The ARIMA family's step is a batched rank-1 RLS update on weights
``w[B, k]`` and covariances ``P[B, k, k]`` with the reference's guards:
re-symmetrized covariance, the anti-windup trace cap, padded dimensions
pinned at ``ridge * I``, and a divergence reset. Both banks run it through
:func:`repro_torch.kernels.ops.arima_chunk`: the forecast bank once per
flush (every queued tick of the chunk), the detector bank once per sample
(a chunk of one tick). On the card that is one launch of the CUDA kernel in
``csrc/rls_update.cu``; on the CPU its plain version.

Numerics: bank state is float64, so every family agrees with its scalar
NumPy oracle to reduction-order rounding. Heterogeneous AR and differencing
orders share one padded layout (``p_max`` a power of two >= 4): inactive lag
dimensions are masked out of the regression vector, so a member behaves
exactly like an unpadded stream.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .anomaly import DETECTOR_ERR_WINDOW
from .executor import resolve_device
from .forecast import (ERR_WINDOW, FORECASTER_DEFAULTS, FORECASTER_KINDS,
                       P_TRACE_CAP, ROLLOUT_DIFF_CAP, make_scalar_forecaster)
from .gp_bank import bucket_pow2
from .registry import FORECAST_BACKENDS

_F64 = torch.float64


def _ring_push(ring: torch.Tensor, n: torch.Tensor, value: torch.Tensor,
               do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``value`` into each row's next ring slot where ``do``."""
    width = ring.shape[1]
    oh = F.one_hot(n % width, width).to(ring.dtype) \
        * do[:, None].to(ring.dtype)
    return ring * (1.0 - oh) + oh * value[:, None], n + do.to(n.dtype)


# ---------------------------------------------------------------------------
# ARIMA family: AR(p) on the d-differenced series, RLS-tracked
# ---------------------------------------------------------------------------

class _ArimaState(NamedTuple):
    w: torch.Tensor       # (B, k)    AR coefficients + bias (k = p_max + 1)
    P: torch.Tensor       # (B, k, k) RLS inverse covariance
    lags: torch.Tensor    # (B, p_max) differenced lags, newest first
    tails: torch.Tensor   # (B, d_max) last value of the j-times-diffed series
    count: torch.Tensor   # (B,) int64 finite samples seen
    last: torch.Tensor    # (B,)      latest level
    err: torch.Tensor     # (B, E)    RLS residual ring
    err_n: torch.Tensor   # (B,) int64 residuals pushed


class _ArimaParams(NamedTuple):
    p: torch.Tensor       # (B,) int64 AR order
    d: torch.Tensor       # (B,) int64 differencing order
    lam: torch.Tensor     # (B,)      forgetting factor
    ridge: torch.Tensor   # (B,)      initial covariance scale


class _ArimaConst(NamedTuple):
    """Per-bank constants derived from the params once, not per chunk."""
    dims: torch.Tensor    # (B, p_max) bool: active lag dims
    cap: torch.Tensor     # (B,) trace cap
    ones: torch.Tensor    # (B, 1) the bias column of phi
    d_lt: List[torch.Tensor]   # d_lt[j] = j < d, (B,) bool, j < d_max
    pd: torch.Tensor      # (B,) p + d


def _arima_const(params: _ArimaParams, k: int, d_max: int) -> _ArimaConst:
    p, d, _lam, ridge = params
    B, p_max = p.shape[0], k - 1
    dev = p.device
    dims = torch.arange(p_max, device=dev)[None, :] < p[:, None]
    cap = ridge * (p + 1).to(_F64) * P_TRACE_CAP
    return _ArimaConst(dims, cap, torch.ones((B, 1), dtype=_F64, device=dev),
                       [j < d for j in range(d_max)], p + d)


def _arima_phi(lags: torch.Tensor, c: _ArimaConst) -> torch.Tensor:
    """Masked regression vector [active lags, bias] — padded dims read 0."""
    return torch.cat([torch.where(c.dims, lags, 0.0), c.ones], dim=1)


def _arima_roll(state: _ArimaState, params: _ArimaParams, c: _ArimaConst,
                steps: int) -> torch.Tensor:
    """Iterated multistep rollout for every stream."""
    w, lags, tails, count, last = (state.w, state.lags, state.tails,
                                   state.count, state.last)
    d_max = tails.shape[1]
    # Stability guard, mirroring the scalar oracle (ROLLOUT_DIFF_CAP).
    lim = ROLLOUT_DIFF_CAP * torch.clamp(
        torch.where(c.dims, lags.abs(), 0.0).amax(dim=1), min=1.0)
    levels = []
    for _ in range(steps):
        dnext = torch.clamp((w * _arima_phi(lags, c)).sum(-1), -lim, lim)
        # Invert the d-th difference by cascading through every order.
        vacc, vals = dnext, [None] * d_max
        for j in range(d_max - 1, -1, -1):
            vacc = torch.where(c.d_lt[j], vacc + tails[:, j], vacc)
            vals[j] = vacc
        if d_max:
            tails = torch.stack([torch.where(c.d_lt[j], vals[j], tails[:, j])
                                 for j in range(d_max)], dim=1)
        lags = torch.cat([dnext[:, None], lags[:, :-1]], dim=1)
        levels.append(vacc)
    out = torch.stack(levels, dim=1)
    has_model = count >= c.pd + 1
    flat = torch.where(count > 0, last, 0.0)
    return torch.where(has_model[:, None], out, flat[:, None])


def _arima_chunk(state: _ArimaState, params: _ArimaParams, c: _ArimaConst,
                 vals: torch.Tensor) -> _ArimaState:
    """Apply a (T, B) chunk of queued ticks: one
    :func:`~repro_torch.kernels.ops.arima_chunk` call, which updates the
    state tensors in place and returns each tick's residual and RLS flag.

    NaN is the not-staged sentinel: a NaN sample is skipped by the update
    anyway. The residual-ring writes follow in one scatter: slot order
    within a chunk is deterministic, so all pushes land at once
    (T <= queue cap < ring width, hence no slot collisions)."""
    resids_t, dos_t = ops.arima_chunk(
        state.w, state.P, state.lags, state.tails, state.count, state.last,
        *params, c.cap, vals)                                    # (T, B)
    err, err_n = state.err, state.err_n
    E = err.shape[1]
    ranks = torch.cumsum(dos_t.to(err_n.dtype), dim=0) - 1
    slots = torch.where(dos_t, (err_n[None, :] + ranks) % E, E)  # E = drop
    rows = torch.arange(dos_t.shape[1], device=err.device
                        ).expand(dos_t.shape[0], -1)
    ring = torch.cat([err, torch.zeros_like(err[:, :1])], dim=1)
    ring[rows.reshape(-1), slots.reshape(-1)] = resids_t.reshape(-1)
    err_n = err_n + dos_t.sum(0).to(err_n.dtype)
    return state._replace(err=ring[:, :E], err_n=err_n)


# ---------------------------------------------------------------------------
# Holt(-Winters) family: additive level + trend (+ seasonal ring)
# ---------------------------------------------------------------------------

class _HoltState(NamedTuple):
    level: torch.Tensor   # (B,)
    trend: torch.Tensor   # (B,)
    seas: torch.Tensor    # (B, m_max) additive seasonal ring
    count: torch.Tensor   # (B,) int64
    last: torch.Tensor    # (B,)
    err: torch.Tensor     # (B, E)
    err_n: torch.Tensor   # (B,) int64


class _HoltParams(NamedTuple):
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    season: torch.Tensor  # (B,) int64, 0 = no seasonality


def _holt_step(state: _HoltState, params: _HoltParams,
               values: torch.Tensor) -> _HoltState:
    level, trend, seas, count, last, err, err_n = state
    alpha, beta, gamma, season = params
    m_max = seas.shape[1]
    valid = torch.isfinite(values)
    v = torch.where(valid, values, 0.0)

    has = season > 0
    idx = count % torch.clamp(season, min=1)
    s_old = torch.gather(seas, 1, idx[:, None])[:, 0] * has.to(seas.dtype)
    err, err_n = _ring_push(err, err_n, v - (level + trend + s_old),
                            valid & (count > 0))

    prev = level + trend
    lvl_new = alpha * (v - s_old) + (1.0 - alpha) * prev
    tr_new = beta * (lvl_new - level) + (1.0 - beta) * trend
    lvl_new = torch.where(count == 0, v, lvl_new)
    tr_new = torch.where(count == 0, 0.0, tr_new)
    s_val = gamma * (v - lvl_new) + (1.0 - gamma) * s_old
    wr = valid & has & (count > 0)
    ohm = F.one_hot(idx, m_max).to(seas.dtype) * wr[:, None].to(seas.dtype)
    seas = seas * (1.0 - ohm) + ohm * s_val[:, None]

    level = torch.where(valid, lvl_new, level)
    trend = torch.where(valid, tr_new, trend)
    last = torch.where(valid, v, last)
    count = count + valid.to(count.dtype)
    return _HoltState(level, trend, seas, count, last, err, err_n)


def _holt_roll(state: _HoltState, params: _HoltParams,
               steps: int) -> torch.Tensor:
    level, trend, seas, count = (state.level, state.trend, state.seas,
                                 state.count)
    season = params.season
    dev = level.device
    ks = torch.arange(1, steps + 1, dtype=_F64, device=dev)
    out = level[:, None] + ks[None, :] * trend[:, None]
    idx = (count[:, None] + torch.arange(steps, device=dev)[None, :]) \
        % torch.clamp(season, min=1)[:, None]
    out = out + torch.gather(seas, 1, idx) \
        * (season > 0)[:, None].to(seas.dtype)
    return torch.where(count[:, None] > 0, out, 0.0)


# ---------------------------------------------------------------------------
# Seasonal-naive family: replay the last season
# ---------------------------------------------------------------------------

class _SNaiveState(NamedTuple):
    ring: torch.Tensor    # (B, m_max) circular: slot j holds time ≡ j (mod m)
    count: torch.Tensor   # (B,) int64
    last: torch.Tensor    # (B,)
    err: torch.Tensor     # (B, E)
    err_n: torch.Tensor   # (B,) int64


class _SNaiveParams(NamedTuple):
    season: torch.Tensor  # (B,) int64 >= 1


def _snaive_step(state: _SNaiveState, params: _SNaiveParams,
                 values: torch.Tensor) -> _SNaiveState:
    ring, count, last, err, err_n = state
    season = params.season
    m_max = ring.shape[1]
    valid = torch.isfinite(values)
    v = torch.where(valid, values, 0.0)

    idx = count % season
    one_ago = torch.gather(ring, 1, idx[:, None])[:, 0]
    pred = torch.where(count >= season, one_ago, last)
    err, err_n = _ring_push(err, err_n, v - pred, valid & (count > 0))
    ohm = F.one_hot(idx, m_max).to(ring.dtype) * valid[:, None].to(ring.dtype)
    ring = ring * (1.0 - ohm) + ohm * v[:, None]
    last = torch.where(valid, v, last)
    count = count + valid.to(count.dtype)
    return _SNaiveState(ring, count, last, err, err_n)


def _snaive_roll(state: _SNaiveState, params: _SNaiveParams,
                 steps: int) -> torch.Tensor:
    ring, count, last = state.ring, state.count, state.last
    season = params.season
    idx = (count[:, None] + torch.arange(steps, device=ring.device)[None, :]) \
        % season[:, None]
    out = torch.gather(ring, 1, idx)
    out = torch.where(count[:, None] >= season[:, None], out, last[:, None])
    return torch.where(count[:, None] > 0, out, 0.0)


# ---------------------------------------------------------------------------
# family banks: padded state + staging + one batched pass per flush
# ---------------------------------------------------------------------------

#: Per-stream staging queue depth; a full queue forces an early flush.
_QUEUE_CAP = 128


class _FamilyBank:
    """Shared staging / flush / read plumbing for one forecaster family.

    Updates are write-behind batched in *time* as well as across streams:
    ``stage`` appends to a per-stream queue and ``flush`` replays the whole
    queued chunk in one pass. Under the sweep cadences (ingest every metric
    interval, forecasts read every optimization/profiling interval) that is
    ~10 ticks per pass on top of the cross-stream batching.
    """

    kind = ""

    def __init__(self, rows: Sequence[dict], device: torch.device):
        self.n = len(rows)
        self.device = device
        # Per-stream staging queues (plain lists: appends are the per-tick
        # hot path; the chunk tensor is only built per flush).
        self._q: List[List[float]] = [[] for _ in range(self.n)]
        self.state, self.params = self._build(list(rows))
        self._state0 = type(self.state)(*(t.clone() for t in self.state))
        self._after_params()
        #: ticks replayed through chunks (padding ticks included)
        self.ticks_replayed = 0
        #: chunks replayed (one per flush that found staged ticks)
        self.chunks_replayed = 0

    def _t(self, a, dtype=_F64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # family-specific
    def _build(self, rows: List[dict]):
        raise NotImplementedError

    def _after_params(self) -> None:
        """Derive per-bank constants from ``self.params`` (ARIMA)."""

    def _step_chunk(self, vals: torch.Tensor):
        """Apply a (T, B) chunk of queued values (NaN = not staged)."""
        state = self.state
        for t in range(vals.shape[0]):
            state = self._step(state, vals[t])
        return state

    def _step(self, state, values):
        raise NotImplementedError

    def _roll(self, steps: int) -> torch.Tensor:
        raise NotImplementedError

    # shared
    def stage(self, i: int, value: float) -> None:
        self._q[i].append(value)

    def queue_full(self, i: int) -> bool:
        return len(self._q[i]) >= _QUEUE_CAP

    @property
    def has_staged(self) -> bool:
        return any(self._q)

    def _take_chunk(self) -> Tuple[int, np.ndarray]:
        """Drain the queues into a (T, B) chunk array.

        The chunk length is bucketed as the reference buckets it (exact
        below 4, multiples of 4 beyond); padding ticks are all-NaN, a no-op
        for every family."""
        qs = self._q
        n = sum(len(q) for q in qs)
        t_max = max(len(q) for q in qs)
        tb = t_max if t_max <= 4 else -(-t_max // 4) * 4
        vals = np.full((tb, self.n), np.nan)
        for i, q in enumerate(qs):
            if q:
                vals[:len(q), i] = q
        self._q = [[] for _ in range(self.n)]
        return n, vals

    def _apply(self, vals: np.ndarray) -> None:
        """Replay a chunk; the state tensors are updated in place."""
        new = self._step_chunk(self._t(vals))
        for buf, src in zip(self.state, new):
            if src is not buf:
                buf.copy_(src)
        self.ticks_replayed += vals.shape[0]
        self.chunks_replayed += 1

    def flush(self) -> int:
        if not any(self._q):
            return 0
        n, vals = self._take_chunk()
        self._apply(vals)
        return n

    def flush_and_roll(self, steps: int) -> Tuple[int, np.ndarray]:
        """Apply the queued chunk and roll out in one pass."""
        n = self.flush()
        return n, self.rollout(steps)

    def rollout(self, steps: int) -> np.ndarray:
        return self._roll(steps).cpu().numpy()

    def reset_rows(self, idx: Sequence[int]) -> None:
        """Return streams ``idx`` to their just-constructed state (the
        parameters are untouched) and drop their staging queues."""
        if len(idx) == 0:
            return
        rows = torch.as_tensor(sorted(int(i) for i in idx), device=self.device)
        for cur, init in zip(self.state, self._state0):
            cur[rows] = init[rows]
        for i in rows.tolist():
            self._q[i] = []

    def load_state(self, state: Sequence[torch.Tensor],
                   params: Sequence[torch.Tensor]) -> None:
        """Overwrite state and params in place (shapes and dtypes must
        match; see :func:`repro_torch.interop.forecast_family_from_arrays`)."""
        for group, new in ((self.state, state), (self.params, params)):
            for name, buf, src in zip(group._fields, group, new):
                if src.shape != buf.shape or src.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.kind} {name}: expected {tuple(buf.shape)} "
                        f"{buf.dtype}, got {tuple(src.shape)} {src.dtype}")
                buf.copy_(src)
        self._after_params()

    def n_observed(self, i: int) -> int:
        return int(self.state.count[i])

    def last(self, i: int) -> float:
        return float(self.state.last[i])

    def residual_std(self, i: int) -> float:
        c = min(int(self.state.err_n[i]), self.state.err.shape[1])
        if c < 4:
            return float("inf")
        return float(np.std(self.state.err[i, :c].cpu().numpy()))


class _ArimaBank(_FamilyBank):
    kind = "arima"

    def _build(self, rows: List[dict]):
        p = np.array([r.get("p", 8) for r in rows], np.int64)
        d = np.array([r.get("d", 1) for r in rows], np.int64)
        lam = np.array([r.get("forgetting", 0.995) for r in rows], float)
        ridge = np.array([r.get("ridge", 10.0) for r in rows], float)
        p_max = bucket_pow2(int(p.max()), minimum=4)
        d_max = max(int(d.max()), 1)
        k = p_max + 1
        B = self.n
        z = lambda *shape: torch.zeros(shape, dtype=_F64,  # noqa: E731
                                       device=self.device)
        state = _ArimaState(
            w=z(B, k), P=self._t(ridge[:, None, None] * np.eye(k)[None]),
            lags=z(B, p_max), tails=z(B, d_max),
            count=torch.zeros(B, dtype=torch.int64, device=self.device),
            last=z(B), err=z(B, ERR_WINDOW),
            err_n=torch.zeros(B, dtype=torch.int64, device=self.device))
        params = _ArimaParams(self._t(p, torch.int64), self._t(d, torch.int64),
                              self._t(lam), self._t(ridge))
        return state, params

    def _after_params(self) -> None:
        self.const = _arima_const(self.params, self.state.w.shape[1],
                                  self.state.tails.shape[1])

    def _step_chunk(self, vals):
        return _arima_chunk(self.state, self.params, self.const, vals)

    def _roll(self, steps):
        return _arima_roll(self.state, self.params, self.const, steps)


class _HoltBank(_FamilyBank):
    kind = "holt"

    def _build(self, rows: List[dict]):
        alpha = np.array([r.get("alpha", 0.5) for r in rows], float)
        beta = np.array([r.get("beta", 0.1) for r in rows], float)
        gamma = np.array([r.get("gamma", 0.1) for r in rows], float)
        season = np.array([r.get("season", 0) for r in rows], np.int64)
        m_max = bucket_pow2(max(int(season.max()), 1), minimum=1)
        B = self.n
        z = lambda *shape: torch.zeros(shape, dtype=_F64,  # noqa: E731
                                       device=self.device)
        zi = torch.zeros(B, dtype=torch.int64, device=self.device)
        state = _HoltState(level=z(B), trend=z(B), seas=z(B, m_max),
                           count=zi, last=z(B), err=z(B, ERR_WINDOW),
                           err_n=zi.clone())
        params = _HoltParams(self._t(alpha), self._t(beta), self._t(gamma),
                             self._t(season, torch.int64))
        return state, params

    def _step(self, state, values):
        return _holt_step(state, self.params, values)

    def _roll(self, steps):
        return _holt_roll(self.state, self.params, steps)


class _SNaiveBank(_FamilyBank):
    kind = "seasonal"

    def _build(self, rows: List[dict]):
        season = np.array([r.get("season", 12) for r in rows], np.int64)
        if (season < 1).any():
            raise ValueError("SeasonalNaive needs season >= 1")
        m_max = bucket_pow2(int(season.max()), minimum=1)
        B = self.n
        z = lambda *shape: torch.zeros(shape, dtype=_F64,  # noqa: E731
                                       device=self.device)
        zi = torch.zeros(B, dtype=torch.int64, device=self.device)
        state = _SNaiveState(ring=z(B, m_max), count=zi, last=z(B),
                             err=z(B, ERR_WINDOW), err_n=zi.clone())
        return state, _SNaiveParams(self._t(season, torch.int64))

    def _step(self, state, values):
        return _snaive_step(state, self.params, values)

    def _roll(self, steps):
        return _snaive_roll(self.state, self.params, steps)


_FAMILY_BANKS = {"arima": _ArimaBank, "holt": _HoltBank,
                 "seasonal": _SNaiveBank}


# ---------------------------------------------------------------------------
# the public bank
# ---------------------------------------------------------------------------

class BankedForecaster:
    """One stream's view into a :class:`ForecastBank`.

    Implements the scalar zoo protocol (``update`` / ``forecast`` /
    ``residual_std`` / ``last`` / ``n_observed``), so a
    :class:`~repro_torch.core.demeter.DemeterController` can hold one as its
    TSF. ``update`` *stages* the observation; the bank applies all staged
    streams in one pass on :meth:`ForecastBank.flush` (or on the first read).
    """

    def __init__(self, bank: "ForecastBank", row: int):
        self.bank = bank
        self.row = row
        kind, self._i = bank._rows[row]
        self._fam = bank._fams[kind]

    def update(self, value: float) -> None:
        # Inlined ForecastBank.stage — this is the per-tick hot path.
        q = self._fam._q[self._i]
        if len(q) >= _QUEUE_CAP:
            self.bank.flush()
            q = self._fam._q[self._i]
        q.append(value)

    def forecast(self, steps: int) -> np.ndarray:
        return self.bank.forecast_row(self.row, steps)

    def binned(self, horizon: int, bins: int) -> float:
        """Max-bin forecast average (paper §2.2), served from the bank's
        shared batched computation (see :meth:`ForecastBank.binned_row`)."""
        return self.bank.binned_row(self.row, horizon, bins)

    def residual_std(self) -> float:
        self.bank.flush()
        return self._fam.residual_std(self._i)

    @property
    def n_observed(self) -> int:
        self.bank.flush()
        return self._fam.n_observed(self._i)

    def last(self) -> float:
        self.bank.flush()
        return self._fam.last(self._i)


class ForecastBank:
    """All scenarios' online forecasters behind one batched update.

    Hand each scenario its :class:`BankedForecaster` view. Staged updates
    are applied per family in one batched pass per flush; rollouts for the
    shared ``horizon`` are computed for the whole bank at once and served
    from cache until the next update, so N scenarios reading forecasts in
    one tick cost one pass, not N.

    ``device`` defaults to ``"cuda"`` and raises where there is no card;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, kinds: Sequence[str],
                 params: Optional[Sequence[dict]] = None,
                 horizon: int = 10, device: str = "cuda"):
        if not kinds:
            raise ValueError("ForecastBank needs at least one stream")
        params = list(params) if params is not None else [{}] * len(kinds)
        if len(params) != len(kinds):
            raise ValueError("params must align with kinds")
        for k in kinds:
            if k not in FORECASTER_KINDS:
                raise ValueError(f"unknown forecaster kind {k!r}; "
                                 f"available: {FORECASTER_KINDS}")
        self.device = resolve_device(device)
        self.horizon = int(horizon)
        grouped: Dict[str, List[Tuple[int, dict]]] = {}
        for row, (kind, kw) in enumerate(zip(kinds, params)):
            grouped.setdefault(kind, []).append(
                (row, {**FORECASTER_DEFAULTS[kind], **kw}))
        self._rows: List[Tuple[str, int]] = [("", 0)] * len(kinds)
        self._fams: Dict[str, _FamilyBank] = {}
        for kind, members in grouped.items():
            for i, (row, _) in enumerate(members):
                self._rows[row] = (kind, i)
            self._fams[kind] = _FAMILY_BANKS[kind](
                [kw for _, kw in members], self.device)
        self._cache: Dict[object, np.ndarray] = {}
        #: wall-clock spent in batched update / rollout passes
        self.update_wall_s = 0.0
        self.rollout_wall_s = 0.0
        self.n_updates = 0

    @property
    def n_streams(self) -> int:
        return len(self._rows)

    @property
    def arima_ticks(self) -> int:
        """Ticks the ARIMA family replayed (padding ticks included)."""
        fam = self._fams.get("arima")
        return fam.ticks_replayed if fam is not None else 0

    @property
    def arima_chunks(self) -> int:
        """Chunks the ARIMA family replayed (one arima_chunk call each)."""
        fam = self._fams.get("arima")
        return fam.chunks_replayed if fam is not None else 0

    def family(self, kind: str) -> _FamilyBank:
        return self._fams[kind]

    def view(self, row: int) -> BankedForecaster:
        return BankedForecaster(self, row)

    def views(self) -> List[BankedForecaster]:
        return [self.view(r) for r in range(self.n_streams)]

    # -- updates -------------------------------------------------------------
    def stage(self, row: int, value: float) -> None:
        fam, i = self._rows[row]
        if self._fams[fam].queue_full(i):
            self.flush()
        self._fams[fam].stage(i, value)

    def flush(self) -> int:
        """Apply every staged stream: one batched pass per family."""
        if not any(f.has_staged for f in self._fams.values()):
            return 0
        t0 = time.perf_counter()
        n = 0
        for kind, fam in self._fams.items():
            if fam.has_staged:
                n += fam.flush()
                self._drop_family_cache(kind)
        self.update_wall_s += time.perf_counter() - t0
        self.n_updates += n
        return n

    def reset_rows(self, rows: Sequence[int]) -> int:
        """Reset streams ``rows`` to their just-constructed state; returns
        the number of streams reset."""
        by_fam: Dict[str, List[int]] = {}
        for row in rows:
            fam, i = self._rows[row]
            by_fam.setdefault(fam, []).append(i)
        n = 0
        for fam, members in by_fam.items():
            self._fams[fam].reset_rows(members)
            self._drop_family_cache(fam)
            n += len(members)
        return n

    # -- reads ---------------------------------------------------------------
    def _drop_family_cache(self, fam: str) -> None:
        for k in [k for k in self._cache
                  if k == fam or (isinstance(k, tuple) and k[0] == fam)]:
            del self._cache[k]

    def _cached_rollout(self, fam: str) -> np.ndarray:
        """The family's horizon rollout; a dirty queue flushes *and* rolls
        out in one pass."""
        f = self._fams[fam]
        if f.has_staged:
            t0 = time.perf_counter()
            n, out = f.flush_and_roll(self.horizon)
            self.update_wall_s += time.perf_counter() - t0
            self.n_updates += n
            self._drop_family_cache(fam)
            self._cache[fam] = out
            return out
        cached = self._cache.get(fam)
        if cached is None:
            t0 = time.perf_counter()
            cached = f.rollout(self.horizon)
            self.rollout_wall_s += time.perf_counter() - t0
            self._cache[fam] = cached
        return cached

    def forecast_row(self, row: int, steps: int) -> np.ndarray:
        fam, i = self._rows[row]
        if steps <= self.horizon:
            return self._cached_rollout(fam)[i, :steps].copy()
        self.flush()
        t0 = time.perf_counter()
        out = self._fams[fam].rollout(steps)[i]
        self.rollout_wall_s += time.perf_counter() - t0
        return out

    def binned_row(self, row: int, horizon: int, bins: int) -> float:
        """Paper §2.2 max-bin average for one stream, computed for the
        whole family at once and cached until the next update."""
        bins = max(bins, 1)
        fam, i = self._rows[row]
        if horizon != self.horizon or horizon % bins != 0 or horizon < 1:
            # Off-cache shape: mirror the scalar binned_forecast inline
            # (calling it would recurse through this fast path).
            fc = np.maximum(self.forecast_row(row, horizon), 0.0)
            splits = np.array_split(fc, bins)
            means = [float(s.mean()) for s in splits if len(s)]
            return max(means) if means else 0.0
        roll = self._cached_rollout(fam)     # drops stale (fam, bins) keys
        key = (fam, bins)
        cached = self._cache.get(key)
        if cached is None:
            pos = np.maximum(roll, 0.0)
            cached = pos.reshape(len(pos), bins, -1).mean(axis=2).max(axis=1)
            self._cache[key] = cached
        return float(cached[i])


@FORECAST_BACKENDS.register("scalar")
def _scalar_forecaster(kind: str, *, horizon: int = 10,
                       device: str = "cuda", **kwargs):
    """Float64 NumPy zoo member (the reference oracle, on the host)."""
    del horizon, device                  # scalar zoo members roll out lazily
    return make_scalar_forecaster(kind, **kwargs)


@FORECAST_BACKENDS.register("bank")
def _banked_forecaster(kind: str, *, horizon: int = 10,
                       device: str = "cuda", **kwargs):
    """Single-stream :class:`BankedForecaster` over its own bank."""
    return ForecastBank([kind], params=[kwargs], horizon=horizon,
                        device=device).view(0)


def make_forecaster(kind: str = "arima", *, backend: str = "bank",
                    horizon: int = 10, device: str = "cuda", **kwargs):
    """One forecaster of ``kind`` on the registered ``backend``:
    ``"scalar"`` is the float64 NumPy zoo member, ``"bank"`` a single-stream
    :class:`BankedForecaster` over its own :class:`ForecastBank` on
    ``device``."""
    factory = FORECAST_BACKENDS.get(backend)
    return factory(kind, horizon=horizon, device=device, **kwargs)


# ---------------------------------------------------------------------------
# DetectorBank: batched §2.3 anomaly detectors
# ---------------------------------------------------------------------------

def _mad_threshold(ring: torch.Tensor, rn: torch.Tensor, k_sigma: float,
                   warm: int) -> torch.Tensor:
    """Median + k·MAD over each row's healthy-error ring (+inf before
    ``warm`` errors): two sorts with +inf in the unused slots."""
    E = ring.shape[1]
    cnt = torch.clamp(rn, max=E)
    validm = torch.arange(E, device=ring.device)[None, :] < cnt[:, None]
    c = torch.clamp(cnt, min=1)
    inf = torch.tensor(float("inf"), dtype=ring.dtype, device=ring.device)

    def masked_median(x: torch.Tensor) -> torch.Tensor:
        s = torch.sort(torch.where(validm, x, inf), dim=1).values
        lo = torch.gather(s, 1, ((c - 1) // 2)[:, None])[:, 0]
        hi = torch.gather(s, 1, (c // 2)[:, None])[:, 0]
        return 0.5 * (lo + hi)

    med = masked_median(ring)
    mad = masked_median((ring - med[:, None]).abs()) * 1.4826
    thr = med + k_sigma * torch.clamp(mad, min=1e-9)
    return torch.where(cnt >= warm, thr, inf)


def _detector_observe(state: _ArimaState, params: _ArimaParams,
                      c: _ArimaConst, ring: torch.Tensor, rn: torch.Tensor,
                      vals: torch.Tensor, k_sigma: float, warm: int
                      ) -> Tuple[_ArimaState, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One sample for every stream (NaN where a stream has none): predict,
    threshold, push the healthy error, and take the ARIMA step on the
    sample, or on the prediction where it is anomalous. Returns the state
    (``w``/``P``/``lags``/``tails``/``count``/``last`` updated in place),
    the ring, its counts and the flags."""
    act = torch.isfinite(vals)
    v = torch.where(act, vals, 0.0)
    pred = _arima_roll(state, params, c, 1)[:, 0]
    # A non-finite prediction must neither flag nor enter the healthy-error
    # ring (it would disable the MAD threshold forever): the scalar
    # detector's sick-model guard.
    can = (state.count >= warm) & torch.isfinite(pred)
    err_abs = (v - pred).abs()
    thr = _mad_threshold(ring, rn, k_sigma, warm)
    anomalous = act & can & (err_abs > thr)
    ring, rn = _ring_push(ring, rn, err_abs, act & can & ~anomalous)
    # Positive-executions-only training: coast on the prediction during an
    # anomaly so the outage regime never looks 'normal'.
    used = torch.where(anomalous, pred, v)
    step = torch.where(act, used, float("nan"))
    state = _arima_chunk(state, params, c, step[None])
    return state, ring, rn, anomalous


class DetectorBank:
    """B one-step-error anomaly detectors advanced by one call per sample.

    Batched mirror of :class:`repro_torch.core.anomaly.MetricDetector`:
    each stream runs an online-ARIMA identity predictor (AR(``p``) on the
    ``d``-differenced series); the absolute one-step error is compared
    against ``median + k·MAD`` of a fixed ring of past *healthy* errors.
    State is float64 on ``device`` (the card by default; it raises where
    there is none, so pass ``device="cpu"``), padded to a power of two of
    rows as the reference pads. An :meth:`observe` is one
    :func:`~repro_torch.kernels.ops.arima_chunk` call of one tick and one
    copy of the flags back to the host.
    """

    def __init__(self, n_streams: int, *, k_sigma: float = 5.0,
                 min_warmup: int = 12, p: int = 4, d: int = 1,
                 err_window: int = DETECTOR_ERR_WINDOW,
                 device: str = "cuda"):
        if n_streams < 1:
            raise ValueError("DetectorBank needs at least one stream")
        self.n = n_streams
        self.b = bucket_pow2(n_streams, minimum=1)
        self.device = resolve_device(device)
        model = _ArimaBank([dict(p=p, d=d)] * self.b, self.device)
        self._state, self._params = model.state, model.params
        self._const = model.const
        self._ring = torch.zeros((self.b, err_window), dtype=_F64,
                                 device=self.device)
        self._rn = torch.zeros(self.b, dtype=torch.int64, device=self.device)
        self._k_sigma = float(k_sigma)
        self._warm = int(min_warmup)
        #: host wall of the observe calls, and their number
        self.wall_s = 0.0
        self.n_samples = 0
        # Copies for reset_rows: arima_chunk updates the live state in place.
        self._state0 = model._state0
        self._ring0 = self._ring.clone()
        self._rn0 = self._rn.clone()

    def reset_rows(self, rows: Sequence[int]) -> None:
        """Return detectors ``rows`` to their just-constructed state (the
        fleet-slot-reuse mirror of :meth:`ForecastBank.reset_rows`)."""
        if len(rows) == 0:
            return
        idx = torch.as_tensor(sorted(int(r) for r in rows),
                              device=self.device)
        for cur, init in zip(self._state, self._state0):
            cur[idx] = init[idx]
        self._ring[idx] = self._ring0[idx]
        self._rn[idx] = self._rn0[idx]

    def load_state(self, state: Sequence[torch.Tensor], ring: torch.Tensor,
                   rn: torch.Tensor) -> None:
        """Overwrite the state, the ring and its counts in place (shapes and
        dtypes must match; see
        :func:`repro_torch.interop.detector_bank_from_arrays`)."""
        names = self._state._fields + ("ring", "rn")
        for name, buf, src in zip(names, (*self._state, self._ring, self._rn),
                                  (*state, ring, rn)):
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(
                    f"detector {name}: expected {tuple(buf.shape)} "
                    f"{buf.dtype}, got {tuple(src.shape)} {src.dtype}")
            buf.copy_(src)

    def observe(self, values: np.ndarray,
                active: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed one sample per stream; returns the per-stream anomaly flags.

        ``active=False`` (or a non-finite value) skips that stream entirely,
        like not calling the scalar detector."""
        values = np.asarray(values, np.float64)
        if values.shape != (self.n,):
            raise ValueError(f"expected {self.n} values, got {values.shape}")
        # An inactive stream's sample becomes NaN, the skip the step reads:
        # the sample and the mask cross to the device as one array.
        vals = np.full(self.b, np.nan)
        vals[:self.n] = values if active is None else \
            np.where(np.asarray(active, bool), values, np.nan)
        t0 = time.perf_counter()
        state, ring, rn, flags = _detector_observe(
            self._state, self._params, self._const, self._ring, self._rn,
            torch.as_tensor(vals, device=self.device), self._k_sigma,
            self._warm)
        self._state.err.copy_(state.err)
        self._state.err_n.copy_(state.err_n)
        self._ring, self._rn = ring, rn
        out = flags.cpu().numpy()[:self.n]
        self.wall_s += time.perf_counter() - t0
        self.n_samples += 1
        return out
