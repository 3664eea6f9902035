"""Online time-series forecasting (paper §2.2): the scalar forecaster zoo.

The paper uses an online ARIMA model (pmdarima in the prototype) for workload
prediction. We implement the standard *online ARIMA* construction (Liu et al.,
also the basis of the VNF-monitoring detector the paper cites [30]): the
ARIMA(p, d, q) process is approximated by a higher-order AR(p + m) model on the
d-times differenced series, whose coefficients are tracked with recursive
least squares and a forgetting factor. This gives O(k²) per-sample updates,
no batch refits, and multistep-ahead forecasts by iterated rollout.

Forecaster choice materially changes DSP scaling quality (Gontarska et al.,
"Evaluation of Load Prediction Techniques for Distributed Stream
Processing"), so the model is pluggable: every forecaster implements the
same small protocol —

* ``update(value)``   — ingest one observation (non-finite values are
  ignored); O(1) state, bounded memory;
* ``forecast(steps)`` — multistep-ahead rollout in original units;
* ``residual_std()``  — robust scale of recent one-step errors;
* ``last()`` / ``n_observed`` — latest level and number of updates.

The zoo: :class:`OnlineARIMA` (RLS-tracked AR on the differenced series),
:class:`HoltWinters` (additive double exponential smoothing with optional
additive seasonality) and :class:`SeasonalNaive` (last-season replay). All
three are scalar float64 NumPy *reference oracles*; the batched torch
implementations live in :mod:`repro_torch.core.forecast_bank` and are
pinned against these step-for-step.

All state is ring-buffered: histories keep just the ``p + d`` lags the
update needs and error windows are capped (:data:`ERR_WINDOW`), so
arbitrarily long runs use constant memory.

The forecast post-processing follows the paper exactly: the horizon is
partitioned into averaging bins and the bin with the **highest average** is
returned — for a rising workload that is the furthest bin (longevity of the
reconfiguration), for a falling one the nearest (don't downscale early).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

import numpy as np

from .registry import FORECASTERS

#: Residual window shared by ``residual_std`` across the zoo (the 256-sample
#: window the original unbounded implementation sliced on read).
ERR_WINDOW = 256

#: RLS anti-windup guard: without persistent excitation the forgetting
#: factor inflates the covariance like λ^-t without bound, which makes the
#: recursion numerically chaotic in long runs. When trace(P) exceeds
#: ``ridge · (p + 1) · P_TRACE_CAP`` the whole matrix is rescaled onto the
#: cap — memory of ~log(cap)/(1-λ) samples is kept, the blow-up is not.
P_TRACE_CAP = 1e4

#: Rollout stability guard: iterated AR rollout diverges geometrically when
#: the tracked coefficients momentarily leave the stable region (routine
#: under a forgetting factor on noisy data). Each predicted *difference* is
#: clamped to this multiple of the largest lag magnitude at rollout start,
#: which bounds an H-step forecast by ~H · cap · |lags| instead of λ_max^H.
ROLLOUT_DIFF_CAP = 10.0


@dataclass
class OnlineARIMA:
    """AR(k) on the d-differenced series with RLS coefficient tracking."""

    p: int = 8                 # effective AR order (p + folded MA terms)
    d: int = 1                 # differencing order
    forgetting: float = 0.995  # RLS forgetting factor
    ridge: float = 10.0        # initial P = ridge * I (RLS covariance)

    _history: Deque[float] = field(default_factory=deque)
    _w: np.ndarray | None = None             # AR coefficients (+ bias)
    _P: np.ndarray | None = None             # RLS inverse covariance
    _errors: Deque[float] = field(default_factory=deque)
    _n_seen: int = 0

    def __post_init__(self) -> None:
        # Differencing is local, so p + d + 1 samples reproduce the
        # unbounded-history update exactly; older samples never matter.
        self._history = deque(self._history, maxlen=self.p + self.d + 1)
        self._errors = deque(self._errors, maxlen=ERR_WINDOW)
        self._n_seen = max(self._n_seen, len(self._history))

    # -- internals -----------------------------------------------------------
    def _difference(self, series: np.ndarray) -> np.ndarray:
        for _ in range(self.d):
            series = np.diff(series)
        return series

    def _phi(self, diffed: np.ndarray) -> np.ndarray:
        """Regression vector: last p differenced values (newest first) + bias."""
        lags = diffed[-self.p:][::-1]
        return np.concatenate([lags, [1.0]])

    # -- online API ------------------------------------------------------------
    def update(self, value: float) -> None:
        """Ingest one observation; one RLS step when enough history exists.

        Non-finite observations are ignored (the detector path may see gaps)."""
        if not np.isfinite(value):
            return
        self._history.append(float(value))
        self._n_seen += 1
        if self._n_seen < self.p + self.d + 1:
            return
        series = np.asarray(self._history, np.float64)
        diffed = self._difference(series)
        phi = self._phi(diffed[:-1])
        target = diffed[-1]
        if self._w is None:
            self._w = np.zeros(self.p + 1)
            self._P = np.eye(self.p + 1) * self.ridge
        # RLS with forgetting factor.
        P, w, lam = self._P, self._w, self.forgetting
        Pphi = P @ phi
        gain = Pphi / (lam + phi @ Pphi)
        err = target - w @ phi
        self._errors.append(float(err))
        self._w = w + gain * err
        P = (P - np.outer(gain, Pphi)) / lam
        # The rank-1 downdate is symmetric in exact arithmetic; re-symmetrize
        # so roundoff cannot accumulate into an indefinite P (which sends the
        # gain, and then w, non-finite on weakly-excited streams).
        P = 0.5 * (P + P.T)
        tr = float(np.trace(P))
        cap = self.ridge * (self.p + 1) * P_TRACE_CAP
        if tr > cap:
            P *= cap / tr
        self._P = P
        # Safety net: if the recursion still diverged, restart the tracker
        # from its prior instead of poisoning every later update.
        if not (np.isfinite(self._w).all() and np.isfinite(self._P).all()):
            self._w = np.zeros(self.p + 1)
            self._P = np.eye(self.p + 1) * self.ridge

    def forecast(self, steps: int) -> np.ndarray:
        """Iterated multistep-ahead forecast in original units."""
        if not self._history:
            return np.zeros(steps)
        if self._w is None:
            return np.full(steps, self._history[-1])
        series = np.asarray(self._history, np.float64)
        diffed = list(self._difference(series))
        # tails[j] = last value of the j-times-differenced series; inverting
        # the d-th difference cascades through every order, newest first.
        tails = [float(np.diff(series, n=j)[-1]) for j in range(self.d)]
        lim = ROLLOUT_DIFF_CAP * max(1.0,
                                     float(np.max(np.abs(diffed[-self.p:]))))
        out = []
        for _ in range(steps):
            phi = self._phi(np.asarray(diffed))
            dnext = float(np.clip(self._w @ phi, -lim, lim))
            diffed.append(dnext)
            diffed = diffed[-self.p:]
            v = dnext
            for j in range(self.d - 1, -1, -1):
                v = v + tails[j]
                tails[j] = v
            out.append(v)
        return np.asarray(out)

    def residual_std(self) -> float:
        if len(self._errors) < 4:
            return float("inf")
        return float(np.std(np.asarray(self._errors)))

    @property
    def n_observed(self) -> int:
        return self._n_seen

    def last(self) -> float:
        return self._history[-1] if self._history else 0.0


@dataclass
class HoltWinters:
    """Additive Holt(-Winters) exponential smoothing.

    Double exponential smoothing over level + trend; ``season > 0`` adds an
    additive seasonal ring of that period (Winters' form). A robust default
    when the workload is smooth but non-stationary.
    """

    alpha: float = 0.5         # level smoothing
    beta: float = 0.1          # trend smoothing
    gamma: float = 0.1         # seasonal smoothing (when season > 0)
    season: int = 0            # seasonal period in samples (0 = none)

    _level: float = 0.0
    _trend: float = 0.0
    _seasonal: np.ndarray | None = None
    _errors: Deque[float] = field(default_factory=deque)
    _n_seen: int = 0
    _last: float = 0.0

    def __post_init__(self) -> None:
        self._seasonal = np.zeros(max(self.season, 1))
        self._errors = deque(self._errors, maxlen=ERR_WINDOW)

    def update(self, value: float) -> None:
        if not np.isfinite(value):
            return
        v = float(value)
        i = self._n_seen % len(self._seasonal)
        s_old = self._seasonal[i] if self.season else 0.0
        if self._n_seen > 0:
            self._errors.append(v - (self._level + self._trend + s_old))
            prev = self._level + self._trend
            level = self.alpha * (v - s_old) + (1.0 - self.alpha) * prev
            self._trend = (self.beta * (level - self._level)
                           + (1.0 - self.beta) * self._trend)
            self._level = level
            if self.season:
                self._seasonal[i] = (self.gamma * (v - level)
                                     + (1.0 - self.gamma) * s_old)
        else:
            self._level, self._trend = v, 0.0
        self._last = v
        self._n_seen += 1

    def forecast(self, steps: int) -> np.ndarray:
        if self._n_seen == 0:
            return np.zeros(steps)
        k = np.arange(1, steps + 1, dtype=np.float64)
        out = self._level + k * self._trend
        if self.season:
            idx = (self._n_seen + np.arange(steps)) % self.season
            out = out + self._seasonal[idx]
        return out

    def residual_std(self) -> float:
        if len(self._errors) < 4:
            return float("inf")
        return float(np.std(np.asarray(self._errors)))

    @property
    def n_observed(self) -> int:
        return self._n_seen

    def last(self) -> float:
        return self._last


@dataclass
class SeasonalNaive:
    """Forecast = the value one season ago (wrapping beyond one season).

    The strongest trivial baseline on strongly periodic workloads and the
    standard yardstick the load-prediction literature measures against.
    """

    season: int = 12           # period in samples

    _ring: Deque[float] = field(default_factory=deque)
    _errors: Deque[float] = field(default_factory=deque)
    _n_seen: int = 0
    _last: float = 0.0

    def __post_init__(self) -> None:
        if self.season < 1:
            raise ValueError("SeasonalNaive needs season >= 1")
        self._ring = deque(self._ring, maxlen=self.season)
        self._errors = deque(self._errors, maxlen=ERR_WINDOW)

    def update(self, value: float) -> None:
        if not np.isfinite(value):
            return
        v = float(value)
        if self._n_seen >= self.season:
            self._errors.append(v - self._ring[0])
        elif self._n_seen > 0:
            self._errors.append(v - self._last)
        self._ring.append(v)
        self._last = v
        self._n_seen += 1

    def forecast(self, steps: int) -> np.ndarray:
        if self._n_seen == 0:
            return np.zeros(steps)
        if self._n_seen < self.season:
            return np.full(steps, self._last)
        ring = np.asarray(self._ring, np.float64)
        return ring[np.arange(steps) % self.season]

    def residual_std(self) -> float:
        if len(self._errors) < 4:
            return float("inf")
        return float(np.std(np.asarray(self._errors)))

    @property
    def n_observed(self) -> int:
        return self._n_seen

    def last(self) -> float:
        return self._last


#: Built-in scalar forecaster kinds (mirrored by the batched bank). The
#: authoritative namespace is :data:`repro_torch.core.registry.FORECASTERS` —
#: third-party kinds registered there are instantly usable on the scalar
#: backend (the batched ForecastBank covers the built-ins only).
FORECASTER_KINDS = ("arima", "holt", "seasonal")

#: Per-kind default constructor arguments (the controller's TSF settings).
FORECASTER_DEFAULTS = {
    "arima": dict(p=8, d=1),
    "holt": dict(alpha=0.5, beta=0.1),
    "seasonal": dict(season=12),
}

FORECASTERS.register("arima", OnlineARIMA)
FORECASTERS.register("holt", HoltWinters)
FORECASTERS.register("seasonal", SeasonalNaive)


def make_scalar_forecaster(kind: str, **kwargs):
    """Instantiate one scalar zoo member by registered kind name."""
    cls = FORECASTERS.get(kind)
    return cls(**{**FORECASTER_DEFAULTS.get(kind, {}), **kwargs})


def binned_forecast(model, horizon: int, bins: int) -> float:
    """Paper §2.2: split the horizon into averaging bins, return the bin with
    the highest average value (clamped at zero — rates are non-negative).
    ``model`` is any zoo forecaster (scalar or bank-backed); bank views
    serve the decision from one batched computation across all streams."""
    fast = getattr(model, "binned", None)
    if fast is not None:
        return fast(horizon, bins)
    fc = np.maximum(model.forecast(horizon), 0.0)
    if len(fc) == 0:
        return 0.0
    bins = max(bins, 1)
    if len(fc) % bins == 0:
        # Equal bins: reshape-mean (same values as array_split, hot path).
        return float(fc.reshape(bins, -1).mean(axis=1).max())
    splits = np.array_split(fc, bins)
    means = [float(s.mean()) for s in splits if len(s)]
    return max(means) if means else 0.0
