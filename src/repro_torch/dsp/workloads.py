"""Workload trace generators mirroring the paper's two experiments (§3.4).

* YSB-like: the Avazu click-through trace the paper subsamples is highly
  variable, covers a wide rate range (~25K-80K events/s) and has no long-term
  trend. We synthesize that shape: an Ornstein-Uhlenbeck random walk around a
  slowly wandering mean plus occasional spikes, clipped to the paper's range.
* TSW-like: the SUMO TAPASCologne vehicle trace has a clear seasonal (daily)
  pattern, fluctuation within bands and a weak upward trend, repeated 3x.

Both run 18 simulated hours like the paper's experiments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Trace:
    """A rate trace sampled at ``dt_s`` resolution."""

    rates: np.ndarray
    dt_s: float
    name: str

    @property
    def duration_s(self) -> float:
        return len(self.rates) * self.dt_s

    def rate_at(self, t_s: float) -> float:
        idx = int(np.clip(t_s / self.dt_s, 0, len(self.rates) - 1))
        return float(self.rates[idx])


def _smooth(x: np.ndarray, window_s: float, dt_s: float) -> np.ndarray:
    """Hanning-smooth ``x``; no-op when the signal is too short to window."""
    k = min(max(int(window_s / dt_s), 3), len(x))
    if k < 3:
        return x
    kernel = np.hanning(k)
    return np.convolve(x, kernel / kernel.sum(), mode="same")


def ysb_like(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
             seed: int = 7) -> Trace:
    """High-variance, trend-free click-stream style workload (Fig. 6a)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    # Slowly wandering mean (hours-scale), OU fluctuation (minutes-scale).
    t = np.arange(n) * dt_s
    knots = rng.uniform(30_000, 70_000, 16)
    mean = np.interp(t, np.linspace(0, duration_s, 16), knots)
    ou = np.zeros(n)
    theta, sigma = 1.0 / 600.0, 400.0
    for i in range(1, n):
        ou[i] = ou[i - 1] - theta * ou[i - 1] * dt_s \
            + sigma * np.sqrt(dt_s) * rng.standard_normal()
    spikes = np.zeros(n)
    for _ in range(10):
        c = rng.integers(0, n)
        w = int(rng.uniform(120, 900) / dt_s)
        amp = rng.uniform(5_000, 18_000) * rng.choice([-1.0, 1.0])
        lo, hi = max(c - w, 0), min(c + w, n)
        spikes[lo:hi] += amp * np.hanning(hi - lo)
    rates = np.clip(mean + ou + spikes, 24_000, 82_000)
    return Trace(rates=rates, dt_s=dt_s, name="ysb")


def tsw_like(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
             seed: int = 11) -> Trace:
    """Seasonal vehicle-count workload with a weak upward trend (Fig. 6b).

    Three repetitions of a 6-hour 'day' (the paper repeats its subsampled
    trace three times)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    t = np.arange(n) * dt_s
    day = duration_s / 3.0
    phase = 2.0 * np.pi * (t % day) / day
    seasonal = 38_000 + 22_000 * np.sin(phase - np.pi / 2) \
        + 6_000 * np.sin(2 * phase)
    trend = 3_000.0 * t / duration_s  # statistically significant weak trend
    # Smooth the noise a little (vehicle counts are not white).
    noise = _smooth(1_500.0 * rng.standard_normal(n), 120.0, dt_s)
    rates = np.clip(seasonal + trend + noise, 8_000, 82_000)
    return Trace(rates=rates, dt_s=dt_s, name="tsw")


def constant(rate: float, duration_s: float = 3600.0, dt_s: float = 5.0
             ) -> Trace:
    return Trace(rates=np.full(int(duration_s / dt_s), float(rate)),
                 dt_s=dt_s, name=f"const-{int(rate)}")


# ---------------------------------------------------------------------------
# Scenario-diversity generators (sweep engine workload classes).
#
# Each generator is deterministic per seed and clips its output to the
# declared [lo, hi] band so sweep consumers can rely on the rate range
# without inspecting the trace.
# ---------------------------------------------------------------------------

def diurnal(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
            seed: int = 3, lo: float = 18_000.0, hi: float = 78_000.0,
            period_s: float = 6 * 3600.0) -> Trace:
    """Day/night load cycle: smooth sinusoid between a quiet trough and a
    busy peak with correlated noise (web/mobile traffic shape)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    t = np.arange(n) * dt_s
    mid, amp = (lo + hi) / 2.0, (hi - lo) / 2.0
    base = mid + 0.82 * amp * np.sin(2.0 * np.pi * t / period_s - np.pi / 2)
    noise = _smooth(0.04 * amp * rng.standard_normal(n), 180.0, dt_s)
    return Trace(rates=np.clip(base + noise, lo, hi), dt_s=dt_s,
                 name="diurnal")


def flash_crowd(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
                seed: int = 5, lo: float = 22_000.0, hi: float = 80_000.0,
                n_events: int = 6, decay_s: float = 900.0) -> Trace:
    """Flash-crowd workload: a calm baseline punctuated by sudden spikes
    that decay exponentially (breaking-news / sale-event shape)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    t = np.arange(n) * dt_s
    base = lo + 0.15 * (hi - lo) * (1.0 + 0.3 * np.sin(
        2.0 * np.pi * t / (4 * 3600.0)))
    rates = base + 0.02 * (hi - lo) * rng.standard_normal(n)
    onsets = np.sort(rng.uniform(0.05, 0.95, n_events)) * duration_s
    for onset in onsets:
        amp = rng.uniform(0.45, 0.95) * (hi - lo)
        ramp_s = rng.uniform(30.0, 180.0)
        dt_from = t - onset
        spike = np.where(
            dt_from < 0.0, 0.0,
            amp * np.minimum(dt_from / ramp_s, 1.0)
            * np.exp(-np.maximum(dt_from - ramp_s, 0.0) / decay_s))
        rates = rates + spike
    return Trace(rates=np.clip(rates, lo, hi), dt_s=dt_s, name="flash")


def regime_switching(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
                     seed: int = 9, lo: float = 20_000.0,
                     hi: float = 80_000.0, mean_dwell_s: float = 2400.0
                     ) -> Trace:
    """Piecewise-stationary workload: the rate holds a level for an
    exponentially-distributed dwell, then jumps to another level (tenant
    onboarding / batch-ingest shape). Edges are smoothed over ~60 s."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    levels = np.linspace(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), 5)
    rates = np.empty(n)
    i, level = 0, float(rng.choice(levels))
    while i < n:
        dwell = max(int(rng.exponential(mean_dwell_s) / dt_s), 1)
        rates[i:i + dwell] = level
        i += dwell
        level = float(rng.choice(levels[levels != level]))
    rates = _smooth(rates, 60.0, dt_s)
    rates += 0.015 * (hi - lo) * rng.standard_normal(n)
    return Trace(rates=np.clip(rates, lo, hi), dt_s=dt_s, name="regime")


def sinusoid_drift(duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
                   seed: int = 13, lo: float = 20_000.0,
                   hi: float = 80_000.0, period_s: float = 2 * 3600.0,
                   drift_frac: float = 0.35) -> Trace:
    """Sinusoid whose mean drifts upward across the run: tests controllers
    against non-stationarity (the forecast must keep re-learning)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / dt_s)
    t = np.arange(n) * dt_s
    span = hi - lo
    mean = lo + 0.25 * span + drift_frac * span * t / duration_s
    wave = 0.18 * span * np.sin(2.0 * np.pi * t / period_s)
    noise = 0.02 * span * rng.standard_normal(n)
    return Trace(rates=np.clip(mean + wave + noise, lo, hi), dt_s=dt_s,
                 name="sindrift")


#: Registry used by the sweep CLI / grid builder (name -> generator).
TRACE_GENERATORS = {
    "ysb": ysb_like,
    "tsw": tsw_like,
    "diurnal": diurnal,
    "flash": flash_crowd,
    "regime": regime_switching,
    "sindrift": sinusoid_drift,
}


def make_trace(kind: str, duration_s: float = 18 * 3600.0, dt_s: float = 5.0,
               seed: Optional[int] = None) -> Trace:
    """Build a named trace class; ``seed=None`` keeps the generator default."""
    try:
        gen = TRACE_GENERATORS[kind]
    except KeyError:
        raise ValueError(f"unknown trace class {kind!r}; "
                         f"available: {sorted(TRACE_GENERATORS)}") from None
    kwargs = {} if seed is None else {"seed": seed}
    return gen(duration_s=duration_s, dt_s=dt_s, **kwargs)


# ---------------------------------------------------------------------------
# Composable failure schedules.
# ---------------------------------------------------------------------------

class FailureSchedule:
    """When to inject timeout failures into a scenario.

    Schedules are composable with ``|``: the union of two schedules injects
    at the merged, deduplicated set of times. Concrete schedules implement
    :meth:`times` which resolves against a run duration."""

    def times(self, duration_s: float) -> np.ndarray:
        raise NotImplementedError

    def __or__(self, other: "FailureSchedule") -> "FailureSchedule":
        return _UnionSchedule(self, other)


class NoFailures(FailureSchedule):
    """Inject nothing (clean-run scenarios)."""

    def times(self, duration_s: float) -> np.ndarray:
        return np.empty(0)

    def __repr__(self) -> str:
        return "NoFailures()"


@dataclass(frozen=True)
class PeriodicFailures(FailureSchedule):
    """Every ``interval_s`` seconds, starting at ``offset_s`` (defaults to
    one interval in, matching the paper's 45-minute cadence). A
    non-positive ``interval_s`` injects nothing."""

    interval_s: float
    offset_s: Optional[float] = None

    def times(self, duration_s: float) -> np.ndarray:
        if self.interval_s <= 0.0:
            return np.empty(0)
        if self.offset_s is not None and self.offset_s <= 0.0:
            raise ValueError(f"offset_s must be positive, got {self.offset_s}")
        start = self.interval_s if self.offset_s is None else self.offset_s
        return np.arange(start, duration_s, self.interval_s, dtype=np.float64)


@dataclass(frozen=True)
class FailuresAt(FailureSchedule):
    """Explicit injection times (seconds from run start)."""

    at_s: tuple

    def __init__(self, *at_s: float):
        object.__setattr__(self, "at_s", tuple(float(t) for t in at_s))

    def times(self, duration_s: float) -> np.ndarray:
        ts = np.asarray(sorted(self.at_s), dtype=np.float64)
        return ts[(ts > 0.0) & (ts < duration_s)]


@dataclass(frozen=True)
class _UnionSchedule(FailureSchedule):
    a: FailureSchedule
    b: FailureSchedule

    def times(self, duration_s: float) -> np.ndarray:
        return np.unique(np.concatenate([self.a.times(duration_s),
                                         self.b.times(duration_s)]))
