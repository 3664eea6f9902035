"""Recovery-time measurement via online-ARIMA anomaly detection (paper §2.3).

The paper trains an identity-predictor on positive (healthy) executions of the
(input throughput, consumer lag) metric streams; deviations of the one-step
prediction error beyond a threshold derived from past errors flag an anomalous
state, and *recovery time = contiguous time spent anomalous* — from failure
onset until the job has caught back up to the head of the queue (not merely
until processing resumes).

Two detector backends share these semantics, picked through
:data:`repro_torch.core.registry.DETECTOR_BACKENDS`:

* ``"scalar"`` — one :class:`MetricDetector` per metric stream (float64
  NumPy on the host, ring-buffered error windows), a copy of the
  reference's;
* ``"bank"`` — every stream of the set in one
  :class:`~repro_torch.core.forecast_bank.DetectorBank` on a device (float64
  torch: batched one-step predictors, streaming-MAD thresholds over fixed
  rings, and the ARIMA step as one ``arima_chunk`` call a sample).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from .forecast import OnlineARIMA
from .registry import DETECTOR_BACKENDS

#: Error window the MAD threshold is computed over (the 512-sample slice the
#: original unbounded implementation took on read).
DETECTOR_ERR_WINDOW = 512


@dataclass
class MetricDetector:
    """One-step-ahead predictor + robust error threshold for one metric."""

    name: str
    k_sigma: float = 5.0
    min_warmup: int = 12
    model: OnlineARIMA = field(default_factory=lambda: OnlineARIMA(p=4, d=1))
    _errors: Deque[float] = field(default_factory=deque)

    def __post_init__(self) -> None:
        self._errors = deque(self._errors, maxlen=DETECTOR_ERR_WINDOW)

    def observe(self, value: float) -> bool:
        """Feed one sample; returns True when the sample is anomalous.

        Non-finite samples are ignored (metric gaps must not poison the
        error window)."""
        if not np.isfinite(value):
            return False
        anomalous = False
        pred = None
        if self.model.n_observed >= self.min_warmup:
            pred = float(self.model.forecast(1)[0])
            if not np.isfinite(pred):
                # A sick model must not poison the healthy-error ring (a
                # single NaN would disable the MAD threshold forever);
                # treat the sample as warmup and re-learn from the value.
                pred = None
            else:
                err = abs(value - pred)
                scale = self._threshold()
                anomalous = err > scale
                if not anomalous:
                    self._errors.append(err)
        # The detector is trained on positive executions only (paper §2.3):
        # anomalous samples must not teach the model the outage regime, or a
        # constant-zero throughput would look 'normal' within a few steps.
        # During an anomaly the model coasts on its own prediction.
        self.model.update(value if not anomalous or pred is None else pred)
        return anomalous

    def _threshold(self) -> float:
        if len(self._errors) < self.min_warmup:
            return float("inf")
        e = np.asarray(self._errors)
        mad = np.median(np.abs(e - np.median(e))) * 1.4826
        return float(np.median(e) + self.k_sigma * max(mad, 1e-9))


#: Registered detector backends share one factory signature:
#: ``backend(metrics, device) -> impl`` where ``impl.fired(values) -> int``
#: counts the metric streams that flagged this sample as anomalous.

@DETECTOR_BACKENDS.register("scalar")
class ScalarDetectorSet:
    """One float64 :class:`MetricDetector` per stream (reference oracle, on
    the host whatever ``device`` says)."""

    def __init__(self, metrics, device: str = "cuda"):
        del device
        self.detectors = {m: MetricDetector(m) for m in metrics}

    def fired(self, values: Dict[str, float]) -> int:
        return sum(1 for m, v in values.items()
                   if m in self.detectors and self.detectors[m].observe(v))


@DETECTOR_BACKENDS.register("bank")
class BankedDetectorSet:
    """Every stream through one :class:`DetectorBank` on ``device``."""

    def __init__(self, metrics, device: str = "cuda"):
        from .forecast_bank import DetectorBank   # lazy: avoids a cycle
        self.metrics = tuple(metrics)
        self.bank = DetectorBank(len(self.metrics), device=device)

    def fired(self, values: Dict[str, float]) -> int:
        vals = np.array([values.get(m, np.nan) for m in self.metrics],
                        np.float64)
        return int(self.bank.observe(vals).sum())


def _bank_detector_probe(device: str = "cuda"):
    from .forecast_bank import detector_contract_probe   # lazy: a cycle
    return detector_contract_probe(device)


def _scalar_detector_probe(device: str = "cuda"):
    from ..analysis.contracts import host_probe
    return host_probe("detector backend:scalar",
                      "per-metric float64 NumPy detectors on the host — the "
                      "reference oracle, no device call")


DETECTOR_BACKENDS.attach_contract("bank", _bank_detector_probe)
DETECTOR_BACKENDS.attach_contract("scalar", _scalar_detector_probe)


@dataclass
class RecoveryTracker:
    """Tracks the anomalous-state span across several metric detectors.

    Feed (timestamp, {metric: value}); when an anomalous episode closes,
    :attr:`last_recovery_s` holds its duration. The paper's two signals are
    input throughput and average consumer lag. ``detector_backend`` names
    an entry of :data:`~repro_torch.core.registry.DETECTOR_BACKENDS`;
    ``device`` is where a ``"bank"`` detector keeps its state (the card by
    default; it raises where there is none, so pass ``device="cpu"``), and
    the ``"scalar"`` one ignores it.
    """

    metrics: tuple = ("throughput", "consumer_lag")
    quorum: int = 1            # how many metrics must fire to call it anomalous
    close_after: int = 3       # healthy samples required to close an episode
    detector_backend: str = "scalar"
    device: str = "cuda"
    detectors: Dict[str, MetricDetector] = field(default_factory=dict)
    _open_since: Optional[float] = None
    _healthy_streak: int = 0
    _last_ts: Optional[float] = None
    last_recovery_s: Optional[float] = None
    episodes: List[tuple] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._impl = DETECTOR_BACKENDS.get(self.detector_backend)(
            self.metrics, self.device)
        # Back-compat: the scalar per-metric detectors stay reachable.
        self.detectors = getattr(self._impl, "detectors", {})

    def _fired(self, values: Dict[str, float]) -> int:
        return self._impl.fired(values)

    def observe(self, ts: float, values: Dict[str, float]) -> bool:
        anomalous = self._fired(values) >= self.quorum
        if anomalous:
            if self._open_since is None:
                self._open_since = ts
            self._healthy_streak = 0
        elif self._open_since is not None:
            self._healthy_streak += 1
            if self._healthy_streak >= self.close_after:
                # Recovery completes at the first healthy sample of the streak.
                end = self._last_healthy_start(ts)
                self.last_recovery_s = max(end - self._open_since, 0.0)
                self.episodes.append((self._open_since, end))
                self._open_since = None
                self._healthy_streak = 0
        self._last_ts = ts
        return anomalous

    def _last_healthy_start(self, ts: float) -> float:
        # Approximate: assume uniform sampling; back off (streak-1) intervals.
        if self._last_ts is None:
            return ts
        dt = ts - self._last_ts
        return ts - dt * (self._healthy_streak - 1)

    @property
    def in_anomaly(self) -> bool:
        return self._open_since is not None
