"""Counters, gauges and fixed-bucket histograms for the sweep stack.

All mutation helpers (:func:`inc`, :func:`observe`, :func:`set_gauge`,
:func:`add_phase`, :func:`track_kernel_loads`, :func:`track_launches`) are
no-ops while obs is disabled: one module-level bool check, as in
``trace.span``. The registry itself is always importable and inspectable,
so exporters and tests can read a snapshot without flipping the flag.

Naming conventions:

* dotted lowercase names, most general prefix first: ``sweep.ticks``,
  ``transfer.h2d_bytes``, ``phase.simulate_wall_s``;
* per-phase walls are float counters named ``phase.<name>_wall_s`` with
  ``<name>`` in :data:`PHASES` (the fleet adds ``fleet``);
* the port runs eagerly and has no jit cache. What it loads once per
  process is a kernel library (:data:`repro_torch.kernels.build.load_wall_s`):
  ``kernel_loads.<site>`` counts the growth of the number a call site's
  kernels have loaded and the gauge ``kernel_libs.<site>`` holds that
  number; ``launches.<kernel>`` gauges hold each kernel wrapper's own
  ``.launches`` counter as a call site last read it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..kernels import build as _build
from . import trace as _trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "inc", "set_gauge", "observe", "add_phase", "track_kernel_loads",
    "kernel_libs_loaded", "track_launches", "snapshot", "clear", "PHASES",
]

PHASES = ("simulate", "forecast", "detect", "fit", "acquire")

Num = Union[int, float]


class Counter:
    """Monotonically increasing numeric metric (int or float)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Num = 0

    def inc(self, n: Num = 1) -> None:
        self.value += n


class Gauge:
    """Last-value metric."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[Num] = None

    def set(self, v: Num) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper edges; one
    implicit overflow bucket catches everything above the last edge."""
    __slots__ = ("name", "buckets", "counts", "total", "sum")

    def __init__(self, name: str, buckets: Sequence[float]):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: Num) -> None:
        i = 0
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += 1
        self.sum += float(v)


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name)
        return m

    def histogram(self, name: str,
                  buckets: Sequence[float]) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, buckets)
        return m

    def snapshot(self) -> Dict[str, Any]:
        """Flat, JSON-ready view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}``."""
        counters: Dict[str, Num] = {}
        gauges: Dict[str, Num] = {}
        hists: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    gauges[name] = m.value
            else:
                hists[name] = {"buckets": list(m.buckets),
                               "counts": list(m.counts),
                               "total": m.total, "sum": m.sum}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def clear(self) -> None:
        self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def inc(name: str, n: Num = 1) -> None:
    if not _trace._ENABLED:
        return
    _REGISTRY.counter(name).inc(n)


def set_gauge(name: str, v: Num) -> None:
    if not _trace._ENABLED:
        return
    _REGISTRY.gauge(name).set(v)


def observe(name: str, v: Num, buckets: Sequence[float]) -> None:
    if not _trace._ENABLED:
        return
    _REGISTRY.histogram(name, buckets).observe(v)


def add_phase(phase: str, wall_s: float) -> None:
    """Accumulate into the per-phase wall counter
    ``phase.<phase>_wall_s``."""
    if not _trace._ENABLED:
        return
    _REGISTRY.counter(f"phase.{phase}_wall_s").inc(float(wall_s))


def kernel_libs_loaded(sources: Sequence[str]) -> int:
    """How many of the kernel libraries built from ``csrc/<source>.cu``
    this process has loaded (:data:`repro_torch.kernels.build.load_wall_s`
    records each at its first use)."""
    loaded = _build.load_wall_s
    return sum(s in loaded for s in sources)


def track_kernel_loads(name: str, size: int) -> None:
    """Record kernel-library loads for call site ``name``: bumps the
    counter ``kernel_loads.<name>`` by the growth since the last sample and
    keeps the number in the gauge ``kernel_libs.<name>``."""
    if not _trace._ENABLED:
        return
    g = _REGISTRY.gauge(f"kernel_libs.{name}")
    prev = g.value or 0
    if size > prev:
        _REGISTRY.counter(f"kernel_loads.{name}").inc(size - prev)
    g.set(size)


def track_launches(kernel: Any) -> None:
    """Keep a kernel wrapper's own ``.launches`` counter in the gauge
    ``launches.<wrapper name>``."""
    if not _trace._ENABLED:
        return
    _REGISTRY.gauge(f"launches.{kernel.__name__}").set(kernel.launches)


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def clear() -> None:
    _REGISTRY.clear()
