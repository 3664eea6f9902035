"""Span-based host-side tracer with a zero-cost disabled path.

Design constraints:

* Spans live strictly on the *host*. Opening a span never creates a
  tensor, never synchronizes the card, never copies and never changes
  which operations run: :func:`repro_torch.obs.probe.instrumentation_probe`
  pins this by counting the aten operations of a call with obs forced off
  and forced on. The card runs asynchronously, so a span around a kernel
  launch times the launch's dispatch, not its device time.
* While tracing is disabled (the default) ``span(...)`` is one
  module-level bool check followed by returning a shared no-op singleton:
  no allocation, no timestamps, no attribute dict materialization.
* Timestamps are ``time.perf_counter_ns()`` (monotonic, ns resolution),
  recorded relative to the tracer's epoch so exported traces start at 0.

The tracer is a process-global singleton (a sweep is one host loop).
Nesting depth is tracked with an explicit stack so exporters can rebuild
the hierarchy without relying on timestamp containment.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "SpanRecord", "Tracer", "tracer", "span", "enable", "disable",
    "enabled", "enabled_scope", "force_enabled", "force_disabled",
]

# Module-level flag checked on every span() call, kept as a plain bool so
# the disabled path is as close to free as Python allows.
_ENABLED: bool = False
_TORCH_PROFILER: bool = False

# Cap on retained span records; beyond it spans are timed but dropped, and
# the drop count is reported so truncation is never silent.
DEFAULT_MAX_EVENTS = 500_000


@dataclass
class SpanRecord:
    """One finished span. Timestamps are ns since the tracer epoch."""
    name: str
    ts_ns: int
    dur_ns: int
    depth: int
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth", "_annot")

    def __init__(self, tr: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tr
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._depth = 0
        self._annot: Any = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self._depth = len(tr._stack)
        tr._stack.append(self)
        if _TORCH_PROFILER:  # optional device-trace bridge
            annot = _trace_annotation(self.name)
            annot.__enter__()
            self._annot = annot
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        t1 = time.perf_counter_ns()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        tr = self._tracer
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        tr._record(SpanRecord(self.name, self._t0 - tr.epoch_ns,
                              t1 - self._t0, self._depth, self.attrs))


def _trace_annotation(name: str) -> Any:
    """A ``torch.profiler.record_function`` range, so that the operations
    and kernels a ``torch.profiler`` capture records nest under the host
    spans."""
    from torch.profiler import record_function
    return record_function(name)


class Tracer:
    """Collects finished :class:`SpanRecord`s; exported by obs.export."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self.epoch_ns = time.perf_counter_ns()
        self.max_events = max_events
        self.events: List[SpanRecord] = []
        self.dropped = 0
        self._stack: List[_Span] = []

    def span(self, name: str, attrs: Dict[str, Any]) -> _Span:
        return _Span(self, name, attrs)

    def _record(self, rec: SpanRecord) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(rec)

    def clear(self) -> None:
        self.epoch_ns = time.perf_counter_ns()
        self.events.clear()
        self.dropped = 0
        self._stack.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (valid whether or not tracing is on)."""
    return _TRACER


def span(name: str, **attrs: Any):
    """Open a nestable host-side span.

    Usage::

        with obs.span("engine.fused.interval", K=K):
            ...

    Returns a shared no-op singleton when tracing is disabled.
    """
    if not _ENABLED:
        return _NULL_SPAN
    return _TRACER.span(name, attrs)


def enable(*, torch_profiler: bool = False, clear: bool = False) -> None:
    """Turn tracing and metrics on. ``torch_profiler=True`` also wraps each
    span in a ``torch.profiler.record_function`` range, so that a
    ``torch.profiler`` capture shows the device work under the host
    spans."""
    global _ENABLED, _TORCH_PROFILER
    if clear:
        _TRACER.clear()
    _TORCH_PROFILER = bool(torch_profiler)
    _ENABLED = True


def disable() -> None:
    global _ENABLED, _TORCH_PROFILER
    _ENABLED = False
    _TORCH_PROFILER = False


def enabled() -> bool:
    return _ENABLED


class _EnabledScope:
    """Context manager forcing the enabled flag to a value and restoring
    the previous state on exit; used by tests and by
    :func:`repro_torch.obs.probe.instrumentation_probe`."""
    __slots__ = ("_target", "_prev")

    def __init__(self, target: bool):
        self._target = target
        self._prev = False

    def __enter__(self) -> "_EnabledScope":
        global _ENABLED
        self._prev = _ENABLED
        _ENABLED = self._target
        return self

    def __exit__(self, *exc: object) -> None:
        global _ENABLED
        _ENABLED = self._prev


def enabled_scope() -> _EnabledScope:
    """``with obs.enabled_scope(): ...``: enable tracing for a block."""
    return _EnabledScope(True)


def force_enabled() -> _EnabledScope:
    return _EnabledScope(True)


def force_disabled() -> _EnabledScope:
    return _EnabledScope(False)
