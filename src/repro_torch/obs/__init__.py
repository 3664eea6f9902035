"""repro_torch.obs: sweep-wide tracing and metrics for the port.

Host-side, opt-in observability for the sweep stack and the fleet:

* :mod:`repro_torch.obs.trace`: nestable spans with monotonic ns
  timestamps and a zero-cost no-op path while disabled;
* :mod:`repro_torch.obs.metrics`: counters, gauges and fixed-bucket
  histograms, plus kernel-library loads and kernel launch counts;
* :mod:`repro_torch.obs.export`: Chrome-trace (Perfetto) JSON and the
  schema-versioned bench format, with the reference's schema strings;
* :mod:`repro_torch.obs.probe`: the probe proving that instrumentation
  adds no aten operation to a call.

Everything is off by default; ``obs.enable()`` flips one module-level
flag. Results are bit-identical either way: instrumentation only times
the host side and never synchronizes the card, copies or reads a tensor
back. On the card a span around a launch therefore measures its
dispatch, not its device time.
"""
from __future__ import annotations

import time
from typing import Any

from . import export, metrics, probe, trace
from .export import (BENCH_SCHEMA, TRACE_SCHEMA, chrome_trace, diff_bench,
                     format_diff, leg_key, load_bench, make_bench, make_leg,
                     merge_bench, write_chrome_trace)
from .metrics import (add_phase, inc, kernel_libs_loaded, observe, registry,
                      set_gauge, snapshot, track_kernel_loads,
                      track_launches)
from .probe import instrumentation_probe
from .trace import (disable, enable, enabled, enabled_scope, force_disabled,
                    force_enabled, span, tracer)

__all__ = [
    "trace", "metrics", "export", "probe",
    "span", "tracer", "enable", "disable", "enabled", "enabled_scope",
    "force_enabled", "force_disabled",
    "inc", "set_gauge", "observe", "add_phase", "track_kernel_loads",
    "kernel_libs_loaded", "track_launches", "registry", "snapshot",
    "chrome_trace", "write_chrome_trace", "make_leg", "make_bench",
    "merge_bench", "load_bench", "diff_bench", "format_diff", "leg_key",
    "BENCH_SCHEMA", "TRACE_SCHEMA",
    "instrumentation_probe", "timed_phase", "reset",
]


class _NullTimedPhase:
    __slots__ = ()

    def __enter__(self) -> "_NullTimedPhase":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_TIMED_PHASE = _NullTimedPhase()


class _TimedPhase:
    """Span and per-phase wall counter in one context manager."""
    __slots__ = ("_phase", "_span", "_t0")

    def __init__(self, phase: str, name: str, attrs: dict):
        self._phase = phase
        self._span = trace.tracer().span(name, attrs)
        self._t0 = 0.0

    def __enter__(self) -> "_TimedPhase":
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        wall = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        metrics.add_phase(self._phase, wall)


def timed_phase(phase: str, name: str, **attrs: Any):
    """Open span ``name`` and accumulate its wall into
    ``phase.<phase>_wall_s``. No-op singleton while obs is disabled."""
    if not trace._ENABLED:
        return _NULL_TIMED_PHASE
    return _TimedPhase(phase, name, attrs)


def reset() -> None:
    """Clear collected spans and metrics (the enabled flag is untouched)."""
    trace.tracer().clear()
    metrics.clear()
