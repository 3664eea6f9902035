"""Exporters: Chrome-trace JSON and the schema-versioned bench file.

Two artifact formats leave this module, with the reference's schema
strings, so that its ``scripts/obs_report.py`` reads the port's files and
the reference's readers take them as their own:

* **Chrome trace** (``chrome_trace`` / ``write_chrome_trace``): the Trace
  Event Format's ``"X"`` complete events, loadable in Perfetto or
  ``chrome://tracing``. The metrics snapshot rides along under
  ``otherData`` so one file carries the whole observation.
* **Bench trajectory** (``make_bench``, ``merge_bench``, ``diff_bench``): a
  flat, schema-versioned JSON document of benchmark legs. Identity
  (engine, device count, seed, mode) lives in the leg payload, never in
  the file name. Legs are keyed by :func:`leg_key`; :func:`diff_bench`
  compares throughput (``scenario_steps_per_s``, higher is better) between
  snapshots with a relative noise tolerance.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from . import trace as _trace

__all__ = [
    "TRACE_SCHEMA", "BENCH_SCHEMA", "chrome_trace", "write_chrome_trace",
    "make_leg", "make_bench", "merge_bench", "load_bench", "leg_key",
    "diff_bench", "format_diff",
]

TRACE_SCHEMA = "repro.trace/1"
BENCH_SCHEMA = "repro.bench/1"

# The throughput field diffed between snapshots; higher is better.
THROUGHPUT_FIELD = "scenario_steps_per_s"


# -- Chrome trace -------------------------------------------------------------
def chrome_trace(tracer: Optional[_trace.Tracer] = None,
                 include_metrics: bool = True) -> Dict[str, Any]:
    tr = tracer if tracer is not None else _trace.tracer()
    events = [{
        "name": r.name,
        "cat": r.name.split(".", 1)[0],
        "ph": "X",
        "ts": r.ts_ns / 1e3,     # trace-event timestamps are micros
        "dur": r.dur_ns / 1e3,
        "pid": 1,
        "tid": 1,
        "args": dict(r.attrs, depth=r.depth),
    } for r in tr.events]
    other: Dict[str, Any] = {"schema": TRACE_SCHEMA,
                             "dropped_spans": tr.dropped}
    if include_metrics:
        other["metrics"] = _metrics.snapshot()
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(path: str,
                       tracer: Optional[_trace.Tracer] = None,
                       include_metrics: bool = True) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, include_metrics), f, indent=1)


# -- Bench trajectory ---------------------------------------------------------
def make_leg(*, engine: str, devices: int, seed: int,
             **fields: Any) -> Dict[str, Any]:
    """One benchmark leg. Identity fields are keyword-only so every
    payload records engine/devices/seed explicitly."""
    leg = {"engine": engine, "devices": int(devices), "seed": int(seed)}
    leg.update(fields)
    return leg


def make_bench(bench: str, legs: Sequence[Dict[str, Any]],
               params: Optional[Dict[str, Any]] = None,
               metrics: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    payload: Dict[str, Any] = {"legs": list(legs)}
    if params:
        payload["params"] = params
    if metrics:
        payload["metrics"] = metrics
    return {bench: payload}


def merge_bench(path: str, bench: str, legs: Sequence[Dict[str, Any]],
                params: Optional[Dict[str, Any]] = None,
                metrics: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Merge one bench section into the trajectory file at ``path``
    (creating it if absent), preserving other benches' sections."""
    try:
        doc = load_bench(path)
    except (OSError, ValueError):
        doc = {"schema": BENCH_SCHEMA, "benches": {}}
    doc["benches"].update(make_bench(bench, legs, params, metrics))
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def load_bench(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema != BENCH_SCHEMA:
        raise ValueError(f"{path}: unsupported bench schema {schema!r} "
                         f"(expected {BENCH_SCHEMA!r})")
    doc.setdefault("benches", {})
    return doc


def leg_key(bench: str, leg: Dict[str, Any]) -> Tuple:
    """Stable identity of a leg across snapshots."""
    return (bench, leg.get("mode"), leg.get("engine"),
            leg.get("devices"), leg.get("scenarios"), leg.get("seed"))


def diff_bench(old: Dict[str, Any], new: Dict[str, Any],
               rel_tol: float = 0.20) -> Tuple[List[Dict[str, Any]], int]:
    """Compare two bench documents leg by leg.

    Returns ``(rows, n_regressions)``. A leg regresses when its throughput
    drops by strictly more than ``rel_tol`` relative to the old snapshot;
    the default 20% is deliberately loose because single runs on shared
    machines are noisy.
    """
    old_legs = {leg_key(b, leg): leg
                for b, sec in old.get("benches", {}).items()
                for leg in sec.get("legs", [])}
    rows: List[Dict[str, Any]] = []
    n_regressions = 0
    for b, sec in new.get("benches", {}).items():
        for leg in sec.get("legs", []):
            key = leg_key(b, leg)
            prev = old_legs.get(key)
            row: Dict[str, Any] = {"key": key}
            if prev is None:
                row["status"] = "new"
            else:
                o, n = prev.get(THROUGHPUT_FIELD), leg.get(THROUGHPUT_FIELD)
                if not o or n is None:
                    row["status"] = "no-throughput"
                else:
                    ratio = float(n) / float(o)
                    row.update(old=float(o), new=float(n), ratio=ratio)
                    if ratio < 1.0 - rel_tol:
                        row["status"] = "REGRESSION"
                        n_regressions += 1
                    elif ratio > 1.0 + rel_tol:
                        row["status"] = "improved"
                    else:
                        row["status"] = "ok"
            rows.append(row)
    return rows, n_regressions


def format_diff(rows: Sequence[Dict[str, Any]], rel_tol: float) -> List[str]:
    lines = [f"# bench diff ({THROUGHPUT_FIELD}, tolerance "
             f"{rel_tol:.0%} — single-run CI numbers are noisy)"]
    for row in rows:
        bench, mode, engine, devices, scen, seed = row["key"]
        ident = (f"{bench}[mode={mode} engine={engine} devices={devices} "
                 f"S={scen} seed={seed}]")
        if "ratio" in row:
            lines.append(f"{row['status']:>12s}  {ident}  "
                         f"{row['old']:.1f} -> {row['new']:.1f} "
                         f"({row['ratio']:.2f}x)")
        else:
            lines.append(f"{row['status']:>12s}  {ident}")
    return lines
