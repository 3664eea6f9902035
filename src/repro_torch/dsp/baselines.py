"""Baseline controllers evaluated in the paper (§3.3).

* :class:`StaticController` — the C_max configuration, never reconfigures.
* :class:`ReactiveController` — Apache Flink reactive mode behind a
  Kubernetes HPA targeting 35 % CPU (busy) utilization: scale-out follows the
  classic HPA proportional rule with immediate up-scaling, a 10 % tolerance
  band and a 5-minute down-scale stabilization window (the recommended
  reactive-mode setup the paper uses).
* :class:`DS2Controller` — the Flink-operator DS2 autoscaler configured as in
  the paper: 35 % target utilization with a 15 % boundary, 2-minute
  stabilization interval, 1-minute metric windows, and a 1-minute restart +
  5-minute assumed catch-up pause after every scaling (during which it is
  blind — the behaviour that produces its characteristic post-failure
  missteps).

All baselines pin CPU=1 core, memory=4096 MB, 1 slot, 10 s checkpoints — the
paper assigns them full per-worker resources since they only tune scale-out.
Flink reactive rescales from the last checkpoint (no savepoint), so its
restart penalty is smaller than a savepoint-based redeploy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .simulator import MAX_PARALLELISM, JobConfig


def baseline_config(workers: int) -> JobConfig:
    return JobConfig(workers=int(np.clip(workers, 1, MAX_PARALLELISM)),
                     cpu_cores=1, memory_mb=4096, task_slots=1,
                     checkpoint_interval_s=10.0)


def _busy(window: List[Dict[str, float]]) -> float:
    """Mean busy fraction over a metric window (capped at 1)."""
    return float(np.mean([min(m["utilization"], 1.0) for m in window]))


class StaticController:
    """C_max, forever."""

    restart_s = 0.0

    def __init__(self, cmax: JobConfig):
        self.cmax = cmax

    def decide(self, t: float, window: List[Dict[str, float]],
               current: JobConfig) -> Optional[JobConfig]:
        return None


@dataclass
class ReactiveController:
    """Flink reactive mode + Kubernetes HPA (35 % CPU target)."""

    target_utilization: float = 0.35
    sync_period_s: float = 15.0
    downscale_stabilization_s: float = 300.0
    tolerance: float = 0.10
    restart_s: float = 20.0            # reactive rescale: no savepoint
    _last_sync: float = -1e9
    _down_candidate_since: Optional[float] = None

    def decide(self, t: float, window: List[Dict[str, float]],
               current: JobConfig) -> Optional[JobConfig]:
        if t - self._last_sync < self.sync_period_s or not window:
            return None
        self._last_sync = t
        ratio = _busy(window) / self.target_utilization
        if abs(ratio - 1.0) <= self.tolerance:
            self._down_candidate_since = None
            return None
        desired = int(np.clip(np.ceil(current.workers * ratio), 1,
                              MAX_PARALLELISM))
        if desired == current.workers:
            self._down_candidate_since = None
            return None
        if desired > current.workers:                       # scale up: now
            self._down_candidate_since = None
            return baseline_config(desired)
        # Scale down only after the stabilization window keeps agreeing.
        if self._down_candidate_since is None:
            self._down_candidate_since = t
            return None
        if t - self._down_candidate_since >= self.downscale_stabilization_s:
            self._down_candidate_since = None
            return baseline_config(desired)
        return None


@dataclass
class DS2Controller:
    """DS2 via the Flink autoscaler: utilization target 35 %, boundary 15 %."""

    target_utilization: float = 0.35
    boundary: float = 0.15
    stabilization_s: float = 120.0
    restart_pause_s: float = 60.0
    catchup_pause_s: float = 300.0
    restart_s: float = 60.0            # savepoint-based redeploy
    _last_decision: float = -1e9
    _paused_until: float = -1e9

    def decide(self, t: float, window: List[Dict[str, float]],
               current: JobConfig) -> Optional[JobConfig]:
        if not window or t < self._paused_until \
                or t - self._last_decision < self.stabilization_s:
            return None
        self._last_decision = t
        busy = _busy(window)
        lo = self.target_utilization - self.boundary
        hi = self.target_utilization + self.boundary
        if lo <= busy <= hi:
            return None
        # Proportional rule on the measured busy fraction (true-rate scaling:
        # desired = current * busy / target reproduces rate / true_rate).
        desired = int(np.clip(np.ceil(current.workers * busy
                                      / self.target_utilization),
                              1, MAX_PARALLELISM))
        if desired == current.workers:
            return None
        self._paused_until = t + self.restart_pause_s + self.catchup_pause_s
        return baseline_config(desired)

def make_baseline(kind: str, cmax: Optional[JobConfig] = None):
    """(controller, start_config) for a named baseline method.

    Single source of the kind -> controller + start-config wiring so the
    paper-protocol runner and the sweep engine cannot desynchronize."""
    cmax = cmax if cmax is not None else JobConfig()
    if kind == "static":
        return StaticController(cmax), cmax
    if kind == "reactive":
        return ReactiveController(), baseline_config(12)  # HPA starts mid-range
    if kind == "ds2":
        return DS2Controller(), baseline_config(12)
    raise ValueError(f"unknown method {kind!r}")
