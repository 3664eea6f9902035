"""Workload segmentation and per-segment observation stores (paper §2.2, Fig 2).

Observations (configuration, workload rate, measured objectives) are bucketed
into contiguous workload segments of width ``segment_size`` (the SS
hyper-parameter). Segments are created dynamically when first hit. Each
segment owns the training data for its MOBO models; RGPE stitches the
segments together at query time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

#: Canonical metric names used across the framework.
USAGE = "usage"            # resource usage to minimize (objective)
LATENCY = "latency"        # average end-to-end latency (constraint, objective #2)
RECOVERY = "recovery"      # recovery time (constraint)

METRICS = (USAGE, LATENCY, RECOVERY)


@dataclass
class Observation:
    config: Dict[str, float]
    x: np.ndarray                     # normalized encoding
    rate: float
    metrics: Dict[str, float]         # USAGE / LATENCY / RECOVERY (+ extras)
    reverted: bool = False            # did this config force a C_max revert?
    downscaled: bool = False          # was this config an efficiency downscale?


@dataclass
class Segment:
    index: int
    lo: float
    hi: float
    observations: List[Observation] = field(default_factory=list)
    #: Profiling-annealing state: exploration shrinks with knowledge (§2.3).
    profile_rounds: int = 0
    #: Monotonic data version, bumped on every add — model caches
    #: (:class:`~repro.core.demeter.ModelBank`) use it as a cheap staleness
    #: check without re-materializing (X, y) arrays.
    version: int = 0

    def add(self, obs: Observation) -> None:
        self.observations.append(obs)
        self.version += 1

    def data(self, metric: str):
        """(X, y) arrays for one metric over this segment's observations."""
        rows = [o for o in self.observations if metric in o.metrics
                and np.isfinite(o.metrics[metric])]
        if not rows:
            return np.zeros((0, 0)), np.zeros((0,))
        x = np.stack([o.x for o in rows])
        y = np.asarray([o.metrics[metric] for o in rows])
        return x, y

    def __len__(self) -> int:
        return len(self.observations)


@dataclass
class SegmentStore:
    """All segments, keyed by ``floor(rate / segment_size)``."""

    segment_size: float
    segments: Dict[int, Segment] = field(default_factory=dict)

    def segment_for(self, rate: float) -> Segment:
        idx = int(np.floor(max(rate, 0.0) / self.segment_size))
        if idx not in self.segments:
            self.segments[idx] = Segment(index=idx,
                                         lo=idx * self.segment_size,
                                         hi=(idx + 1) * self.segment_size)
        return self.segments[idx]

    def peek(self, rate: float) -> Optional[Segment]:
        idx = int(np.floor(max(rate, 0.0) / self.segment_size))
        return self.segments.get(idx)

    def record(self, config: Mapping[str, float], x: np.ndarray, rate: float,
               metrics: Mapping[str, float], **flags) -> Observation:
        obs = Observation(config=dict(config), x=np.asarray(x, np.float64),
                          rate=float(rate), metrics=dict(metrics), **flags)
        self.segment_for(rate).add(obs)
        return obs

    def others(self, segment: Segment) -> List[Segment]:
        return [s for i, s in sorted(self.segments.items()) if i != segment.index]

    def all_observations(self) -> List[Observation]:
        out: List[Observation] = []
        for _, s in sorted(self.segments.items()):
            out.extend(s.observations)
        return out
