"""Runtime latency-constraint derivation (paper §2.4).

'Normal' latency varies per job/environment, so LC is derived online: observed
latencies are normalized against their 1st percentile (the best the job has
ever done, robust to outliers) and squashed into [0, 1] by a monotone
transform; values below 0.5 are *normal*, at/above 0.5 *abnormal*. With the
transform ``t(x) = 1 - p1/x`` the 0.5 boundary sits at exactly twice the 1st
percentile — a configuration keeping up with the workload stabilizes near the
smallest achievable latency (the near-optimal cluster), while a backlogged one
drifts far beyond it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class LatencyConstraint:
    """Streaming LC estimator over observed average end-to-end latencies."""

    window: int = 4096
    _values: List[float] = field(default_factory=list)

    def observe(self, latency: float) -> None:
        if np.isfinite(latency) and latency > 0:
            self._values.append(float(latency))
            if len(self._values) > self.window:
                self._values = self._values[-self.window:]

    # -- the paper's two-cluster construction --------------------------------
    def p1(self) -> Optional[float]:
        if len(self._values) < 8:
            return None
        return float(np.percentile(np.asarray(self._values), 1.0))

    def transform(self, latency: float) -> float:
        """Map a latency into [0, 1): <0.5 normal, >=0.5 abnormal."""
        base = self.p1()
        if base is None or base <= 0:
            return 0.0
        return float(np.clip(1.0 - base / max(latency, 1e-12), 0.0, 1.0))

    def constraint(self) -> Optional[float]:
        """LC in latency units (the 0.5 boundary), or None pre-warmup."""
        base = self.p1()
        return None if base is None else 2.0 * base

    def is_normal(self, latency: float) -> bool:
        lc = self.constraint()
        return True if lc is None else latency < lc

    def __len__(self) -> int:
        return len(self._values)
