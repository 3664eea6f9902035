"""The paper's evaluation constants (§3) and the per-failure record.

18-hour traces, timeout failures every 45 minutes, 1-minute metric
windows, 10-minute optimization intervals, and the 6-minute recovery cap
that Table 3 prints as "6m+".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

FAILURE_INTERVAL_S = 45 * 60.0
RECOVERY_CAP_S = 360.0           # "6m+" in Table 3
METRIC_WINDOW_S = 60.0
OPT_INTERVAL_S = 600.0


@dataclass
class FailureRecord:
    t_inject: float
    workload: float
    recovery_s: Optional[float]   # None => NR (reconfig overlapped)
    capped: bool = False          # True => exceeded the 6-minute cap
