"""Experiment harness of the paper's evaluation protocol (§3).

18-hour workload traces, timeout failures every 45 minutes, 1-minute metric
windows, 10-minute optimization intervals for Demeter, and the 6-minute
recovery cap that Table 3 prints as "6m+". :func:`run_experiment` runs one
(trace, method) cell and collects what Figures 5/6 and Table 3 report:
latency distributions, per-failure recovery times (NR where a
reconfiguration overlapped), cumulative CPU/memory usage (profiling cost
separately) and scale-out decisions over time.

This is the scalar, one-cell-at-a-time protocol: the target job is a host
:class:`~repro_torch.dsp.simulator.SimJob` behind a
:class:`~repro_torch.dsp.executor.DSPExecutor`. Demeter's forecast bank
(with the ARIMA kernel) and GP bank run on ``config.device``. For
multi-scenario grids run as one vectorized sweep, use
:mod:`repro_torch.dsp.sweep`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.config_space import paper_flink_space
from ..core.demeter import DemeterController, DemeterHyperParams
from ..core.executor import EngineConfig, resolve_device
from .baselines import make_baseline
from .executor import DSPExecutor
from .simulator import ClusterModel, JobConfig
from .workloads import FailureSchedule, PeriodicFailures, Trace

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


@dataclass
class RunResult:
    method: str
    trace: str
    times: np.ndarray
    rates: np.ndarray
    latencies: np.ndarray
    usage_cpu: np.ndarray         # cores in use (target job)
    usage_mem_mb: np.ndarray
    workers: np.ndarray
    failures: List[FailureRecord]
    n_reconfigurations: int
    profile_cpu_s: float = 0.0
    profile_mem_mb_s: float = 0.0

    # -- summary helpers of the paper's tables ------------------------------
    def cumulative_cpu_s(self, include_profiling: bool = True) -> float:
        dt = float(self.times[1] - self.times[0]) if len(self.times) > 1 else 1.0
        total = float(np.sum(self.usage_cpu) * dt)
        return total + (self.profile_cpu_s if include_profiling else 0.0)

    def cumulative_mem_mb_s(self, include_profiling: bool = True) -> float:
        dt = float(self.times[1] - self.times[0]) if len(self.times) > 1 else 1.0
        total = float(np.sum(self.usage_mem_mb) * dt)
        return total + (self.profile_mem_mb_s if include_profiling else 0.0)

    def recovery_times(self) -> List[Optional[float]]:
        return [f.recovery_s for f in self.failures]

    def latency_ecdf(self) -> tuple:
        lat = np.sort(self.latencies[np.isfinite(self.latencies)])
        return lat, np.arange(1, len(lat) + 1) / len(lat)

    def frac_latency_below(self, threshold_s: float) -> float:
        lat = self.latencies[np.isfinite(self.latencies)]
        return float(np.mean(lat < threshold_s)) if len(lat) else 0.0


def run_experiment(trace: Trace, method: str, *,
                   model: Optional[ClusterModel] = None,
                   hp: Optional[DemeterHyperParams] = None,
                   seed: int = 0,
                   duration_s: Optional[float] = None,
                   failures_schedule: Optional[FailureSchedule] = None,
                   config: Optional[EngineConfig] = None
                   ) -> RunResult:
    """Run one (trace, method) cell of the paper's evaluation.

    ``failures_schedule`` overrides the paper's 45-minute periodic injection
    (see :mod:`repro_torch.dsp.workloads`); ``config`` selects Demeter's
    model and forecast backends and the device they run on
    (hyper-parameters fall back to ``config.hp`` when ``hp`` is not given).
    ``None`` is ``EngineConfig()``, whose device is the card: it raises
    where there is none, so pass ``EngineConfig(device="cpu")``."""
    config = config if config is not None else EngineConfig()
    resolve_device(config.device)
    model = model or ClusterModel()
    cmax = JobConfig()                     # paper §3.2 C_max
    execu = DSPExecutor(model, cmax, seed=seed, dt=trace.dt_s)
    duration = duration_s or trace.duration_s

    demeter: Optional[DemeterController] = None
    baseline = None
    if method == "demeter":
        demeter = DemeterController(paper_flink_space(), execu,
                                    hp=hp, config=config)
    else:
        baseline, start = make_baseline(method, cmax)
        if start != cmax:
            execu.reconfigure(start.to_dict())

    dt = trace.dt_s
    n_steps = int(duration / dt)
    schedule = failures_schedule if failures_schedule is not None \
        else PeriodicFailures(FAILURE_INTERVAL_S)
    failure_times = list(schedule.times(duration))

    times = np.zeros(n_steps)
    rates = np.zeros(n_steps)
    lats = np.zeros(n_steps)
    ucpu = np.zeros(n_steps)
    umem = np.zeros(n_steps)
    workers = np.zeros(n_steps)
    failures: List[FailureRecord] = []
    n_reconf_baseline = 0

    pending: Optional[FailureRecord] = None
    pending_reconf_count = 0
    next_failure = 0
    last_ingest = 0.0
    last_opt = 0.0
    prof_interval = (demeter.hp.profile_interval_s if demeter
                     else OPT_INTERVAL_S)
    last_prof = OPT_INTERVAL_S / 2.0   # async offset between the 2 processes

    for i in range(n_steps):
        t = i * dt
        rate = trace.rate_at(t)
        m = execu.step(rate)

        times[i], rates[i], lats[i] = t, rate, m["latency"]
        ucpu[i], umem[i] = m["usage_cpu"], m["usage_mem_mb"]
        workers[i] = execu.job.config.workers

        # -- failure injection + ground-truth recovery measurement ----------
        if next_failure < len(failure_times) \
                and t >= failure_times[next_failure]:
            execu.job.inject_failure()
            if pending is not None:
                # previous failure never resolved before this one landed:
                # close it as NR rather than dropping it
                failures.append(pending)
            pending = FailureRecord(t_inject=t, workload=rate, recovery_s=None)
            pending_reconf_count = (demeter.n_reconfigurations
                                    if demeter else n_reconf_baseline)
            next_failure += 1
        elif pending is not None:
            elapsed = t - pending.t_inject
            reconf_now = (demeter.n_reconfigurations
                          if demeter else n_reconf_baseline)
            if reconf_now != pending_reconf_count:
                pending.recovery_s = None          # NR: reconfig overlapped
                failures.append(pending)
                pending = None
            elif execu.job.caught_up:
                pending.recovery_s = elapsed
                failures.append(pending)
                pending = None
            elif elapsed > RECOVERY_CAP_S * 2:
                pending.recovery_s = float("inf")  # "6m+"
                pending.capped = True
                failures.append(pending)
                pending = None

        # -- controllers -----------------------------------------------------
        if demeter is not None:
            if t - last_ingest >= METRIC_WINDOW_S:
                last_ingest = t
                obs = execu.observe()
                if obs:
                    demeter.ingest(obs)
            if t - last_prof >= prof_interval:
                last_prof = t
                demeter.profiling_step()
            if t - last_opt >= OPT_INTERVAL_S:
                last_opt = t
                demeter.optimization_step()
        elif baseline is not None:
            new = baseline.decide(t, execu.window(METRIC_WINDOW_S),
                                  execu.job.config)
            if new is not None and new != execu.job.config:
                execu.job.reconfigure(new,
                                      restart_s=getattr(baseline, "restart_s",
                                                        None))
                n_reconf_baseline += 1

    if pending is not None:
        failures.append(pending)

    return RunResult(
        method=method, trace=trace.name, times=times, rates=rates,
        latencies=lats, usage_cpu=ucpu, usage_mem_mb=umem, workers=workers,
        failures=failures,
        n_reconfigurations=(demeter.n_reconfigurations if demeter
                            else n_reconf_baseline),
        profile_cpu_s=execu.profile_cost.cpu_s,
        profile_mem_mb_s=execu.profile_cost.mem_mb_s,
    )
