"""The DSP substrate of the port: simulator, workloads, baselines, the
profiling lifecycle and the sweep engine with its registered executors and
controller policies (the baselines and Demeter)."""
from .baselines import (DS2Controller, ReactiveController, StaticController,
                        baseline_config, make_baseline)
from .executor import (BatchedSweepExecutor, ProfileCost, SweepExecutorBase,
                       profile_one)
from .fused import FusedSweepExecutor, fused_interval_scan
from .policies import BaselinePolicy, DemeterPolicy
from .runner import (FAILURE_INTERVAL_S, METRIC_WINDOW_S, OPT_INTERVAL_S,
                     RECOVERY_CAP_S, FailureRecord)
from .simulator import (MAX_PARALLELISM, BatchedNormals, BatchState,
                        BufferedNormals, ClusterModel, JobConfig, SimJob,
                        step_batch_arrays)
from .sweep import (ScenarioResult, ScenarioSpec, SweepEngine, SweepResult,
                    paper_grid, run_sweep, scenario_grid)
from .workloads import (TRACE_GENERATORS, FailureSchedule, FailuresAt,
                        NoFailures, PeriodicFailures, Trace, constant,
                        diurnal, flash_crowd, make_trace, regime_switching,
                        sinusoid_drift, tsw_like, ysb_like)

__all__ = [
    "ClusterModel", "JobConfig", "BatchState", "BatchedNormals",
    "BufferedNormals", "MAX_PARALLELISM", "step_batch_arrays", "SimJob",
    "Trace", "constant", "ysb_like", "tsw_like", "diurnal", "flash_crowd",
    "regime_switching", "sinusoid_drift", "make_trace", "TRACE_GENERATORS",
    "FailureSchedule", "NoFailures", "PeriodicFailures", "FailuresAt",
    "ProfileCost", "StaticController", "ReactiveController", "DS2Controller",
    "baseline_config", "make_baseline", "FailureRecord",
    "FAILURE_INTERVAL_S", "RECOVERY_CAP_S", "METRIC_WINDOW_S",
    "OPT_INTERVAL_S",
    "ScenarioSpec", "ScenarioResult", "SweepEngine", "SweepResult",
    "scenario_grid", "paper_grid", "run_sweep",
    "BatchedSweepExecutor", "FusedSweepExecutor", "SweepExecutorBase",
    "fused_interval_scan", "BaselinePolicy", "DemeterPolicy", "profile_one",
]
