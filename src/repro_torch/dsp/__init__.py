"""The DSP substrate of the port: simulator, workloads, baselines, the
paper-protocol harness, the profiling lifecycle and the sweep engine with
its registered executors and controller policies (the baselines and
Demeter)."""
from .baselines import (DS2Controller, ReactiveController, StaticController,
                        baseline_config, make_baseline)
from .executor import (BatchedSweepExecutor, DSPExecutor, ProfileCost,
                       ScalarSweepExecutor, SweepExecutorBase, profile_one)
from .fused import FusedSweepExecutor, fused_interval_scan
from .policies import BaselinePolicy, DemeterPolicy, SweepPolicy
from .runner import (FAILURE_INTERVAL_S, METRIC_WINDOW_S, OPT_INTERVAL_S,
                     RECOVERY_CAP_S, FailureRecord, RunResult, run_experiment)
from .simulator import (MAX_PARALLELISM, BatchedNormals, BatchState,
                        BufferedNormals, ClusterModel, JobConfig, SimJob,
                        measure_recovery, step_batch_arrays)
from .sweep import (CONTROLLER_NAMES, ScenarioResult, ScenarioSpec,
                    SweepEngine, SweepResult, paper_grid, run_sweep,
                    scenario_grid)
from .workloads import (TRACE_GENERATORS, FailureSchedule, FailuresAt,
                        NoFailures, PeriodicFailures, Trace, constant,
                        diurnal, flash_crowd, make_trace, regime_switching,
                        sinusoid_drift, tsw_like, ysb_like)

__all__ = [
    "ClusterModel", "JobConfig", "SimJob", "BatchState", "MAX_PARALLELISM",
    "measure_recovery", "Trace", "constant", "ysb_like", "tsw_like",
    "diurnal", "flash_crowd", "regime_switching", "sinusoid_drift",
    "make_trace", "TRACE_GENERATORS", "FailureSchedule", "NoFailures",
    "PeriodicFailures", "FailuresAt",
    "DSPExecutor", "ProfileCost", "StaticController", "ReactiveController",
    "DS2Controller", "baseline_config", "run_experiment", "RunResult",
    "FailureRecord",
    "ScenarioSpec", "ScenarioResult", "SweepEngine", "SweepResult",
    "scenario_grid", "paper_grid", "run_sweep",
    # batched control plane
    "BatchedSweepExecutor", "FusedSweepExecutor", "ScalarSweepExecutor",
    "SweepExecutorBase",
    "BaselinePolicy", "DemeterPolicy", "SweepPolicy", "CONTROLLER_NAMES",
    # the port's own
    "BatchedNormals", "BufferedNormals", "step_batch_arrays",
    "make_baseline", "profile_one", "fused_interval_scan",
    "FAILURE_INTERVAL_S", "RECOVERY_CAP_S", "METRIC_WINDOW_S",
    "OPT_INTERVAL_S",
]
