"""Control-plane and modelling pieces of the port: registries, executor
protocols and the engine config, the forecast and detector banks, the GP
bank, RGPE, acquisition and the Demeter controller."""
from .acquisition import (ehvi_2d, ehvi_2d_batch, expected_improvement,
                          hypervolume_2d, pareto_front_2d,
                          pareto_front_mask_2d, prob_feasible,
                          select_profiling_batch)
from .anomaly import (BankedDetectorSet, MetricDetector, RecoveryTracker,
                      ScalarDetectorSet)
from .config_space import (ConfigSpace, Parameter, paper_flink_space,
                           tpu_serving_space, tpu_training_space)
from .demeter import DemeterController, DemeterHyperParams, ModelBank
from .executor import (BatchExecutor, EngineConfig, Executor, ProfileSpec,
                       ScalarAdapter, ScenarioView, coerce_config,
                       resolve_device)
from .forecast import (FORECASTER_DEFAULTS, FORECASTER_KINDS, HoltWinters,
                       OnlineARIMA, SeasonalNaive, binned_forecast,
                       make_scalar_forecaster)
from .forecast_bank import (BankedForecaster, DetectorBank, ForecastBank,
                            make_forecaster)
from .gp import GP, restart_inits
from .gp_bank import GPBank, batched_posterior, bucket_pow2
from .latency import LatencyConstraint
from .registry import (CONTROLLERS, DETECTOR_BACKENDS, FIT_BACKENDS,
                       FLEET_BACKENDS, FORECAST_BACKENDS, FORECASTERS,
                       SIM_ENGINES, Registry)
from .rgpe import RGPEnsemble, build_rgpe
from .segments import (LATENCY, METRICS, RECOVERY, USAGE, Observation,
                       Segment, SegmentStore)

__all__ = [
    "ConfigSpace", "Parameter", "paper_flink_space", "tpu_serving_space",
    "tpu_training_space", "GP", "GPBank", "batched_posterior", "OnlineARIMA",
    "binned_forecast", "RGPEnsemble", "build_rgpe", "ehvi_2d",
    "ehvi_2d_batch", "expected_improvement", "hypervolume_2d",
    "pareto_front_2d", "pareto_front_mask_2d", "prob_feasible",
    "select_profiling_batch", "LatencyConstraint", "MetricDetector",
    "RecoveryTracker", "DemeterController", "DemeterHyperParams", "Executor",
    "ModelBank", "SegmentStore", "Segment", "Observation", "USAGE", "LATENCY",
    "RECOVERY", "METRICS", "FORECASTER_KINDS", "HoltWinters", "SeasonalNaive",
    "make_scalar_forecaster", "BankedForecaster", "DetectorBank",
    "ForecastBank", "make_forecaster",
    # batched control plane
    "BatchExecutor", "EngineConfig", "ProfileSpec", "ScalarAdapter",
    "ScenarioView", "coerce_config", "Registry", "CONTROLLERS",
    "FORECASTERS", "FIT_BACKENDS", "FORECAST_BACKENDS", "DETECTOR_BACKENDS",
    "SIM_ENGINES", "FLEET_BACKENDS",
    # the port's own
    "resolve_device", "FORECASTER_DEFAULTS", "ScalarDetectorSet",
    "BankedDetectorSet", "restart_inits", "bucket_pow2",
]
