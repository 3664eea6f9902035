"""Control-plane and modelling pieces of the port: registries, the engine
config, the forecast bank, the GP bank, RGPE, acquisition and the Demeter
controller."""
from .acquisition import (ehvi_2d, ehvi_2d_batch, hypervolume_2d,
                          pareto_front_2d, pareto_front_mask_2d,
                          select_profiling_batch)
from .anomaly import MetricDetector, RecoveryTracker, ScalarDetectorSet
from .config_space import ConfigSpace, Parameter, paper_flink_space
from .demeter import DemeterController, DemeterHyperParams, ModelBank
from .executor import EngineConfig, ProfileSpec, ScenarioView, resolve_device
from .forecast import (FORECASTER_DEFAULTS, FORECASTER_KINDS, HoltWinters,
                       OnlineARIMA, SeasonalNaive, binned_forecast,
                       make_scalar_forecaster)
from .forecast_bank import BankedForecaster, ForecastBank, make_forecaster
from .gp import GP, restart_inits
from .gp_bank import GPBank, batched_posterior, bucket_pow2
from .latency import LatencyConstraint
from .registry import (CONTROLLERS, DETECTOR_BACKENDS, FIT_BACKENDS,
                       FORECAST_BACKENDS, FORECASTERS, SIM_ENGINES, Registry)
from .rgpe import RGPEnsemble, build_rgpe
from .segments import (LATENCY, METRICS, RECOVERY, USAGE, Observation,
                       Segment, SegmentStore)

__all__ = [
    "EngineConfig", "ProfileSpec", "ScenarioView", "resolve_device",
    "Registry", "CONTROLLERS", "SIM_ENGINES", "FORECASTERS", "FIT_BACKENDS",
    "FORECAST_BACKENDS", "DETECTOR_BACKENDS",
    "ConfigSpace", "Parameter", "paper_flink_space",
    "Segment", "SegmentStore", "Observation", "USAGE", "LATENCY",
    "RECOVERY", "METRICS", "LatencyConstraint",
    "OnlineARIMA", "HoltWinters", "SeasonalNaive", "FORECASTER_KINDS",
    "FORECASTER_DEFAULTS", "binned_forecast", "make_scalar_forecaster",
    "ForecastBank", "BankedForecaster", "make_forecaster",
    "MetricDetector", "ScalarDetectorSet", "RecoveryTracker",
    "GP", "restart_inits", "GPBank", "batched_posterior", "bucket_pow2",
    "RGPEnsemble", "build_rgpe",
    "pareto_front_2d", "hypervolume_2d", "ehvi_2d", "ehvi_2d_batch",
    "pareto_front_mask_2d", "select_profiling_batch",
    "DemeterController", "DemeterHyperParams", "ModelBank",
]
