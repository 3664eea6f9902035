"""The port's control-plane API: the scenario-row view, the engine
configuration and device resolution.

* :data:`ProfileSpec` — one batched profiling request, as the sweep
  executors' ``profile`` takes them;
* :class:`ScenarioView` — one scenario row of a sweep executor served as a
  scalar executor (what a per-scenario
  :class:`~repro_torch.core.demeter.DemeterController` binds to);
* :class:`EngineConfig` — the one frozen configuration object of the stack,
  validated against :mod:`~repro_torch.core.registry` at construction.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import (TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .registry import (DETECTOR_BACKENDS, FIT_BACKENDS, FORECAST_BACKENDS,
                       SIM_ENGINES)

if TYPE_CHECKING:                                    # avoid an import cycle:
    from .demeter import DemeterHyperParams          # demeter imports us

#: One batched profiling request: (scenario row, configuration, rate).
ProfileSpec = Tuple[int, Mapping[str, float], float]


@dataclass
class ScenarioView:
    """One scenario row of a sweep executor, as a scalar executor.

    Per-scenario controllers (the
    :class:`~repro_torch.core.demeter.DemeterController` inside the sweep
    engine) bind to one row of the batched target system through this view.
    ``batch`` is any object with the sweep executors' row-indexed surface
    (``n_scenarios``, ``cmax_config``, ``current_config``, ``reconfigure``,
    ``observe_one``, ``profile``, ``allocated_cost``).
    """

    batch: object
    idx: int

    def cmax_config(self) -> Dict[str, float]:
        return self.batch.cmax_config(self.idx)

    def current_config(self) -> Dict[str, float]:
        return self.batch.current_config(self.idx)

    def reconfigure(self, config: Mapping[str, float]) -> None:
        n = self.batch.n_scenarios()
        mask = np.zeros(n, bool)
        mask[self.idx] = True
        configs: List[Optional[Mapping[str, float]]] = [None] * n
        configs[self.idx] = config
        self.batch.reconfigure(mask, configs)

    def observe(self) -> Dict[str, float]:
        return self.batch.observe_one(self.idx)

    def profile(self, configs: Sequence[Mapping[str, float]], rate: float
                ) -> List[Optional[Dict[str, float]]]:
        return self.batch.profile([(self.idx, c, rate) for c in configs])

    def allocated_cost(self, config: Mapping[str, float]) -> float:
        return self.batch.allocated_cost(self.idx, config)


def _ensure_registered() -> None:
    """Import the modules that register the built-in engines, controllers
    and backends, so validation works whichever module was imported first."""
    from . import anomaly, demeter, forecast, forecast_bank  # noqa: F401
    from ..dsp import executor, fused, policies  # noqa: F401


def resolve_device(name: str) -> torch.device:
    """``name`` as a :class:`torch.device`, refusing a CUDA device that is
    not there: the port never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (to a sweep: EngineConfig(device="
            f"'cpu')) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {name!r}")
    return device


@dataclass(frozen=True)
class EngineConfig:
    """One configuration object for the sweep stack, validated at
    construction."""

    #: Sweep simulation engine: "fused" (whole decision intervals on the
    #: device, one fused-tick kernel launch per tick) or "batched" (the
    #: vectorized NumPy host engine).
    sim_backend: str = "fused"
    #: Demeter GP fitting path: "bank" (batched float32 L-BFGS on
    #: ``device``) or "scalar" (per-GP scipy reference oracle on the host).
    fit_backend: str = "bank"
    #: Demeter TSF path: "bank" (one shared float64 ForecastBank on
    #: ``device``) or "scalar" (per-stream float64 NumPy zoo).
    forecast_backend: str = "bank"
    #: §2.3 anomaly-detector path inside profiling runs ("scalar").
    detector_backend: str = "scalar"
    #: Demeter hyper-parameters; None means paper §3.2 defaults.
    hp: Optional["DemeterHyperParams"] = None
    #: Baseline-controller decision cadence (seconds).
    decision_interval_s: float = 60.0
    #: Where the fused engine, the forecast bank, the GP bank and the
    #: acquisition keep their tensors and launch their kernels. The batched
    #: engine and the scalar oracles run on the host whatever this says.
    device: str = "cuda"

    def __post_init__(self) -> None:
        _ensure_registered()
        SIM_ENGINES.validate(self.sim_backend)
        FIT_BACKENDS.validate(self.fit_backend)
        FORECAST_BACKENDS.validate(self.forecast_backend)
        DETECTOR_BACKENDS.validate(self.detector_backend)
        if not self.decision_interval_s > 0:
            raise ValueError(f"decision_interval_s must be positive, got "
                             f"{self.decision_interval_s!r}")

    def resolved_hp(self) -> "DemeterHyperParams":
        """``hp``, or the paper §3.2 defaults when unset."""
        if self.hp is not None:
            return self.hp
        from .demeter import DemeterHyperParams
        return DemeterHyperParams()

    def replace(self, **overrides) -> "EngineConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return replace(self, **overrides)
