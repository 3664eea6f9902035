"""The port's control-plane API: executor protocols, adapters, the engine
configuration and device resolution.

* :class:`Executor` — the scalar per-job protocol the controller binds to
  (one target job, dict-per-step telemetry);
* :class:`BatchExecutor` — the same surface vectorized over a scenario
  axis ``S`` (what the sweep executors implement);
* :class:`ScalarAdapter` — lifts scalar :class:`Executor`\\ s (e.g.
  :class:`repro_torch.dsp.DSPExecutor`) onto the batched protocol;
* :data:`ProfileSpec` — one batched profiling request, as the sweep
  executors' ``profile`` takes them;
* :class:`ScenarioView` — one scenario row of a batch executor served as a
  scalar executor (what a per-scenario
  :class:`~repro_torch.core.demeter.DemeterController` binds to);
* :class:`EngineConfig` — the one frozen configuration object of the stack,
  validated against :mod:`~repro_torch.core.registry` at construction;
  :func:`coerce_config` folds the legacy string kwargs into it, with a
  DeprecationWarning each.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import (TYPE_CHECKING, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from .registry import (DETECTOR_BACKENDS, FIT_BACKENDS, FORECAST_BACKENDS,
                       SIM_ENGINES)

if TYPE_CHECKING:                                    # avoid an import cycle:
    from .demeter import DemeterHyperParams          # demeter imports us

# ---------------------------------------------------------------------------
# protocols
# ---------------------------------------------------------------------------

@runtime_checkable
class Executor(Protocol):
    """What Demeter needs from one target system it controls (scalar)."""

    def cmax_config(self) -> Dict[str, float]: ...

    def current_config(self) -> Dict[str, float]: ...

    def reconfigure(self, config: Mapping[str, float]) -> None: ...

    def observe(self) -> Dict[str, float]:
        """Latest target-job metrics: {'rate', 'latency', 'usage', ...}."""
        ...

    def profile(self, configs: List[Dict[str, float]], rate: float
                ) -> List[Optional[Dict[str, float]]]:
        """Run parallel short-lived profiling jobs at ``rate``; each result
        carries USAGE / LATENCY / RECOVERY (None for a failed run)."""
        ...

    def allocated_cost(self, config: Mapping[str, float]) -> float:
        """Deterministic allocated-resource scalar (for ordering/bias)."""
        ...


#: One batched profiling request: (scenario row, configuration, rate).
ProfileSpec = Tuple[int, Mapping[str, float], float]


@runtime_checkable
class BatchExecutor(Protocol):
    """A target system vectorized over a scenario axis ``S``.

    The sweep executors (:class:`repro_torch.dsp.BatchedSweepExecutor`,
    ``FusedSweepExecutor``, ``ScalarSweepExecutor``) implement it directly,
    and :class:`ScalarAdapter` lifts any sequence of scalar
    :class:`Executor`\\ s onto it. Row-indexed methods take the scenario
    index ``idx``; batched methods take and return arrays of length ``S``.
    """

    def n_scenarios(self) -> int:
        """Batch size S (the scenario axis length)."""
        ...

    def cmax_config(self, idx: int) -> Dict[str, float]:
        """Scenario ``idx``'s maximal configuration C_max (safe revert)."""
        ...

    def current_config(self, idx: int) -> Dict[str, float]: ...

    def reconfigure(self, mask: np.ndarray,
                    configs: Sequence[Optional[Mapping[str, float]]]
                    ) -> np.ndarray:
        """Apply ``configs[j]`` to every scenario ``j`` with ``mask[j]``
        True; entries where the mask is False are ignored (may be None).
        Returns the boolean mask of rows whose configuration changed."""
        ...

    def observe(self) -> Dict[str, np.ndarray]:
        """Latest telemetry digest for *all* scenarios:
        ``{'rate': ndarray[S], 'latency': ndarray[S], ...}``."""
        ...

    def observe_one(self, idx: int) -> Dict[str, float]:
        """Scenario ``idx``'s telemetry digest (may be ``{}`` when the
        scenario has produced no telemetry yet)."""
        ...

    def profile(self, specs: Sequence[ProfileSpec]
                ) -> List[Optional[Dict[str, float]]]:
        """Run a flat batch of profiling requests; result ``k`` corresponds
        to ``specs[k]`` (None for a failed run)."""
        ...

    def allocated_cost(self, idx: int, config: Mapping[str, float]) -> float:
        ...


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------

class ScalarAdapter:
    """Lift scalar :class:`Executor`\\ s onto the :class:`BatchExecutor` axis.

    ``ScalarAdapter(executor)`` wraps a single executor as a batch of one;
    ``ScalarAdapter([e0, e1, ...])`` stacks several. Batched calls delegate
    row by row.
    """

    def __init__(self, executors: Union[Executor, Sequence[Executor]]):
        if hasattr(executors, "observe"):            # a single scalar executor
            executors = [executors]                  # type: ignore[list-item]
        self.executors: List[Executor] = list(executors)  # type: ignore[arg-type]
        if not self.executors:
            raise ValueError("ScalarAdapter needs at least one executor")

    def n_scenarios(self) -> int:
        return len(self.executors)

    def cmax_config(self, idx: int) -> Dict[str, float]:
        return self.executors[idx].cmax_config()

    def current_config(self, idx: int) -> Dict[str, float]:
        return self.executors[idx].current_config()

    def reconfigure(self, mask: np.ndarray,
                    configs: Sequence[Optional[Mapping[str, float]]]
                    ) -> np.ndarray:
        mask = np.asarray(mask, bool)
        applied = np.zeros(len(self.executors), bool)
        for j in np.flatnonzero(mask):
            cfg = configs[j]
            if cfg is None:
                continue
            before = self.executors[j].current_config()
            self.executors[j].reconfigure(cfg)
            applied[j] = self.executors[j].current_config() != before
        return applied

    def observe_one(self, idx: int) -> Dict[str, float]:
        return self.executors[idx].observe()

    def observe(self) -> Dict[str, np.ndarray]:
        digests = [e.observe() for e in self.executors]
        keys: Dict[str, None] = {}                   # ordered key union
        for d in digests:
            keys.update(dict.fromkeys(d))
        return {k: np.array([d.get(k, np.nan) for d in digests])
                for k in keys}

    def profile(self, specs: Sequence[ProfileSpec]
                ) -> List[Optional[Dict[str, float]]]:
        # All requests sharing (idx, rate), wherever they sit in the batch,
        # go to ONE scalar profile() call, so wrapped executors derive the
        # same distinct per-call clone seeds as under the scalar protocol;
        # results scatter back to their request positions.
        groups: Dict[Tuple[int, float], List[int]] = {}
        for pos, (idx, _, rate) in enumerate(specs):
            groups.setdefault((idx, float(rate)), []).append(pos)
        out: List[Optional[Dict[str, float]]] = [None] * len(specs)
        for (idx, rate), positions in groups.items():
            batch = [dict(specs[p][1]) for p in positions]
            for p, res in zip(positions,
                              self.executors[idx].profile(batch, rate)):
                out[p] = res
        return out

    def allocated_cost(self, idx: int, config: Mapping[str, float]) -> float:
        return self.executors[idx].allocated_cost(config)


@dataclass
class ScenarioView:
    """One scenario row of a :class:`BatchExecutor`, as a scalar
    :class:`Executor`.

    Per-scenario controllers (the
    :class:`~repro_torch.core.demeter.DemeterController` inside the sweep
    engine) bind to one row of the batched target system through this view.
    ``ScenarioView(ScalarAdapter([e]), 0)`` round-trips the scalar protocol.
    """

    batch: BatchExecutor
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
    #: device, one kernel launch an interval), "batched" (the vectorized
    #: NumPy host engine) or "scalar" (one host SimJob per scenario, the
    #: reference oracle).
    sim_backend: str = "fused"
    #: Demeter GP fitting path: "bank" (batched float32 L-BFGS on
    #: ``device``) or "scalar" (per-GP scipy reference oracle on the host).
    fit_backend: str = "bank"
    #: Demeter TSF path: "bank" (one shared float64 ForecastBank on
    #: ``device``) or "scalar" (per-stream float64 NumPy zoo).
    forecast_backend: str = "bank"
    #: §2.3 anomaly-detector path inside profiling runs: "scalar" (float64
    #: NumPy on the host) or "bank" (a DetectorBank on ``device``).
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


#: Maps each legacy kwarg to its EngineConfig field (the deprecation shims).
_LEGACY_FIELDS = {"engine": "sim_backend", "fit_backend": "fit_backend",
                  "forecast_backend": "forecast_backend",
                  "detector_backend": "detector_backend"}


def warn_legacy_kwarg(name: str, *, stacklevel: int = 3) -> None:
    """Emit the canonical DeprecationWarning for one legacy string kwarg."""
    warnings.warn(
        f"the {name!r} kwarg is deprecated; pass "
        f"config=EngineConfig({_LEGACY_FIELDS[name]}=...) instead",
        DeprecationWarning, stacklevel=stacklevel + 1)


def coerce_config(config: Optional[EngineConfig] = None, *,
                  engine: Optional[str] = None,
                  fit_backend: Optional[str] = None,
                  forecast_backend: Optional[str] = None,
                  detector_backend: Optional[str] = None,
                  hp: Optional["DemeterHyperParams"] = None,
                  decision_interval_s: Optional[float] = None,
                  stacklevel: int = 3) -> EngineConfig:
    """Resolve an :class:`EngineConfig` from the ``config`` object or the
    legacy string kwargs.

    Every legacy kwarg passed emits a DeprecationWarning and is folded into
    the returned config; mixing ``config`` with a legacy kwarg raises (one
    configuration surface, not two). ``hp`` and ``decision_interval_s``
    fold in silently: they are parameters that moved, not deprecated
    spellings.
    """
    legacy = {"engine": engine, "fit_backend": fit_backend,
              "forecast_backend": forecast_backend,
              "detector_backend": detector_backend}
    passed = {k: v for k, v in legacy.items() if v is not None}
    if config is not None and passed:
        raise ValueError(
            f"pass either config=EngineConfig(...) or the legacy kwargs "
            f"{sorted(passed)}, not both")
    for name in passed:
        warn_legacy_kwarg(name, stacklevel=stacklevel)
    base = config if config is not None else EngineConfig()
    overrides: Dict[str, object] = {_LEGACY_FIELDS[k]: v
                                    for k, v in passed.items()}
    if hp is not None:
        overrides["hp"] = hp
    if decision_interval_s is not None:
        overrides["decision_interval_s"] = decision_interval_s
    return base.replace(**overrides) if overrides else base
