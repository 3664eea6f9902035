"""Registered sweep controller policies.

A *policy* adapts one controller family to the sweep engine's event loop
and is registered in :data:`repro_torch.core.registry.CONTROLLERS` under
the name :attr:`~repro_torch.dsp.sweep.ScenarioSpec.controller` uses.

The policy contract (duck-typed; :class:`SweepPolicy` documents the
required instance surface):

* ``PolicyCls.start_config_for(spec, config) -> JobConfig`` — the
  configuration the scenario's job boots with;
* ``PolicyCls(eng, idx, spec, config, tsf=None)`` — built once per row;
* ``initial_due(eng) -> float`` / ``act(eng, idx, t, i) -> float`` — the
  event-scheduled decision hook; ``act`` returns the next due time.

Optional capabilities the engine detects with ``getattr``:

* ``uses_tsf_bank = True`` (class attribute) — the scenario's forecaster
  lives in the sweep-wide shared
  :class:`~repro_torch.core.forecast_bank.ForecastBank`; the engine passes
  the scenario's view as ``tsf=``.
* ``pending_ingest(eng, idx, t, i)`` + ``ingest(obs)`` — two-phase
  telemetry ingestion, so the engine stages every due scenario's
  observation before any controller reads a forecast.
* ``bank`` (a :class:`~repro_torch.core.demeter.ModelBank`) — take part in
  the engine's shared model update (``ModelBank.batch_refresh``).
* ``tsf_wall_s`` — forecaster wall-clock the engine folds into
  :attr:`~repro_torch.dsp.sweep.SweepResult.forecast_update_wall_s`.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Protocol

from ..core.config_space import paper_flink_space
from ..core.demeter import DemeterController
from ..core.executor import EngineConfig, ScenarioView
from ..core.registry import CONTROLLERS
from .baselines import make_baseline
from .runner import METRIC_WINDOW_S, OPT_INTERVAL_S
from .simulator import JobConfig

if TYPE_CHECKING:
    from .sweep import ScenarioSpec, SweepEngine


class SweepPolicy(Protocol):
    """Instance surface every registered sweep policy provides."""

    start_config: JobConfig

    def initial_due(self, eng: "SweepEngine") -> float: ...

    def act(self, eng: "SweepEngine", idx: int, t: float, i: int) -> float:
        """One decision-point invocation; returns the next due time."""
        ...


class BaselinePolicy:
    """A decide()-style controller at the engine's fixed decision cadence.

    Serves every baseline of :func:`repro_torch.dsp.baselines.make_baseline`
    (static / reactive / ds2).
    """

    uses_tsf_bank = False

    #: what decide()-style controllers actually consume from a window
    WINDOW_KEYS = ("utilization", "rate", "throughput", "latency")

    @classmethod
    def start_config_for(cls, spec: "ScenarioSpec",
                         config: EngineConfig) -> JobConfig:
        return make_baseline(spec.controller)[1]

    def __init__(self, eng: "SweepEngine", idx: int, spec: "ScenarioSpec",
                 config: EngineConfig, tsf: Optional[object] = None):
        self.ctl, self.start_config = make_baseline(spec.controller)

    def initial_due(self, eng: "SweepEngine") -> float:
        return eng.decision_interval_s

    def act(self, eng: "SweepEngine", idx: int, t: float, i: int) -> float:
        ex = eng.executor
        window = ex.window_dicts(idx, METRIC_WINDOW_S, keys=self.WINDOW_KEYS)
        new = self.ctl.decide(t, window, ex.config_of(idx))
        if new is not None:
            ex.reconfigure_one(idx, new, getattr(self.ctl, "restart_s", None))
        return t + eng.decision_interval_s


CONTROLLERS.register("static", BaselinePolicy)
CONTROLLERS.register("reactive", BaselinePolicy)
CONTROLLERS.register("ds2", BaselinePolicy)


@CONTROLLERS.register("demeter")
class DemeterPolicy:
    """Demeter's two processes at the paper cadences (§3.2).

    The controller binds to its scenario row through a
    :class:`~repro_torch.core.executor.ScenarioView` over the engine's
    sweep executor. Telemetry ingestion is split out of :meth:`act` (see
    :meth:`pending_ingest`) so the engine can stage every due scenario's
    observation and apply the whole batch through one shared
    :class:`~repro_torch.core.forecast_bank.ForecastBank` flush before any
    controller consumes a forecast.
    """

    uses_tsf_bank = True

    @classmethod
    def start_config_for(cls, spec: "ScenarioSpec",
                         config: EngineConfig) -> JobConfig:
        return JobConfig()                     # C_max (paper §3.2)

    def __init__(self, eng: "SweepEngine", idx: int, spec: "ScenarioSpec",
                 config: EngineConfig, tsf: Optional[object] = None):
        self.view = ScenarioView(eng.executor, idx)
        self.start_config = JobConfig.from_dict(self.view.cmax_config())
        self.ctl = DemeterController(paper_flink_space(), self.view,
                                     forecaster=spec.forecaster,
                                     tsf=tsf, config=config)
        self.bank = self.ctl.bank              # shared-model-update hook
        self._next_ingest = METRIC_WINDOW_S
        self._next_opt = OPT_INTERVAL_S
        # async offset between the two processes (mirrors runner.py)
        self._next_prof = OPT_INTERVAL_S / 2.0 + self.ctl.hp.profile_interval_s

    @property
    def tsf_wall_s(self) -> float:
        return self.ctl.tsf_wall_s

    def initial_due(self, eng: "SweepEngine") -> float:
        return min(self._next_ingest, self._next_prof, self._next_opt)

    def pending_ingest(self, eng: "SweepEngine", idx: int, t: float,
                       i: int) -> Optional[Dict[str, float]]:
        """The observation to ingest this tick (or None); advances the
        ingest clock."""
        if t < self._next_ingest:
            return None
        self._next_ingest = t + METRIC_WINDOW_S
        return self.view.observe() or None

    def ingest(self, obs: Dict[str, float]) -> None:
        self.ctl.ingest(obs)

    def act(self, eng: "SweepEngine", idx: int, t: float, i: int) -> float:
        if t >= self._next_prof:
            self._next_prof = t + self.ctl.hp.profile_interval_s
            self.ctl.profiling_step()
        if t >= self._next_opt:
            self._next_opt = t + OPT_INTERVAL_S
            # Push the telemetry the engine already holds instead of having
            # the controller pull it back through the executor protocol.
            self.ctl.optimization_step(metrics=self.view.observe())
        return min(self._next_ingest, self._next_prof, self._next_opt)
