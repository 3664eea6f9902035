"""Registered sweep controller policies.

A *policy* adapts one controller family to the sweep engine's event loop
and is registered in :data:`repro_torch.core.registry.CONTROLLERS` under
the name :attr:`~repro_torch.dsp.sweep.ScenarioSpec.controller` uses.

The policy contract (duck-typed):

* ``PolicyCls.start_config_for(spec, config) -> JobConfig`` — the
  configuration the scenario's job boots with;
* ``PolicyCls(eng, idx, spec, config, tsf=None)`` — built once per row;
* ``initial_due(eng) -> float`` / ``act(eng, idx, t, i) -> float`` — the
  event-scheduled decision hook; ``act`` returns the next due time.

This slice registers the paper's baselines only; the Demeter controller
arrives with its forecast and GP banks.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..core.executor import EngineConfig
from ..core.registry import CONTROLLERS
from .baselines import make_baseline
from .runner import METRIC_WINDOW_S
from .simulator import JobConfig

if TYPE_CHECKING:
    from .sweep import ScenarioSpec, SweepEngine


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
