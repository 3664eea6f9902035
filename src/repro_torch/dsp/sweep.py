"""Batched multi-scenario sweep engine.

Executes a whole :class:`ScenarioSpec` grid — trace class x controller x
seed x failure schedule — as one run. The engine is a thin event loop over
two pluggable surfaces:

* a sweep executor from :data:`repro_torch.core.registry.SIM_ENGINES`:
  ``"fused"`` (:class:`~repro_torch.dsp.fused.FusedSweepExecutor`) moves
  whole decision intervals to the device and is driven by
  ``drive_intervals()`` below; ``"batched"``
  (:class:`~repro_torch.dsp.executor.BatchedSweepExecutor`) advances all
  scenarios one NumPy step at a time through ``drive_ticks()``, and
  ``"scalar"`` (:class:`~repro_torch.dsp.executor.ScalarSweepExecutor`)
  steps one host ``SimJob`` per scenario the same way, the reference
  oracle;
* registered controller policies (:mod:`repro_torch.dsp.policies`),
  invoked per decision interval, never per simulation step. Demeter model
  updates are batched across the grid: before any due controller acts,
  every stale (segment, metric) GP of every due scenario is refitted in
  one :meth:`~repro_torch.core.demeter.ModelBank.batch_refresh`, and every
  Demeter scenario's TSF stream lives in one shared
  :class:`~repro_torch.core.forecast_bank.ForecastBank`.

Everything is configured through one
:class:`~repro_torch.core.executor.EngineConfig`; the legacy string kwargs
(``engine=``, ``fit_backend=``, ``forecast_backend=``,
``detector_backend=``) still work as deprecation shims. Failure injection,
NR bookkeeping and the 6-minute recovery cap follow the paper's Table-3
semantics.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import obs
from ..core.demeter import DemeterHyperParams, ModelBank
from ..core.executor import EngineConfig, coerce_config, warn_legacy_kwarg
from ..core.forecast import FORECASTER_KINDS
from ..core.forecast_bank import ForecastBank, make_forecaster
from ..core.registry import CONTROLLERS, FORECASTERS, SIM_ENGINES
from ..kernels import build as _build
from . import policies as _policies  # noqa: F401  (registers the built-ins)
from .executor import SweepExecutorBase
from .runner import FAILURE_INTERVAL_S, RECOVERY_CAP_S, FailureRecord
from .simulator import ClusterModel
from .workloads import (FailureSchedule, NoFailures, PeriodicFailures, Trace,
                        make_trace)

#: Built-in controller names; the authoritative namespace is
#: :data:`repro_torch.core.registry.CONTROLLERS` (third-party policies
#: registered there are accepted everywhere these names are).
CONTROLLER_NAMES = ("static", "reactive", "ds2", "demeter")


@dataclass(frozen=True, eq=False)
class ScenarioSpec:
    """One cell of a sweep grid."""

    trace: Trace
    controller: str = "static"
    seed: int = 0
    failures: FailureSchedule = field(default_factory=NoFailures)
    label: str = ""
    #: TSF forecaster kind for Demeter scenarios (ignored by baselines);
    #: see :data:`repro_torch.core.registry.FORECASTERS`.
    forecaster: str = "arima"

    def __post_init__(self) -> None:
        CONTROLLERS.validate(self.controller)
        FORECASTERS.validate(self.forecaster)

    @property
    def name(self) -> str:
        return self.label or \
            f"{self.trace.name}/{self.controller}/s{self.seed}"


def scenario_grid(traces: Sequence[Trace],
                  controllers: Sequence[str],
                  seeds: Sequence[int],
                  failures: Optional[FailureSchedule] = None
                  ) -> List[ScenarioSpec]:
    """Cartesian trace x controller x seed grid with a shared schedule."""
    failures = failures if failures is not None else NoFailures()
    return [ScenarioSpec(trace=t, controller=c, seed=s, failures=failures)
            for t in traces for c in controllers for s in seeds]


def paper_grid(controllers: Sequence[str] = ("static", "reactive", "ds2"),
               seeds: Sequence[int] = (0,),
               trace_kinds: Sequence[str] = ("ysb", "tsw", "diurnal"),
               duration_s: float = 18 * 3600.0, dt_s: float = 5.0
               ) -> List[ScenarioSpec]:
    """Paper-style grid: named trace classes under 45-minute failures."""
    traces = [make_trace(k, duration_s=duration_s, dt_s=dt_s)
              for k in trace_kinds]
    return scenario_grid(traces, controllers, seeds,
                         failures=PeriodicFailures(FAILURE_INTERVAL_S))


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass
class ScenarioResult:
    """Per-scenario telemetry + Table-3 style bookkeeping."""

    name: str
    trace: str
    controller: str
    seed: int
    times: np.ndarray
    rates: np.ndarray
    latencies: np.ndarray
    usage_cpu: np.ndarray
    usage_mem_mb: np.ndarray
    workers: np.ndarray
    consumer_lag: np.ndarray
    failures: List[FailureRecord]
    n_reconfigurations: int
    profile_cpu_s: float = 0.0
    profile_mem_mb_s: float = 0.0

    def summary(self) -> Dict[str, object]:
        """JSON-serializable scenario digest."""
        dt = float(self.times[1] - self.times[0]) if len(self.times) > 1 \
            else 1.0
        lat = self.latencies[np.isfinite(self.latencies)]
        rec = [(None if f.recovery_s is None
                else ("6m+" if not np.isfinite(f.recovery_s)
                      else round(float(f.recovery_s), 1)))
               for f in self.failures]
        return {
            "name": self.name, "trace": self.trace,
            "controller": self.controller, "seed": self.seed,
            "duration_s": float(len(self.times) * dt),
            "latency_p50_s": float(np.percentile(lat, 50)) if len(lat) else None,
            "latency_p95_s": float(np.percentile(lat, 95)) if len(lat) else None,
            "latency_p99_s": float(np.percentile(lat, 99)) if len(lat) else None,
            "frac_latency_below_2s": float(np.mean(lat < 2.0)) if len(lat)
            else None,
            "mean_consumer_lag": float(np.mean(self.consumer_lag)),
            "cumulative_cpu_core_s": float(np.sum(self.usage_cpu) * dt),
            "cumulative_mem_mb_s": float(np.sum(self.usage_mem_mb) * dt),
            "profile_cpu_core_s": float(self.profile_cpu_s),
            "profile_mem_mb_s": float(self.profile_mem_mb_s),
            "n_reconfigurations": int(self.n_reconfigurations),
            "n_failures_injected": len(self.failures),
            "recoveries_s": rec,
        }

    def allclose(self, other: "ScenarioResult", rtol: float = 1e-9,
                 atol: float = 1e-9) -> bool:
        """Step-for-step equivalence check against another engine's result."""
        arrays = ("times", "rates", "latencies", "usage_cpu", "usage_mem_mb",
                  "workers", "consumer_lag")
        if not all(np.allclose(getattr(self, a), getattr(other, a),
                               rtol=rtol, atol=atol) for a in arrays):
            return False
        if self.n_reconfigurations != other.n_reconfigurations:
            return False
        if len(self.failures) != len(other.failures):
            return False
        for fa, fb in zip(self.failures, other.failures):
            if (fa.recovery_s is None) != (fb.recovery_s is None):
                return False
            if fa.recovery_s is not None and \
                    not np.isclose(fa.recovery_s, fb.recovery_s):
                return False
        return True


@dataclass
class SweepResult:
    engine: str
    scenarios: List[ScenarioResult]
    wall_s: float
    n_steps: int
    #: wall-clock spent fitting GP models (shared batched refreshes plus any
    #: lazy per-controller fits) and how many models were fitted
    model_update_wall_s: float = 0.0
    n_model_fits: int = 0
    #: wall-clock the TSF forecasters cost (telemetry updates + rollout
    #: reads; for the bank backend that is staging + the shared batched
    #: flush/rollout passes) and how many stream-updates were applied
    forecast_update_wall_s: float = 0.0
    n_forecast_updates: int = 0
    #: the wall of building and loading a layer's kernel at its first use
    #: in the process, split out of that layer's update wall above (0.0
    #: when the kernel was already loaded; the GP path launches none)
    model_update_compile_wall_s: float = 0.0
    forecast_update_compile_wall_s: float = 0.0

    def by_name(self) -> Dict[str, ScenarioResult]:
        return {s.name: s for s in self.scenarios}

    def to_json(self) -> Dict[str, object]:
        return {"engine": self.engine, "wall_s": self.wall_s,
                "n_steps": self.n_steps,
                "model_update_wall_s": self.model_update_wall_s,
                "n_model_fits": self.n_model_fits,
                "forecast_update_wall_s": self.forecast_update_wall_s,
                "n_forecast_updates": self.n_forecast_updates,
                "model_update_compile_wall_s":
                    self.model_update_compile_wall_s,
                "forecast_update_compile_wall_s":
                    self.forecast_update_compile_wall_s,
                "scenarios": [s.summary() for s in self.scenarios]}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class SweepEngine:
    """Executes a ScenarioSpec grid; a thin event loop over registered
    policies and a sweep executor, configured by one
    :class:`~repro_torch.core.executor.EngineConfig`. The legacy
    ``fit_backend=`` / ``forecast_backend=`` / ``detector_backend=`` string
    kwargs still work as deprecation shims."""

    def __init__(self, specs: Sequence[ScenarioSpec], *,
                 config: Optional[EngineConfig] = None,
                 model: Optional[ClusterModel] = None,
                 hp: Optional[DemeterHyperParams] = None,
                 decision_interval_s: Optional[float] = None,
                 recovery_cap_s: float = RECOVERY_CAP_S,
                 fit_backend: Optional[str] = None,
                 forecast_backend: Optional[str] = None,
                 detector_backend: Optional[str] = None):
        if not specs:
            raise ValueError("empty scenario grid")
        self._explicit_config = config is not None
        self.config = coerce_config(config, fit_backend=fit_backend,
                                    forecast_backend=forecast_backend,
                                    detector_backend=detector_backend,
                                    hp=hp,
                                    decision_interval_s=decision_interval_s)
        # One error surface, before any work: with the shared-bank TSF path,
        # every banked scenario's forecaster must be a kind the ForecastBank
        # can pack (plugin kinds run on the scalar backend).
        if self.config.forecast_backend == "bank":
            for s in specs:
                cls = CONTROLLERS.get(s.controller)
                if getattr(cls, "uses_tsf_bank", False) \
                        and s.forecaster not in FORECASTER_KINDS:
                    raise ValueError(
                        f"forecaster {s.forecaster!r} (scenario {s.name!r}) "
                        f"is not supported by forecast_backend='bank'; "
                        f"bankable kinds: {FORECASTER_KINDS}. Use "
                        f"EngineConfig(forecast_backend='scalar') for "
                        f"plugin forecasters.")
        dts = {s.trace.dt_s for s in specs}
        if len(dts) > 1:
            raise ValueError(f"all traces must share dt_s, got {sorted(dts)}")
        self.specs = list(specs)
        self.model = model or ClusterModel()
        self.recovery_cap_s = recovery_cap_s
        self.dt = float(specs[0].trace.dt_s)

        S = len(self.specs)
        self.n_steps_each = np.array(
            [int(s.trace.duration_s / self.dt) for s in self.specs])
        self.n_steps = int(self.n_steps_each.max())
        # Rate matrix, padded with each trace's final value (padded steps are
        # simulated for batch-shape uniformity but excluded from results).
        self.R = np.empty((S, self.n_steps))
        for j, s in enumerate(self.specs):
            n = self.n_steps_each[j]
            self.R[j, :n] = s.trace.rates[:n]
            self.R[j, n:] = s.trace.rates[n - 1] if n else 0.0
        self.fail_times = [s.failures.times(s.trace.duration_s)
                           for s in self.specs]

        #: the executor of the current/most recent run()
        self.executor: Optional[SweepExecutorBase] = None
        self.forecast_bank: Optional[ForecastBank] = None
        self.policies: List[object] = []

    # -- resolved config conveniences ---------------------------------------
    @property
    def hp(self) -> Optional[DemeterHyperParams]:
        return self.config.hp

    @property
    def decision_interval_s(self) -> float:
        return self.config.decision_interval_s

    @property
    def fit_backend(self) -> str:
        return self.config.fit_backend

    @property
    def forecast_backend(self) -> str:
        return self.config.forecast_backend

    # -- main loop -----------------------------------------------------------
    def run(self, engine: Optional[str] = None) -> SweepResult:
        """Execute the grid on ``config.sim_backend``.

        ``engine=`` is the deprecated per-run override of the simulation
        backend; it is validated against
        :data:`repro_torch.core.registry.SIM_ENGINES`.
        """
        config = self.config
        if engine is not None:
            if self._explicit_config:
                raise ValueError(
                    "pass either config=EngineConfig(sim_backend=...) or "
                    "the legacy engine= kwarg, not both")
            warn_legacy_kwarg("engine")
            config = config.replace(sim_backend=SIM_ENGINES.validate(engine))
        executor_cls = SIM_ENGINES.get(config.sim_backend)

        S = len(self.specs)
        seeds = [s.seed for s in self.specs]
        policy_classes = [CONTROLLERS.get(s.controller) for s in self.specs]
        # Policies declare their start configs up front: the executor boots
        # every scenario's job with them.
        start_configs = [cls.start_config_for(spec, config)
                         for cls, spec in zip(policy_classes, self.specs)]
        self.executor = ex = executor_cls(
            self.model, start_configs, seeds, dt=self.dt,
            n_steps=self.n_steps, device=config.device,
            detector_backend=config.detector_backend)

        # One shared ForecastBank on the config's device for every scenario
        # whose policy opts in (``uses_tsf_bank``): the engine stages all due
        # observations and the bank applies them in one batched pass when
        # the next policy reads a forecast. The scalar backend gives each
        # policy its own float64 NumPy zoo forecaster (reference oracle).
        hp_horizon = config.resolved_hp().forecast_horizon
        bank_rows = [j for j, cls in enumerate(policy_classes)
                     if getattr(cls, "uses_tsf_bank", False)]
        forecast_bank: Optional[ForecastBank] = None
        tsf_views: Dict[int, object] = {}
        if bank_rows and config.forecast_backend == "bank":
            forecast_bank = ForecastBank(
                [self.specs[j].forecaster for j in bank_rows],
                horizon=hp_horizon, device=config.device)
            tsf_views = {j: forecast_bank.view(r)
                         for r, j in enumerate(bank_rows)}
        elif bank_rows:
            tsf_views = {j: make_forecaster(self.specs[j].forecaster,
                                            backend="scalar")
                         for j in bank_rows}
        #: the shared forecast bank of the current/most recent run()
        self.forecast_bank = forecast_bank

        #: the policies of the current/most recent run(), one per scenario
        self.policies = policies = [
            cls(self, j, spec, config, tsf=tsf_views.get(j))
            for j, (cls, spec) in enumerate(zip(policy_classes, self.specs))]
        model_update_wall = 0.0
        n_model_fits = 0
        forecast_wall = 0.0
        n_forecast_updates = 0

        pending: Dict[int, FailureRecord] = {}
        pending_reconf = np.zeros(S, dtype=int)
        next_fail = np.zeros(S, dtype=int)
        #: time of each scenario's next injection (inf when exhausted)
        nf_time = np.array([ft[0] if len(ft) else np.inf
                            for ft in self.fail_times])
        failures: List[List[FailureRecord]] = [[] for _ in range(S)]
        policy_next = np.array([p.initial_due(self) for p in policies])
        end_time = self.n_steps_each * self.dt
        uniform = bool(np.all(self.n_steps_each == self.n_steps))
        ticks = np.arange(self.n_steps) * self.dt

        # The event loop is one set of bookkeeping helpers shared by two
        # drivers: drive_ticks() wakes the host every simulator step (the
        # NumPy engine), drive_intervals() only at event boundaries, handing
        # whole host-quiet runs of ticks to an interval-capable executor
        # (the fused engine) in one call. Both produce identical records.

        def advance_failure(j: int) -> None:
            next_fail[j] += 1
            ft = self.fail_times[j]
            nf_time[j] = ft[next_fail[j]] \
                if next_fail[j] < len(ft) else np.inf

        def record_injections(t: float, i: int, injected) -> None:
            for j in injected:
                if j in pending:
                    # previous failure never resolved before this one
                    # landed: close it as NR rather than dropping it
                    failures[j].append(pending[j])
                pending[j] = FailureRecord(t_inject=t,
                                           workload=float(self.R[j, i]),
                                           recovery_s=None)
                pending_reconf[j] = ex.reconf_count[j]

        def close_pending(t: float, injected, active, caught) -> None:
            """Table-3 recovery bookkeeping for one tick's pending records
            (``caught`` is each scenario's caught-up flag after that tick)."""
            for j in [j for j in pending
                      if j not in injected
                      and (active is None or active[j])]:
                rec = pending[j]
                elapsed = t - rec.t_inject
                if ex.reconf_count[j] != pending_reconf[j]:
                    rec.recovery_s = None           # NR: reconfig overlapped
                elif caught[j]:
                    rec.recovery_s = elapsed
                elif elapsed > self.recovery_cap_s * 2:
                    rec.recovery_s = float("inf")
                    rec.capped = True
                else:
                    continue
                failures[j].append(rec)
                del pending[j]

        def policy_block(t: float, i: int, active) -> None:
            """Controller decisions (event-scheduled, never per-step)."""
            nonlocal model_update_wall, n_model_fits, n_forecast_updates
            pol_due = t >= policy_next
            if active is not None:
                pol_due &= active
            if not pol_due.any():
                return
            due = np.nonzero(pol_due)[0]
            if obs.enabled():
                obs.inc("sweep.policy_triggers", len(due))
            # Two-phase telemetry ingestion for policies that opt in
            # (``pending_ingest`` + ``ingest``): every due observation lands
            # in the shared ForecastBank, which replays all queued ticks of
            # all streams in one batched pass when the next policy reads a
            # forecast (the scalar backend updates inline).
            due_obs = [(policies[j],
                        policies[j].pending_ingest(self, j, t, i))
                       for j in due
                       if hasattr(policies[j], "pending_ingest")]
            for pol, ob in due_obs:
                if ob is not None:
                    pol.ingest(ob)
                    n_forecast_updates += 1
            # One shared model update for every due policy that carries a
            # model bank (``bank``), before any controller acts.
            banks = [b for j in due
                     if (b := getattr(policies[j], "bank", None)) is not None]
            if banks:
                n_fit, fit_wall = ModelBank.batch_refresh(banks)
                model_update_wall += fit_wall
                n_model_fits += n_fit
            with obs.span("sweep.policy_block", t=float(t), due=len(due)):
                for j in due:
                    policy_next[j] = policies[j].act(self, j, t, i)

        def drive_ticks() -> None:
            """Classic driver: one executor dispatch per simulator tick."""
            for i in range(self.n_steps):
                t = ticks[i]
                ex.step(self.R[:, i])
                active = None if uniform else (t < end_time)
                due = t >= nf_time
                if active is not None:
                    due &= active
                injected = ()
                if due.any():
                    injected = np.nonzero(due)[0]
                    for j in injected:
                        ex.inject_failure(j)
                        advance_failure(j)
                    record_injections(t, i, injected)
                if pending:
                    close_pending(t, injected, active, ex.caught_up())
                policy_block(t, i, active)

        def schedule_injections(i0: int, i1: int) -> Optional[np.ndarray]:
            """Consume every failure due in ticks ``[i0, i1]`` into a
            ``[K, S]`` bool injection plane (None when the interval is
            failure-free).

            A failure fires at the first tick whose time reaches it —
            clamped past the previous injection's tick, which reproduces the
            per-tick driver landing already-due failures on consecutive
            ticks. Failures whose tick falls beyond a scenario's own
            duration are never injected (nor consumed: the scenario is
            inactive from there on, like the per-tick driver's ``active``
            mask)."""
            inject = None
            # Host event scheduling, not per-step work: failures are sparse
            # (tens of minutes apart) and consuming them is O(failures), so
            # this loop runs once per interval, outside the hot path.
            for j in range(S):  # noqa: REPRO-003
                k_prev = i0 - 1
                while np.isfinite(nf_time[j]):
                    kk = max(int(np.searchsorted(ticks, nf_time[j],
                                                 side="left")), k_prev + 1)
                    if kk >= self.n_steps_each[j]:
                        break                     # inactive from here on
                    if kk > i1:
                        break                     # lands in a later interval
                    if inject is None:
                        inject = np.zeros((i1 - i0 + 1, S), dtype=bool)
                    inject[kk - i0, j] = True
                    advance_failure(j)
                    k_prev = kk
            return inject

        def drive_intervals() -> None:
            """Interval driver: the host wakes only at event boundaries.

            Each pass advances to the earliest due policy tick (or the end
            of the run), hands the whole tick range plus its precomputed
            injection schedule to ``ex.step_interval`` in one call, and
            replays the recovery bookkeeping from the returned metric
            planes — valid tick by tick because reconfiguration counts are
            constant inside an interval and a non-injected scenario's
            caught-up flag is exactly ``~down & lag < 1`` after its tick.
            """
            big = self.n_steps + 1
            i = 0
            while i < self.n_steps:
                i_evt_each = np.searchsorted(ticks, policy_next, side="left")
                i_evt_each = np.where(i_evt_each < self.n_steps_each,
                                      i_evt_each, big)
                i_evt = max(i, min(int(i_evt_each.min()), self.n_steps - 1))
                inject = schedule_injections(i, i_evt)
                ms = ex.step_interval(self.R[:, i:i_evt + 1].T, inject)
                if inject is not None or pending:
                    down = ms["down"].astype(bool)
                    lag = ms["consumer_lag"]
                    for k in range(i_evt - i + 1):
                        injected = np.nonzero(inject[k])[0] \
                            if inject is not None else ()
                        if len(injected) == 0 and not pending:
                            continue
                        t = ticks[i + k]
                        active = None if uniform else (t < end_time)
                        record_injections(t, i + k, injected)
                        if pending:
                            close_pending(t, injected, active,
                                          ~down[k] & (lag[k] < 1.0))
                t = ticks[i_evt]
                policy_block(t, i_evt, None if uniform else (t < end_time))
                i = i_evt + 1

        load_wall0 = dict(_build.load_wall_s)
        t0 = time.perf_counter()
        with obs.span("sweep.run", engine=config.sim_backend, scenarios=S,
                      steps=int(self.n_steps)):
            if getattr(ex, "supports_intervals", False):
                drive_intervals()
            else:
                drive_ticks()
        wall = time.perf_counter() - t0
        # Fold in lazy fits (segments first hit mid-act, cold starts).
        for p in policies:
            bank = getattr(p, "bank", None)
            if bank is not None:
                model_update_wall += bank.fit_wall_s
                n_model_fits += bank.n_fits
        # TSF wall: every policy accumulates its own forecaster wall
        # (updates, flushes triggered by reads, rollouts). Any leftover
        # staged samples are flushed here, outside all controller timers,
        # so they are timed explicitly.
        if forecast_bank is not None:
            t0_f = time.perf_counter()
            forecast_bank.flush()
            forecast_wall += time.perf_counter() - t0_f
        forecast_wall += sum(getattr(p, "tsf_wall_s", 0.0) for p in policies)
        # First-use split: building and loading the forecast bank's kernel
        # (K1) and the GP bank's fit kernel at their first launch in this
        # process happened inside the TSF and model-update walls above;
        # they are reported apart, so the steady-state walls stay
        # comparable across cold and warm processes.
        forecast_compile_wall = (_build.load_wall_s.get("rls_update", 0.0)
                                 - load_wall0.get("rls_update", 0.0))
        forecast_wall = max(forecast_wall - forecast_compile_wall, 0.0)
        model_compile_wall = (_build.load_wall_s.get("gp_fit", 0.0)
                              - load_wall0.get("gp_fit", 0.0))
        model_update_wall = max(model_update_wall - model_compile_wall, 0.0)

        results = []
        for j, spec in enumerate(self.specs):
            if j in pending:
                failures[j].append(pending[j])
            n = int(self.n_steps_each[j])
            cost = ex.profile_costs[j]
            results.append(ScenarioResult(
                name=spec.name, trace=spec.trace.name,
                controller=spec.controller, seed=spec.seed,
                times=np.arange(n) * self.dt,
                rates=ex.hist["rate"][j, :n].copy(),
                latencies=ex.hist["latency"][j, :n].copy(),
                usage_cpu=ex.hist["usage_cpu"][j, :n].copy(),
                usage_mem_mb=ex.hist["usage_mem_mb"][j, :n].copy(),
                workers=ex.workers_hist[j, :n].copy(),
                consumer_lag=ex.hist["consumer_lag"][j, :n].copy(),
                failures=failures[j],
                n_reconfigurations=int(ex.reconf_count[j]),
                profile_cpu_s=cost.cpu_s, profile_mem_mb_s=cost.mem_mb_s,
            ))
        return SweepResult(engine=config.sim_backend, scenarios=results,
                           wall_s=wall, n_steps=self.n_steps,
                           model_update_wall_s=model_update_wall,
                           n_model_fits=n_model_fits,
                           forecast_update_wall_s=forecast_wall,
                           n_forecast_updates=n_forecast_updates,
                           model_update_compile_wall_s=model_compile_wall,
                           forecast_update_compile_wall_s=(
                               forecast_compile_wall))


def run_sweep(specs: Sequence[ScenarioSpec], *,
              config: Optional[EngineConfig] = None,
              engine: Optional[str] = None,
              model: Optional[ClusterModel] = None,
              hp: Optional[DemeterHyperParams] = None,
              decision_interval_s: Optional[float] = None,
              fit_backend: Optional[str] = None,
              forecast_backend: Optional[str] = None,
              detector_backend: Optional[str] = None) -> SweepResult:
    """Execute a scenario grid in one invocation.

    ``config`` defaults to ``EngineConfig()``: the ``"fused"`` engine, the
    shared forecast bank and the GP bank on ``device="cuda"``, which raises
    where CUDA is missing; pass ``EngineConfig(device="cpu")`` to run on the
    CPU, or ``sim_backend="batched"`` for the NumPy host engine. Demeter
    scenarios (``controller="demeter"``) take their GP-fit and TSF paths
    from ``config.fit_backend`` / ``config.forecast_backend`` and their
    forecaster kind from :attr:`ScenarioSpec.forecaster`.

    The ``engine=`` / ``fit_backend=`` / ``forecast_backend=`` /
    ``detector_backend=`` string kwargs are deprecated shims for the same
    fields; ``hp`` and ``decision_interval_s`` fold into the config.
    """
    eng = SweepEngine(specs, config=config, model=model, hp=hp,
                      decision_interval_s=decision_interval_s,
                      fit_backend=fit_backend,
                      forecast_backend=forecast_backend,
                      detector_backend=detector_backend)
    return eng.run(engine)
