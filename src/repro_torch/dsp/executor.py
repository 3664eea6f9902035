"""DSP implementations of the Demeter executor protocols.

Two layers live here:

* the scalar :class:`DSPExecutor` — one target job (a host
  :class:`~repro_torch.dsp.simulator.SimJob`) behind the
  :class:`~repro_torch.core.executor.Executor` protocol, what the
  paper-protocol runner drives; lift it onto the batched control plane
  with :class:`~repro_torch.core.executor.ScalarAdapter`;
* the sweep executors — whole scenario grids behind the
  :class:`~repro_torch.core.executor.BatchExecutor` protocol.
  :class:`SweepExecutorBase` owns everything per scenario that is not the
  stepping backend — telemetry history, reconfiguration counts, profiling
  costs and the C_max anchor. :class:`BatchedSweepExecutor` (registered as
  ``"batched"``) steps every scenario through one vectorized NumPy
  :meth:`~repro_torch.dsp.simulator.ClusterModel.step_batch` call, and
  :class:`ScalarSweepExecutor` (``"scalar"``) one ``SimJob`` per scenario
  in a Python loop, the reference oracle. The usage and cost
  normalizations are module-level so every executor shares them.

Profiling runs follow the paper's lifecycle (§2.3, Fig. 3): deploy a clone
at the predicted rate -> 2-minute stabilization -> 1-minute latency
measurement -> inject a timeout failure -> measure recovery with the
online-ARIMA anomaly detector over (throughput, consumer lag) until full
catch-up or the 360 s timeout (:func:`profile_one`). The clones are
per-scenario host simulations (:class:`~repro_torch.dsp.simulator.SimJob`)
seeded ``seed*1009 + k + int(rate)``, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..core.anomaly import RecoveryTracker
from ..core.executor import ProfileSpec, resolve_device
from ..core.registry import SIM_ENGINES
from ..core.segments import LATENCY, RECOVERY, USAGE
from .simulator import (BatchedNormals, BatchState, ClusterModel, JobConfig,
                        SimJob)

#: Profiling lifecycle constants (paper §3.2).
STABILIZATION_S = 120.0
MEASURE_S = 60.0
RECOVERY_TIMEOUT_S = 360.0


@dataclass
class ProfileCost:
    cpu_s: float = 0.0      # core-seconds consumed by profiling clones
    mem_mb_s: float = 0.0   # MB-seconds consumed by profiling clones

    def add(self, m: Mapping[str, float], dt: float) -> None:
        """Charge a profiling clone's *used* resources for one sim step."""
        self.cpu_s += m["usage_cpu"] * dt
        self.mem_mb_s += m["usage_mem_mb"] * dt


def usage_norm_values(model: ClusterModel, cmax: JobConfig, cpu, mem):
    """C_max-normalized 50/50 CPU+memory usage; elementwise over arrays."""
    return (0.5 * cpu / model.allocated_cpu(cmax)
            + 0.5 * mem / model.allocated_mem_mb(cmax))


def usage_norm(model: ClusterModel, cmax: JobConfig,
               window: List[Dict[str, float]]) -> float:
    """C_max-normalized 50/50 CPU+memory usage scalar over a metric window."""
    cpu = np.mean([m["usage_cpu"] for m in window])
    mem = np.mean([m["usage_mem_mb"] for m in window])
    return float(usage_norm_values(model, cmax, cpu, mem))


def allocated_cost(model: ClusterModel, cmax: JobConfig,
                   config: Mapping[str, float]) -> float:
    """Deterministic allocated-resource scalar, normalized against C_max."""
    cfg = JobConfig.from_dict(config)
    cpu = model.allocated_cpu(cfg) / model.allocated_cpu(cmax)
    mem = model.allocated_mem_mb(cfg) / model.allocated_mem_mb(cmax)
    return 0.5 * cpu + 0.5 * mem


def observe_digest(model: ClusterModel, cmax: JobConfig,
                   window: List[Dict[str, float]]) -> Dict[str, float]:
    """The observation Demeter's optimizing process consumes: mean rate and
    latency plus the C_max-normalized usage scalar over a metric window."""
    if not window:
        return {}
    return {"rate": float(np.mean([m["rate"] for m in window])),
            "latency": float(np.mean([m["latency"] for m in window])),
            "usage": usage_norm(model, cmax, window)}


def profile_one(model: ClusterModel, cmax: JobConfig, cfg: JobConfig,
                rate: float, dt: float, seed: int,
                account: Optional[Callable[[Dict[str, float]], None]] = None,
                detector_backend: str = "scalar", device: str = "cuda"
                ) -> Optional[Dict[str, float]]:
    """Run one profiling clone through the paper's lifecycle.

    Returns the USAGE / LATENCY / RECOVERY observation, or None for a failed
    run. ``account`` is called with each step's metrics so callers can charge
    the clone's resource-time; ``detector_backend`` picks the §2.3 anomaly
    detector path (see :data:`repro_torch.core.registry.DETECTOR_BACKENDS`)
    and ``device`` where a ``"bank"`` detector keeps its state."""
    clone = SimJob(model, cfg, seed=seed)
    tracker = RecoveryTracker(detector_backend=detector_backend,
                              device=device)
    t = 0.0
    lat_samples: List[float] = []
    usage_samples: List[Dict[str, float]] = []

    while t < STABILIZATION_S + MEASURE_S:
        t += dt
        m = clone.step(rate, dt)
        if account is not None:
            account(m)
        tracker.observe(t, {"throughput": m["throughput"],
                            "consumer_lag": m["consumer_lag"]})
        if t > STABILIZATION_S:
            lat_samples.append(m["latency"])
            usage_samples.append(m)

    lavg = float(np.mean(lat_samples))
    usage = usage_norm(model, cmax, usage_samples)

    clone.inject_failure()
    t_fail, recovered = t, None
    while t - t_fail < RECOVERY_TIMEOUT_S:
        t += dt
        m = clone.step(rate, dt)
        if account is not None:
            account(m)
        tracker.observe(t, {"throughput": m["throughput"],
                            "consumer_lag": m["consumer_lag"]})
        if tracker.last_recovery_s is not None and clone.caught_up:
            recovered = t - t_fail
            break
    if not np.isfinite(lavg):
        return None
    # An un-recovered run still informs the models: pin R at the timeout.
    recovery = tracker.last_recovery_s if recovered is not None \
        else RECOVERY_TIMEOUT_S
    return {USAGE: usage, LATENCY: lavg, RECOVERY: float(recovery)}


@dataclass
class DSPExecutor:
    """Owns one target job (a host :class:`SimJob`) and serves the scalar
    :class:`~repro_torch.core.executor.Executor` protocol.

    Its profiling clones run the ``"scalar"`` detector on the host, as the
    reference's do; a sweep executor's ``detector_backend`` does not reach
    it."""

    model: ClusterModel
    cmax: JobConfig
    seed: int = 0
    dt: float = 5.0
    job: SimJob = field(init=False)
    profile_cost: ProfileCost = field(default_factory=ProfileCost)
    _metrics_window: List[Dict[str, float]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.job = SimJob(self.model, self.cmax, seed=self.seed)

    # -- simulation plumbing (driven by the runner) -------------------------
    def step(self, rate: float) -> Dict[str, float]:
        m = self.job.step(rate, self.dt)
        self._metrics_window.append(m)
        if len(self._metrics_window) > int(600 / self.dt):
            self._metrics_window.pop(0)
        return m

    def window(self, seconds: float) -> List[Dict[str, float]]:
        n = max(int(seconds / self.dt), 1)
        return self._metrics_window[-n:]

    # -- Executor protocol ----------------------------------------------------
    def cmax_config(self) -> Dict[str, float]:
        return self.cmax.to_dict()

    def current_config(self) -> Dict[str, float]:
        return self.job.config.to_dict()

    def reconfigure(self, config: Mapping[str, float]) -> None:
        self.job.reconfigure(JobConfig.from_dict(config))

    def observe(self) -> Dict[str, float]:
        return observe_digest(self.model, self.cmax, self.window(60.0))

    def allocated_cost(self, config: Mapping[str, float]) -> float:
        return allocated_cost(self.model, self.cmax, config)

    # -- profiling lifecycle ---------------------------------------------------
    def profile(self, configs: List[Dict[str, float]], rate: float
                ) -> List[Optional[Dict[str, float]]]:
        return [profile_one(self.model, self.cmax, JobConfig.from_dict(c),
                            rate, self.dt,
                            seed=self.seed * 1009 + i + int(rate),
                            account=lambda m: self.profile_cost.add(m, self.dt))
                for i, c in enumerate(configs)]


#: Metric keys kept as full per-scenario history (controller windows +
#: sweep result arrays both read from these).
HIST_KEYS = ("rate", "latency", "utilization", "throughput", "consumer_lag",
             "usage_cpu", "usage_mem_mb")

#: What the Demeter optimizing process digests from a metric window.
OBSERVE_KEYS = ("rate", "latency", "usage_cpu", "usage_mem_mb")

#: Telemetry window behind ``observe()`` (the paper's 1-minute window).
OBSERVE_WINDOW_S = 60.0


class SweepExecutorBase:
    """The sweep-executor contract: per-scenario bookkeeping plus the
    simulation surface the sweep engine drives.

    The engine calls :meth:`step` (or ``step_interval`` on an engine with
    ``supports_intervals``), :meth:`inject_failure`, :meth:`config_of`,
    :meth:`caught_up`, :meth:`window_dicts` and :meth:`reconfigure_one`, and
    reads ``hist`` / ``workers_hist`` / ``reconf_count`` / ``profile_costs``.
    Subclasses implement ``_step_impl`` / ``_reconfigure_impl`` /
    ``inject_failure`` / ``config_of`` / ``workers`` / ``caught_up``.
    """

    def __init__(self, model: ClusterModel, configs: Sequence[JobConfig],
                 seeds: Sequence[int], *, dt: float, n_steps: int,
                 cmax: Optional[JobConfig] = None, device: str = "cuda",
                 detector_backend: str = "scalar"):
        S = len(configs)
        self.model = model
        self.dt = float(dt)
        self.seeds = [int(s) for s in seeds]
        self.cmax = cmax if cmax is not None else JobConfig()
        #: EngineConfig.device, resolved here so that every engine refuses a
        #: missing card alike (only the fused engine places tensors; the
        #: default is the card, as EngineConfig's is)
        self.device = resolve_device(device)
        #: the §2.3 detector behind profiling runs (DETECTOR_BACKENDS)
        self.detector_backend = detector_backend
        self.hist = {k: np.zeros((S, n_steps)) for k in HIST_KEYS}
        self.workers_hist = np.zeros((S, n_steps))
        self.profile_costs = [ProfileCost() for _ in range(S)]
        self.reconf_count = np.zeros(S, dtype=int)
        self.step_index = -1               # last recorded history column

    # -- simulation stepping (driven by the sweep engine) -------------------
    def step(self, rates: np.ndarray) -> Dict[str, np.ndarray]:
        """Advance every scenario one step; record telemetry history."""
        m = self._step_impl(np.asarray(rates, float), self.dt)
        self.step_index += 1
        for k in HIST_KEYS:
            self.hist[k][:, self.step_index] = m[k]
        self.workers_hist[:, self.step_index] = self.workers()
        return m

    def window_dicts(self, idx: int, seconds: float,
                     keys: Sequence[str] = HIST_KEYS
                     ) -> List[Dict[str, float]]:
        """Scenario ``idx``'s last ``seconds`` of telemetry as metric dicts
        (the shape decide()-style controllers consume)."""
        i = self.step_index
        n = max(int(seconds / self.dt), 1)
        lo = max(i - n + 1, 0)
        cols = [self.hist[k][idx, lo:i + 1] for k in keys]
        return [dict(zip(keys, row)) for row in zip(*cols)]

    # -- batch-executor surface ---------------------------------------------
    def n_scenarios(self) -> int:
        return len(self.seeds)

    def cmax_config(self, idx: int) -> Dict[str, float]:
        return self.cmax.to_dict()

    def current_config(self, idx: int) -> Dict[str, float]:
        return self.config_of(idx).to_dict()

    def reconfigure(self, mask: np.ndarray,
                    configs: Sequence[Optional[Mapping[str, float]]],
                    restart_s: Optional[float] = None) -> np.ndarray:
        mask = np.asarray(mask, bool)
        applied = np.zeros(len(mask), bool)
        for j in np.flatnonzero(mask):
            cfg = configs[j]
            if cfg is None:
                continue
            if not isinstance(cfg, JobConfig):
                cfg = JobConfig.from_dict(cfg)
            applied[j] = self.reconfigure_one(j, cfg, restart_s)
        return applied

    def reconfigure_one(self, idx: int, cfg: JobConfig,
                        restart_s: Optional[float] = None) -> bool:
        """Apply one scenario's reconfiguration; counts applied changes."""
        applied = self._reconfigure_impl(idx, cfg, restart_s)
        if applied:
            self.reconf_count[idx] += 1
        return applied

    def observe(self) -> Dict[str, np.ndarray]:
        """The §2.4 telemetry digest for *all* scenarios at once."""
        i = self.step_index
        if i < 0:
            return {}
        n = max(int(OBSERVE_WINDOW_S / self.dt), 1)
        lo = max(i - n + 1, 0)
        cpu = self.hist["usage_cpu"][:, lo:i + 1].mean(axis=1)
        mem = self.hist["usage_mem_mb"][:, lo:i + 1].mean(axis=1)
        return {"rate": self.hist["rate"][:, lo:i + 1].mean(axis=1),
                "latency": self.hist["latency"][:, lo:i + 1].mean(axis=1),
                "usage": usage_norm_values(self.model, self.cmax, cpu, mem)}

    def observe_one(self, idx: int) -> Dict[str, float]:
        return observe_digest(self.model, self.cmax,
                              self.window_dicts(idx, OBSERVE_WINDOW_S,
                                                keys=OBSERVE_KEYS))

    def profile(self, specs: Sequence[ProfileSpec]
                ) -> List[Optional[Dict[str, float]]]:
        """Run a flat batch of profiling requests, one host clone each.

        Per-scenario enumeration within one call preserves the clone seeds
        of the scalar protocol (``seed*1009 + k + int(rate)``)."""
        counters: Dict[int, int] = {}
        out: List[Optional[Dict[str, float]]] = []
        for idx, cfg, rate in specs:
            k = counters.get(idx, 0)
            counters[idx] = k + 1
            cost = self.profile_costs[idx]
            out.append(profile_one(
                self.model, self.cmax, JobConfig.from_dict(cfg), rate,
                self.dt, seed=self.seeds[idx] * 1009 + k + int(rate),
                account=lambda m, _c=cost: _c.add(m, self.dt),
                detector_backend=self.detector_backend,
                device=str(self.device)))
        return out

    def allocated_cost(self, idx: int, config: Mapping[str, float]) -> float:
        return allocated_cost(self.model, self.cmax, config)

    # -- provided by the stepping subclasses --------------------------------
    def _step_impl(self, rates: np.ndarray, dt: float
                   ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _reconfigure_impl(self, idx: int, cfg: JobConfig,
                          restart_s: Optional[float]) -> bool:
        raise NotImplementedError

    def inject_failure(self, idx: int) -> None:
        raise NotImplementedError

    def config_of(self, idx: int) -> JobConfig:
        raise NotImplementedError

    def workers(self) -> np.ndarray:
        raise NotImplementedError

    def caught_up(self) -> np.ndarray:
        raise NotImplementedError


@SIM_ENGINES.register("batched")
class BatchedSweepExecutor(SweepExecutorBase):
    """All scenarios advance through one vectorized NumPy ``step_batch``
    call on the host."""

    def __init__(self, model: ClusterModel, configs: Sequence[JobConfig],
                 seeds: Sequence[int], **kwargs):
        super().__init__(model, configs, seeds, **kwargs)
        self.state = BatchState.from_configs(configs)
        self.rngs = BatchedNormals(seeds)
        # Config-derived values only change on reconfiguration; cache them.
        self._cap_base = model.capacity_batch(self.state)
        self._cfg_cache = list(configs)

    def _step_impl(self, rates: np.ndarray, dt: float
                   ) -> Dict[str, np.ndarray]:
        return self.model.step_batch(self.state, rates, dt, self.rngs,
                                     capacity_base=self._cap_base)

    def inject_failure(self, idx: int) -> None:
        self.model.inject_failure_batch(self.state, idx)

    def _reconfigure_impl(self, idx: int, cfg: JobConfig,
                          restart_s: Optional[float]) -> bool:
        applied = self.model.reconfigure_batch(self.state, idx, cfg,
                                               restart_s)
        if applied:
            self._cap_base[idx] = self.model.capacity(cfg)
            self._cfg_cache[idx] = cfg
        return applied

    def config_of(self, idx: int) -> JobConfig:
        return self._cfg_cache[idx]

    def workers(self) -> np.ndarray:
        return self.state.workers

    def caught_up(self) -> np.ndarray:
        return self.state.caught_up


@SIM_ENGINES.register("scalar")
class ScalarSweepExecutor(SweepExecutorBase):
    """Reference oracle: one host SimJob per scenario, stepped in a Python
    loop."""

    def __init__(self, model: ClusterModel, configs: Sequence[JobConfig],
                 seeds: Sequence[int], **kwargs):
        super().__init__(model, configs, seeds, **kwargs)
        self.jobs = [SimJob(model, c, seed=s)
                     for c, s in zip(configs, seeds)]

    def _step_impl(self, rates: np.ndarray, dt: float
                   ) -> Dict[str, np.ndarray]:
        ms = [job.step(float(r), dt) for job, r in zip(self.jobs, rates)]
        return {k: np.array([m[k] for m in ms]) for k in ms[0]}

    def inject_failure(self, idx: int) -> None:
        self.jobs[idx].inject_failure()

    def _reconfigure_impl(self, idx: int, cfg: JobConfig,
                          restart_s: Optional[float]) -> bool:
        if self.jobs[idx].config == cfg:
            return False
        self.jobs[idx].reconfigure(cfg, restart_s=restart_s)
        return True

    def config_of(self, idx: int) -> JobConfig:
        return self.jobs[idx].config

    def workers(self) -> np.ndarray:
        return np.array([float(j.config.workers) for j in self.jobs])

    def caught_up(self) -> np.ndarray:
        return np.array([j.caught_up for j in self.jobs])
