"""Queueing model of a Flink-style streaming job (the paper's §3 cluster).

The host-side model — :class:`JobConfig`, :class:`ClusterModel` with its
NumPy batch surfaces, the per-row RNG streams, :class:`BatchState` and the
one-job :class:`SimJob` that Demeter's profiling clones run — is a copy of
the reference's NumPy code, kept NumPy on purpose: every row's
``np.random.Generator`` stream must stay bit-identical to the reference's,
so the port's engines draw the same numbers the reference's engines do.

:func:`step_batch_arrays` is the device-side half of a tick in float64
torch, with every expression in the reference's order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

#: Parallelism cap (Kafka partitions / max parallelism in the paper's setup).
MAX_PARALLELISM = 24


@dataclass(frozen=True)
class JobConfig:
    """The five Demeter-tuned parameters (paper §1)."""

    workers: int = 24
    cpu_cores: int = 1
    memory_mb: int = 4096
    task_slots: int = 1
    checkpoint_interval_s: float = 10.0

    @staticmethod
    def from_dict(d: Mapping[str, float]) -> "JobConfig":
        return JobConfig(workers=int(d["workers"]),
                         cpu_cores=int(d["cpu_cores"]),
                         memory_mb=int(d["memory_mb"]),
                         task_slots=int(d["task_slots"]),
                         checkpoint_interval_s=float(d["checkpoint_interval_s"]))

    def to_dict(self) -> Dict[str, float]:
        return {"workers": float(self.workers), "cpu_cores": float(self.cpu_cores),
                "memory_mb": float(self.memory_mb),
                "task_slots": float(self.task_slots),
                "checkpoint_interval_s": float(self.checkpoint_interval_s)}


@dataclass(frozen=True)
class ClusterModel:
    """Calibration constants for the queueing/recovery model."""

    base_rate_per_core: float = 9000.0   # events/s one core/slot can push
    cpu_exponent: float = 0.85           # sub-linear core scaling within a slot
    slot_exponent: float = 0.15          # local-parallelism pipelining gain
    mem_half_mb: float = 500.0           # memory factor half-saturation point
    mem_exponent: float = 1.2
    checkpoint_cost_s: float = 1.2       # barrier cost per checkpoint
    base_latency_s: float = 0.55         # fully idle pipeline latency
    queue_gamma: float = 0.6             # latency growth with utilization
    failure_detect_s: float = 20.0       # Flink taskmanager timeout (paper §3.1)
    redeploy_s: float = 45.0             # pod re-schedule + job restart
    restore_mb_per_s: float = 600.0      # state restore bandwidth per worker
    reconfig_restart_s: float = 45.0     # savepoint + redeploy on reconfigure
    cpu_idle_frac: float = 0.35          # JVM/framework floor per allocated core
    state_per_krate_mb: float = 18.0     # state size scales with workload rate
    noise: float = 0.02                  # multiplicative capacity/latency noise
    latency_cap_s: float = 120.0

    # -- static surfaces -----------------------------------------------------
    def capacity(self, cfg: JobConfig) -> float:
        """Sustainable events/s for a configuration (pre-noise)."""
        slots_total = min(cfg.workers * cfg.task_slots, MAX_PARALLELISM)
        workers_used = min(cfg.workers, slots_total)
        slots_per_worker = slots_total / max(workers_used, 1)
        mem_per_slot = cfg.memory_mb / max(cfg.task_slots, 1)
        mem_f = 1.0 / (1.0 + (self.mem_half_mb / mem_per_slot) ** self.mem_exponent)
        per_worker = (self.base_rate_per_core
                      * cfg.cpu_cores ** self.cpu_exponent
                      * slots_per_worker ** self.slot_exponent
                      * mem_f)
        ckpt_f = 1.0 / (1.0 + self.checkpoint_cost_s
                        / max(cfg.checkpoint_interval_s, 1e-3))
        return workers_used * per_worker * ckpt_f

    def state_size_mb(self, rate: float) -> float:
        return self.state_per_krate_mb * rate / 1000.0

    def allocated_cpu(self, cfg: JobConfig) -> float:
        return cfg.workers * cfg.cpu_cores

    def allocated_mem_mb(self, cfg: JobConfig) -> float:
        return float(cfg.workers * cfg.memory_mb)

    # -- batched surfaces (the host engine's hot path) -----------------------
    def capacity_batch(self, state: "BatchState") -> np.ndarray:
        """Vectorized :meth:`capacity` over a batch of job states, operation
        for operation."""
        slots_total = np.minimum(state.workers * state.task_slots,
                                 float(MAX_PARALLELISM))
        workers_used = np.minimum(state.workers, slots_total)
        slots_per_worker = slots_total / np.maximum(workers_used, 1.0)
        mem_per_slot = state.memory_mb / np.maximum(state.task_slots, 1.0)
        mem_f = 1.0 / (1.0 + (self.mem_half_mb / mem_per_slot)
                       ** self.mem_exponent)
        per_worker = (self.base_rate_per_core
                      * state.cpu_cores ** self.cpu_exponent
                      * slots_per_worker ** self.slot_exponent
                      * mem_f)
        ckpt_f = 1.0 / (1.0 + self.checkpoint_cost_s
                        / np.maximum(state.checkpoint_interval_s, 1e-3))
        return workers_used * per_worker * ckpt_f

    def step_batch(self, state: "BatchState", rates: np.ndarray, dt: float,
                   rngs: "Sequence[BufferedNormals] | BatchedNormals",
                   capacity_base: Optional[np.ndarray] = None
                   ) -> Dict[str, np.ndarray]:
        """Advance every job in ``state`` by ``dt`` under per-job ``rates``.

        Draw order: one capacity-noise draw per job per step, then one
        latency-noise draw for each job that is up after the downtime
        decrement. ``rngs`` may be per-job scalar streams or a
        :class:`BatchedNormals` (same per-stream sequences, vectorized).
        ``capacity_base`` reuses the config-only :meth:`capacity_batch` term.
        """
        rates = np.asarray(rates, dtype=np.float64)
        batched_rng = isinstance(rngs, BatchedNormals)
        z1 = rngs.draw() if batched_rng \
            else np.array([g.standard_normal() for g in rngs])
        noise = 1.0 + self.noise * z1
        if capacity_base is None:
            capacity_base = self.capacity_batch(state)
        cap = capacity_base * np.maximum(noise, 0.5)

        down_pre = state.downtime_left_s > 0.0
        state.downtime_left_s = np.where(
            down_pre, np.maximum(state.downtime_left_s - dt, 0.0),
            state.downtime_left_s)
        since = np.where(down_pre, state.since_checkpoint_s,
                         state.since_checkpoint_s + dt)
        since = np.where(~down_pre & (since >= state.checkpoint_interval_s),
                         0.0, since)
        state.since_checkpoint_s = since

        achievable = cap * dt
        demand = rates * dt + state.lag_events
        processed = np.minimum(achievable, demand)
        state.lag_events = np.where(down_pre,
                                    state.lag_events + rates * dt,
                                    demand - processed)
        throughput = np.where(down_pre, 0.0, processed / dt)

        util = np.minimum(rates / np.maximum(cap, 1e-9), 1.5)
        down_post = state.downtime_left_s > 0.0
        if batched_rng:
            z2 = np.abs(rngs.draw(~down_post))
        else:
            z2 = np.zeros(len(rngs))
            for i in np.nonzero(~down_post)[0]:
                z2[i] = abs(rngs[i].standard_normal())
        latency = np.where(down_post, self.latency_cap_s,
                           self._latency_batch(state, rates, cap, z2))

        f = self.cpu_idle_frac
        usage_cpu = state.workers * state.cpu_cores \
            * (f + (1 - f) * np.minimum(util, 1.0))
        state_mb = self.state_per_krate_mb * rates / 1000.0
        mem_needed = state_mb / np.maximum(state.workers, 1.0) + 300.0
        mem_frac = np.minimum(0.25 + 0.75 * mem_needed
                              / np.maximum(state.memory_mb, 1.0), 1.0)
        usage_mem = state.workers * state.memory_mb * mem_frac

        state.last_rate = rates
        return {
            "rate": rates, "throughput": throughput, "capacity": cap,
            "consumer_lag": state.lag_events, "latency": latency,
            "utilization": util, "usage_cpu": usage_cpu,
            "usage_mem_mb": usage_mem, "down": down_post.astype(np.float64),
        }

    def _latency_batch(self, state: "BatchState", rates: np.ndarray,
                       cap: np.ndarray, z2: np.ndarray) -> np.ndarray:
        rho = np.minimum(rates / np.maximum(cap, 1e-9), 0.999)
        base = self.base_latency_s * (1.0 + self.queue_gamma
                                      * rho / (1.0 - rho))
        backlog_delay = state.lag_events / np.maximum(cap, 1e-9)
        mem_per_slot = state.memory_mb / np.maximum(state.task_slots, 1.0)
        gc_penalty = 0.25 * (1024.0 / mem_per_slot) ** 2 * rho
        noisy = (base + backlog_delay + gc_penalty) * (1.0 + 0.05 * z2)
        return np.minimum(noisy, self.latency_cap_s)

    def inject_failure_batch(self, state: "BatchState", i: int) -> None:
        """Timeout failure of job ``i``: detection + redeploy + state
        restore, with the events since the last checkpoint replayed as lag."""
        state_mb = self.state_size_mb(float(state.last_rate[i]))
        restore = state_mb / (self.restore_mb_per_s
                              * max(float(state.workers[i]), 1.0))
        state.downtime_left_s[i] = self.failure_detect_s \
            + self.redeploy_s + restore
        state.lag_events[i] += state.last_rate[i] * state.since_checkpoint_s[i]
        state.since_checkpoint_s[i] = 0.0

    def reconfigure_batch(self, state: "BatchState", i: int, cfg: JobConfig,
                          restart_s: Optional[float] = None) -> bool:
        """Savepoint + redeploy of job ``i`` with ``cfg``; True if applied."""
        if state.config_of(i) == cfg:
            return False
        state.set_config(i, cfg)
        state.downtime_left_s[i] = max(
            float(state.downtime_left_s[i]),
            self.reconfig_restart_s if restart_s is None else restart_s)
        state.since_checkpoint_s[i] = 0.0
        return True


def step_batch_arrays(model: ClusterModel, lag: torch.Tensor,
                      lag_add: torch.Tensor, rates: torch.Tensor,
                      workers: torch.Tensor, cpu_cores: torch.Tensor,
                      memory_mb: torch.Tensor, task_slots: torch.Tensor,
                      cap_base: torch.Tensor, down_pre: torch.Tensor,
                      down_post: torch.Tensor, z1: torch.Tensor,
                      z2: torch.Tensor, dt: float
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Functional mirror of :meth:`ClusterModel.step_batch` on float64
    tensors of shape ``[S]``.

    The control state that the NumPy path mutates in place arrives
    precomputed from the host: ``down_pre`` / ``down_post`` (each job's
    down flag before / after this tick's downtime decrement), ``lag_add``
    (rollback lag from failures injected since the last tick) and ``z1`` /
    ``z2`` (this tick's capacity / latency noise; ``z2 == 0`` on down rows).

    Every expression is the reference's, in the reference's order, so on
    the CPU the result is bit-equal to :meth:`ClusterModel.step_batch`.
    Returns ``(new_lag, metrics)`` with ``step_batch``'s metric keys.
    """
    noise = 1.0 + model.noise * z1
    cap = cap_base * torch.clamp(noise, min=0.5)

    lag0 = lag + lag_add
    achievable = cap * dt
    demand = rates * dt + lag0
    processed = torch.minimum(achievable, demand)
    new_lag = torch.where(down_pre, lag0 + rates * dt, demand - processed)
    throughput = torch.where(down_pre, 0.0, processed / dt)

    util = torch.clamp(rates / torch.clamp(cap, min=1e-9), max=1.5)
    rho = torch.clamp(rates / torch.clamp(cap, min=1e-9), max=0.999)
    base = model.base_latency_s * (1.0 + model.queue_gamma
                                   * rho / (1.0 - rho))
    backlog_delay = new_lag / torch.clamp(cap, min=1e-9)
    mem_per_slot = memory_mb / torch.clamp(task_slots, min=1.0)
    gc_penalty = 0.25 * (1024.0 / mem_per_slot) ** 2 * rho
    noisy = (base + backlog_delay + gc_penalty) * (1.0 + 0.05 * z2)
    latency = torch.where(down_post, model.latency_cap_s,
                          torch.clamp(noisy, max=model.latency_cap_s))

    f = model.cpu_idle_frac
    usage_cpu = workers * cpu_cores * (f + (1 - f) * torch.clamp(util, max=1.0))
    state_mb = model.state_per_krate_mb * rates / 1000.0
    mem_needed = state_mb / torch.clamp(workers, min=1.0) + 300.0
    mem_frac = torch.clamp(0.25 + 0.75 * mem_needed
                           / torch.clamp(memory_mb, min=1.0), max=1.0)
    usage_mem = workers * memory_mb * mem_frac

    return new_lag, {
        "rate": rates, "throughput": throughput, "capacity": cap,
        "consumer_lag": new_lag, "latency": latency,
        "utilization": util, "usage_cpu": usage_cpu,
        "usage_mem_mb": usage_mem, "down": down_post.to(torch.float64),
    }


class SupportsNormal:
    """Anything exposing ``standard_normal() -> float`` (typing aid)."""

    def standard_normal(self) -> float:  # pragma: no cover - protocol only
        raise NotImplementedError


class BufferedNormals(SupportsNormal):
    """Block-buffered view of a Generator's standard-normal stream.

    ``Generator.standard_normal(n)`` gives bit for bit the sequence of ``n``
    successive scalar draws, so buffering keeps a stream equal to its
    unbuffered self while amortizing the per-draw call."""

    __slots__ = ("rng", "_buf", "_pos")

    BLOCK = 4096

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._buf = np.empty(0)
        self._pos = 0

    def standard_normal(self) -> float:
        if self._pos >= len(self._buf):
            self._buf = self.rng.standard_normal(self.BLOCK)
            self._pos = 0
        v = self._buf[self._pos]
        self._pos += 1
        return v


class BatchedNormals:
    """Per-job standard-normal streams consumed through vectorized draws.

    Row ``i`` yields bit for bit the sequence of ``BufferedNormals(seeds[i])``
    (both consume the Generator in BLOCK-sized chunks); a batch draw is one
    fancy-indexing gather. Refills happen per exhausted row, so rows may
    advance at different paces (a down job skips its latency draw)."""

    __slots__ = ("rngs", "_buf", "_pos")

    BLOCK = BufferedNormals.BLOCK

    def __init__(self, seeds: Sequence[int]):
        self.rngs = [np.random.default_rng(s) for s in seeds]
        n = len(self.rngs)
        self._buf = np.empty((n, self.BLOCK))
        self._pos = np.full(n, self.BLOCK)

    def __len__(self) -> int:
        return len(self.rngs)

    def draw(self, mask: Optional[np.ndarray] = None) -> np.ndarray:
        """One draw from each (masked-in) stream; zeros elsewhere."""
        idx = np.arange(len(self.rngs)) if mask is None \
            else np.nonzero(mask)[0]
        for i in idx[self._pos[idx] >= self.BLOCK]:
            self._buf[i] = self.rngs[i].standard_normal(self.BLOCK)
            self._pos[i] = 0
        out = np.zeros(len(self.rngs))
        out[idx] = self._buf[idx, self._pos[idx]]
        self._pos[idx] += 1
        return out


@dataclass
class BatchState:
    """Struct-of-arrays state for a batch of simulated jobs (one row per
    sweep scenario). All arrays are float64 of shape ``[n_jobs]``.

    In the fused engine ``lag_events`` lives on the device between
    intervals (adopted back through :meth:`from_device`); the clocks and
    ``last_rate`` are advanced by the host and never read back."""

    workers: np.ndarray
    cpu_cores: np.ndarray
    memory_mb: np.ndarray
    task_slots: np.ndarray
    checkpoint_interval_s: np.ndarray
    lag_events: np.ndarray
    downtime_left_s: np.ndarray
    since_checkpoint_s: np.ndarray
    last_rate: np.ndarray

    @classmethod
    def from_configs(cls, configs: Sequence[JobConfig]) -> "BatchState":
        n = len(configs)
        return cls(
            workers=np.array([c.workers for c in configs], dtype=np.float64),
            cpu_cores=np.array([c.cpu_cores for c in configs],
                               dtype=np.float64),
            memory_mb=np.array([c.memory_mb for c in configs],
                               dtype=np.float64),
            task_slots=np.array([c.task_slots for c in configs],
                                dtype=np.float64),
            checkpoint_interval_s=np.array(
                [c.checkpoint_interval_s for c in configs], dtype=np.float64),
            lag_events=np.zeros(n), downtime_left_s=np.zeros(n),
            since_checkpoint_s=np.zeros(n), last_rate=np.zeros(n),
        )

    def __len__(self) -> int:
        return len(self.workers)

    def config_of(self, i: int) -> JobConfig:
        return JobConfig(
            workers=int(self.workers[i]), cpu_cores=int(self.cpu_cores[i]),
            memory_mb=int(self.memory_mb[i]),
            task_slots=int(self.task_slots[i]),
            checkpoint_interval_s=float(self.checkpoint_interval_s[i]))

    def set_config(self, i: int, cfg: JobConfig) -> None:
        self.workers[i] = cfg.workers
        self.cpu_cores[i] = cfg.cpu_cores
        self.memory_mb[i] = cfg.memory_mb
        self.task_slots[i] = cfg.task_slots
        self.checkpoint_interval_s[i] = cfg.checkpoint_interval_s

    def from_device(self, lag: torch.Tensor) -> None:
        """Adopt the device's consumer-lag buffer as a host copy (the device
        buffer is updated in place by the next interval, so the mirror must
        never alias it)."""
        self.lag_events = lag.detach().to("cpu", copy=True).numpy()

    @property
    def caught_up(self) -> np.ndarray:
        return (self.downtime_left_s <= 0.0) & (self.lag_events < 1.0)


@dataclass
class SimJob:
    """One running streaming job: queueing state + failure machinery."""

    model: ClusterModel
    config: JobConfig
    seed: int = 0
    time_s: float = 0.0
    lag_events: float = 0.0              # consumer lag (backlog)
    downtime_left_s: float = 0.0         # restart in progress when > 0
    since_checkpoint_s: float = 0.0
    rng: np.random.Generator = field(init=False)
    #: telemetry of the last step
    last: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------
    def step(self, rate: float, dt: float) -> Dict[str, float]:
        """Advance the job by ``dt`` seconds under arrival ``rate`` (ev/s)."""
        self.time_s += dt
        noise = 1.0 + self.model.noise * self.rng.standard_normal()
        cap = self.model.capacity(self.config) * max(noise, 0.5)

        if self.downtime_left_s > 0:
            # Job down: nothing processed, lag accumulates.
            self.downtime_left_s = max(self.downtime_left_s - dt, 0.0)
            self.lag_events += rate * dt
            throughput = 0.0
        else:
            self.since_checkpoint_s += dt
            if self.since_checkpoint_s >= self.config.checkpoint_interval_s:
                self.since_checkpoint_s = 0.0
            # Process arrivals plus as much backlog as capacity allows.
            achievable = cap * dt
            demand = rate * dt + self.lag_events
            processed = min(achievable, demand)
            self.lag_events = demand - processed
            throughput = processed / dt

        util = min(rate / max(cap, 1e-9), 1.5)
        latency = self._latency(rate, cap, dt)
        usage_cpu, usage_mem = self._usage(util, rate)
        self.last = {
            "rate": rate, "throughput": throughput, "capacity": cap,
            "consumer_lag": self.lag_events, "latency": latency,
            "utilization": util, "usage_cpu": usage_cpu,
            "usage_mem_mb": usage_mem, "down": float(self.downtime_left_s > 0),
        }
        return self.last

    def _latency(self, rate: float, cap: float, dt: float) -> float:
        if self.downtime_left_s > 0:
            return self.model.latency_cap_s
        rho = min(rate / max(cap, 1e-9), 0.999)
        base = self.model.base_latency_s * (1.0 + self.model.queue_gamma
                                            * rho / (1.0 - rho))
        backlog_delay = self.lag_events / max(cap, 1e-9)
        mem_per_slot = self.config.memory_mb / max(self.config.task_slots, 1)
        gc_penalty = 0.25 * (1024.0 / mem_per_slot) ** 2 * rho
        noisy = (base + backlog_delay + gc_penalty) \
            * (1.0 + 0.05 * abs(self.rng.standard_normal()))
        return float(min(noisy, self.model.latency_cap_s))

    def _usage(self, util: float, rate: float) -> tuple:
        m = self.model
        f = m.cpu_idle_frac
        cpu = m.allocated_cpu(self.config) * (f + (1 - f) * min(util, 1.0))
        state = m.state_size_mb(rate)
        mem_needed = state / max(self.config.workers, 1) + 300.0
        mem_frac = min(0.25 + 0.75 * mem_needed
                       / max(self.config.memory_mb, 1.0), 1.0)
        mem = m.allocated_mem_mb(self.config) * mem_frac
        return float(cpu), float(mem)

    # ------------------------------------------------------------------
    def inject_failure(self) -> None:
        """Timeout failure: detection + redeploy + state restore + replay."""
        m = self.model
        state = m.state_size_mb(self.last.get("rate", 0.0))
        restore = state / (m.restore_mb_per_s * max(self.config.workers, 1))
        self.downtime_left_s = m.failure_detect_s + m.redeploy_s + restore
        # Rollback: events since the last checkpoint are replayed => lag.
        self.lag_events += self.last.get("rate", 0.0) * self.since_checkpoint_s
        self.since_checkpoint_s = 0.0

    def reconfigure(self, config: JobConfig,
                    restart_s: Optional[float] = None) -> None:
        """Savepoint + redeploy with the new configuration."""
        if config == self.config:
            return
        self.config = config
        self.downtime_left_s = max(
            self.downtime_left_s,
            self.model.reconfig_restart_s if restart_s is None else restart_s)
        self.since_checkpoint_s = 0.0

    @property
    def caught_up(self) -> bool:
        return self.downtime_left_s <= 0 and self.lag_events < 1.0


def measure_recovery(job: SimJob, rate_fn, t0: float, dt: float,
                     timeout_s: float = 360.0) -> Optional[float]:
    """Ground-truth recovery time: failure onset -> caught back up to the
    head of the queue (paper §2.3's definition). None = exceeded timeout."""
    job.inject_failure()
    t = 0.0
    while t < timeout_s:
        t += dt
        job.step(rate_fn(t0 + t), dt)
        if job.caught_up:
            return t
    return None
