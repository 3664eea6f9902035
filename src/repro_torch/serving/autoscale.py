"""Demeter <-> serving integration: the serving analogue of the Flink executor.

The port of ``repro/serving/autoscale.py``. A :class:`ServingCluster`
models a fleet of replicas; each replica's decode throughput and latency
come from *measured* single-replica engine behaviour (`calibrate()` times
real steps of the port's engine on its device), and the
cluster-level queueing/recovery dynamics reuse the same analytic forms as the
DSP substrate (they are the same physics: arrivals, service capacity,
backlog, restart, catch-up). Demeter tunes:

    replicas           <- paper's "workers"
    tp_degree          <- "CPU cores"     (chips per replica)
    kv_blocks          <- "memory"        (cache budget -> max batch)
    decode_slots       <- "task slots"    (concurrent sequences)
    snapshot_interval  <- "checkpoint interval" (engine state snapshots)

so the whole §2 pipeline (TSF -> segments -> MOBO/RGPE -> SB/ET/C_max)
drives a model-serving fleet unchanged.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.anomaly import RecoveryTracker
from ..core.segments import LATENCY, RECOVERY, USAGE
from ..models import init_params
from ..models.config import ModelConfig
from .engine import Request, ServingEngine


@dataclass(frozen=True)
class ReplicaProfile:
    """Measured single-replica characteristics (real engine timings)."""
    decode_step_s: float          # one batched decode step wall time
    prefill_s: float              # one prompt prefill wall time
    base_slots: int               # slots used during calibration


def calibrate(cfg: ModelConfig, *, n_slots: int = 8, prompt_len: int = 32,
              steps: int = 8, seed: int = 0, device="cuda") -> ReplicaProfile:
    """Time real prefill/decode steps of a model of ``cfg`` (random weights
    from ``seed``) on ``device``: the card unless the caller passes
    ``device="cpu"``. The first decode step is a warm-up (it builds the
    decode kernel on first use) and is not timed."""
    model = init_params(cfg, seed=seed, device=device)
    eng = ServingEngine(cfg, model, n_slots=n_slots,
                        max_len=prompt_len + 64, device=device)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else lambda: None)
    rng = np.random.default_rng(seed)
    for i in range(n_slots):
        eng.submit(Request(f"cal-{i}",
                           rng.integers(0, cfg.vocab_size, prompt_len),
                           max_tokens=steps + 2, arrival_s=0.0))
    sync()
    t0 = time.monotonic()
    eng.admit()
    sync()
    prefill_s = (time.monotonic() - t0) / n_slots
    eng.step()  # warm-up
    sync()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    sync()
    decode_step_s = (time.monotonic() - t0) / steps
    return ReplicaProfile(decode_step_s, prefill_s, n_slots)


@dataclass
class ClusterModelParams:
    """Analytic cluster dynamics on top of the measured replica profile."""
    chips_total: int = 128
    restart_s: float = 30.0           # replica restart (reload + warmup)
    snapshot_cost_frac: float = 0.015  # throughput tax per snapshot second
    tp_efficiency: float = 0.7        # sub-linear TP speedup exponent
    tokens_per_request: float = 64.0


@dataclass
class ServingCluster:
    """Queueing model of a replica fleet grounded in measured step times."""

    profile: ReplicaProfile
    model: ClusterModelParams = field(default_factory=ClusterModelParams)
    config: Dict[str, float] = field(default_factory=lambda: {
        "replicas": 8, "tp_degree": 4, "kv_blocks": 8192,
        "decode_slots": 64, "snapshot_interval_s": 30.0})
    backlog: float = 0.0
    downtime_left_s: float = 0.0
    seed: int = 0
    _rng: np.random.Generator = field(init=False)
    last: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    # -- capacity surface -----------------------------------------------------
    def capacity_rps(self, cfg: Optional[Mapping[str, float]] = None) -> float:
        c = dict(self.config if cfg is None else cfg)
        slots = min(c["decode_slots"], c["kv_blocks"] / 64.0)
        tp_speed = c["tp_degree"] ** self.model.tp_efficiency
        step_s = self.profile.decode_step_s \
            * (slots / self.profile.base_slots) ** 0.35 / tp_speed
        tokens_per_s = slots / step_s
        snap_tax = 1.0 / (1.0 + self.model.snapshot_cost_frac
                          / max(c["snapshot_interval_s"], 1.0) * 100.0)
        return (c["replicas"] * tokens_per_s
                / self.model.tokens_per_request * snap_tax)

    def chips(self, cfg: Optional[Mapping[str, float]] = None) -> float:
        c = dict(self.config if cfg is None else cfg)
        return c["replicas"] * c["tp_degree"]

    # -- dynamics ---------------------------------------------------------------
    def step(self, rate_rps: float, dt: float) -> Dict[str, float]:
        # One config snapshot for the whole step: capacity, generation time
        # and KV pressure must all describe the SAME configuration. Reading
        # ``self.config`` separately per term let a concurrent/interleaved
        # reconfigure (or any future cfg-parameterized step) silently mix
        # one config's capacity with another's gen_s/kv_frac.
        c = dict(self.config)
        cap = self.capacity_rps(c) * (1.0 + 0.02 * self._rng.standard_normal())
        if self.downtime_left_s > 0:
            self.downtime_left_s = max(self.downtime_left_s - dt, 0.0)
            self.backlog += rate_rps * dt
            served = 0.0
        else:
            demand = rate_rps * dt + self.backlog
            served = min(cap * dt, demand)
            self.backlog = demand - served
        rho = min(rate_rps / max(cap, 1e-9), 1.5)
        ttft = self.profile.prefill_s + self.backlog / max(cap, 1e-9)
        gen_s = (self.model.tokens_per_request
                 * self.profile.decode_step_s
                 / c["tp_degree"] ** self.model.tp_efficiency)
        latency = min(ttft + gen_s / (1.0 - min(rho, 0.99)) * 0.5 + gen_s,
                      120.0)
        kv_frac = min(c["kv_blocks"] * 64.0
                      / max(c["decode_slots"] * 2048.0, 1.0), 1.0)
        usage = 0.5 * self.chips(c) / self.model.chips_total \
            * (0.4 + 0.6 * min(rho, 1.0)) \
            + 0.5 * self.chips(c) / self.model.chips_total * kv_frac
        self.last = {"rate": rate_rps, "throughput": served / dt,
                     "consumer_lag": self.backlog, "latency": latency,
                     "utilization": rho, "usage": usage}
        return self.last

    def inject_failure(self) -> None:
        """Lose one replica: restart + re-snapshot + catch up."""
        c = self.config
        replay = c["snapshot_interval_s"] / 2.0
        self.downtime_left_s = self.model.restart_s
        self.backlog += self.last.get("rate", 0.0) * replay / \
            max(c["replicas"], 1)

    def reconfigure(self, cfg: Mapping[str, float]) -> None:
        if dict(cfg) == dict(self.config):
            return
        old_replicas = self.config["replicas"]
        self.config = dict(cfg)
        # Rolling reconfigure: proportional partial downtime.
        scale = abs(cfg["replicas"] - old_replicas) / max(old_replicas, 1)
        self.downtime_left_s = max(self.downtime_left_s,
                                   10.0 + 20.0 * min(scale, 1.0))

    @property
    def caught_up(self) -> bool:
        return self.downtime_left_s <= 0 and self.backlog < 1.0


@dataclass
class ServingExecutor:
    """Demeter Executor over a ServingCluster (same contract as DSP)."""

    cluster: ServingCluster
    space_cmax: Dict[str, float] = field(default_factory=lambda: {
        "replicas": 16, "tp_degree": 8, "kv_blocks": 8192,
        "decode_slots": 64, "snapshot_interval_s": 10.0})
    dt: float = 5.0
    #: fixed-size telemetry ring (600 s at the default dt) — a long-running
    #: service must not grow per-step state without bound
    _window: Deque[Dict[str, float]] = field(
        default_factory=lambda: collections.deque(maxlen=120))

    def step(self, rate: float) -> Dict[str, float]:
        m = self.cluster.step(rate, self.dt)
        self._window.append(m)
        return m

    # Executor protocol ----------------------------------------------------
    def cmax_config(self) -> Dict[str, float]:
        return dict(self.space_cmax)

    def current_config(self) -> Dict[str, float]:
        return dict(self.cluster.config)

    def reconfigure(self, config: Mapping[str, float]) -> None:
        self.cluster.reconfigure(config)

    def observe(self) -> Dict[str, float]:
        if not self._window:
            return {}
        w = list(self._window)[-12:]
        return {"rate": float(np.mean([m["rate"] for m in w])),
                "latency": float(np.mean([m["latency"] for m in w])),
                "usage": float(np.mean([m["usage"] for m in w]))}

    def allocated_cost(self, config: Mapping[str, float]) -> float:
        return (self.cluster.chips(config)
                / max(self.cluster.chips(self.space_cmax), 1e-9))

    def profile(self, configs, rate):
        out = []
        for i, cfg in enumerate(configs):
            out.append(self._profile_one(dict(cfg), rate, i))
        return out

    def _profile_one(self, cfg, rate, idx):
        clone = ServingCluster(self.cluster.profile, self.cluster.model,
                               config=dict(cfg), seed=self.cluster.seed
                               * 997 + idx)
        tracker = RecoveryTracker()
        t, lat, usage = 0.0, [], []
        while t < 120.0:
            t += self.dt
            m = clone.step(rate, self.dt)
            tracker.observe(t, {"throughput": m["throughput"],
                                "consumer_lag": m["consumer_lag"]})
            if t > 60.0:
                lat.append(m["latency"])
                usage.append(m["usage"])
        clone.inject_failure()
        t_fail, recovery = t, 360.0
        while t - t_fail < 360.0:
            t += self.dt
            m = clone.step(rate, self.dt)
            tracker.observe(t, {"throughput": m["throughput"],
                                "consumer_lag": m["consumer_lag"]})
            if tracker.last_recovery_s is not None and clone.caught_up:
                recovery = t - t_fail
                break
        return {USAGE: float(np.mean(usage)), LATENCY: float(np.mean(lat)),
                RECOVERY: float(recovery)}
