"""The fleet controller: a continuous Demeter loop over many jobs.

One :class:`FleetController` runs the paper's §2 loop (TSF -> segments ->
MOBO/RGPE -> SB/ET/C_max) as a *service* over thousands of concurrently
registered jobs, instead of one offline sweep:

* each job binds a scalar :class:`~repro_torch.core.executor.Executor` (a
  :class:`~repro_torch.core.executor.ScenarioView` over a shared sim grid,
  a :class:`~repro_torch.dsp.executor.DSPExecutor`, the serving
  :class:`~repro_torch.serving.autoscale.ServingExecutor`, ...) plus its
  :class:`~repro_torch.core.config_space.ConfigSpace`;
* per-job forecaster and detector state lives in ONE shared
  :class:`~repro_torch.core.forecast_bank.ForecastBank` /
  :class:`~repro_torch.core.forecast_bank.DetectorBank` slab on
  ``EngineConfig.device``, advanced by one batched call per epoch whatever
  the fleet's size (on the card: one launch of K1's ``arima_chunk`` per
  forecast-bank chunk and one per detector sample); departed jobs' slots
  are returned to their just-constructed state in one ``reset_rows``
  scatter per bank before reuse;
* GP model updates across every due controller go through ONE
  :meth:`~repro_torch.core.demeter.ModelBank.batch_refresh` call per epoch;
* cold jobs (fewer than :attr:`FleetConfig.cold_start_min_obs` observed
  epochs) degrade gracefully to a domain-agnostic hold/revert baseline
  until their bank rows carry enough signal to warm a
  :class:`~repro_torch.core.demeter.DemeterController`.

Decisions are reproducible under a fixed seed: every iteration order is
row-sorted, slot assignment is a min-heap, and the bounded decision log
carries a running sha256 digest over canonical JSON, so two same-seed runs
(on the card and on the CPU too) can be compared without retaining every
entry.
"""
from __future__ import annotations

import collections
import hashlib
import heapq
import json
from dataclasses import dataclass
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .. import obs
from ..core.config_space import ConfigSpace
from ..core.demeter import DemeterController, ModelBank
from ..core.executor import EngineConfig, Executor
from ..core.forecast_bank import DetectorBank, ForecastBank
from ..core.latency import LatencyConstraint
from .ingest import (DEFAULT_LATENESS_S, DEFAULT_QUEUE_CAP, INGEST_KEYS,
                     IngestBuffer)

#: Epoch cadence matching the paper's metric window (§3.2).
EPOCH_S = 60.0

#: Cold-start overload guard: revert to C_max above this utilization.
COLD_UTIL_REVERT = 0.9


@dataclass(frozen=True)
class FleetConfig:
    """Service-level knobs (the Demeter knobs live in ``EngineConfig.hp``)."""

    #: maximum concurrent jobs (the bank/ingest slab size, fixed at boot)
    capacity: int = 1024
    #: seconds of service time per epoch (the paper's metric window)
    epoch_s: float = EPOCH_S
    #: optimization cadence in epochs (10 x 60 s = the paper's 600 s)
    opt_every: int = 10
    #: profiling cadence in epochs (25 x 60 s = the paper's 1500 s)
    profile_every: int = 25
    #: run the profiling process at all (loadgen soaks turn it off)
    profiling: bool = True
    #: epochs of telemetry before a job graduates from the cold baseline
    cold_start_min_obs: int = 5
    #: per-job ingest queue bound (backpressure threshold)
    queue_cap: int = DEFAULT_QUEUE_CAP
    #: late-telemetry allowance behind the drained epoch boundary
    lateness_s: float = DEFAULT_LATENESS_S
    #: TSF forecaster kind for every job's bank row
    forecaster: str = "arima"
    #: bounded decision-log ring length (the digest covers ALL decisions)
    decision_log_cap: int = 4096
    #: service seed (folded into per-job derived state)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.epoch_s <= 0:
            raise ValueError("epoch_s must be positive")
        if self.opt_every < 1 or self.profile_every < 1:
            raise ValueError("opt_every / profile_every must be >= 1")


@dataclass
class JobState:
    """One registered job's service-side state."""

    job_id: str
    row: int                       # shared bank/ingest slot
    executor: Executor
    space: ConfigSpace
    backend: str
    lc: LatencyConstraint
    registered_epoch: int
    epochs_observed: int = 0
    ctl: Optional[DemeterController] = None
    anomalous: bool = False
    last_decision: Optional[Dict] = None

    @property
    def policy(self) -> str:
        return "demeter" if self.ctl is not None else "cold"


class FleetController:
    """Epoch-driven Demeter service over a fleet of jobs.

    The banks, the ingest reduce and every warm controller's GP work live
    on ``config.device``; ``config=None`` is ``EngineConfig()``, whose
    device is the card (it raises where there is none: pass
    ``EngineConfig(device="cpu")``).
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 fleet: Optional[FleetConfig] = None):
        self.config = config if config is not None else EngineConfig()
        self.fleet = fleet if fleet is not None else FleetConfig()
        device = self.config.device
        cap = self.fleet.capacity
        self.hp = self.config.resolved_hp()
        self.ingest = IngestBuffer(cap, keys=INGEST_KEYS,
                                   queue_cap=self.fleet.queue_cap,
                                   lateness_s=self.fleet.lateness_s,
                                   device=device)
        self.bank = ForecastBank.from_kinds(
            [self.fleet.forecaster] * cap,
            horizon=self.hp.forecast_horizon, device=device)
        self.detector = DetectorBank(cap, device=device)
        self._free: List[int] = list(range(cap))   # min-heap: deterministic
        heapq.heapify(self._free)                  # lowest-slot reuse
        self._jobs: Dict[str, JobState] = {}
        self._row_job: Dict[int, str] = {}
        #: slots freed since the last epoch; their bank rows are returned to
        #: the just-constructed state in ONE batched scatter per epoch
        self._pending_reset: set = set()
        #: shared allocated-cost vectors, keyed by cost-model identity
        self._alloc_cache: Dict[Tuple, np.ndarray] = {}
        self.epoch = 0
        self.now_s = 0.0
        self.decision_log: Deque[Dict] = collections.deque(
            maxlen=self.fleet.decision_log_cap)
        self._log_digest = hashlib.sha256()
        self.n_decisions = 0
        self.n_reconfigurations = 0
        self.n_registered = 0
        self.n_deregistered = 0
        self.n_warmed = 0
        self.n_anomalies = 0

    # ------------------------------------------------------------------
    # registration churn
    # ------------------------------------------------------------------
    def register_job(self, job_id: str, executor: Executor,
                     space: ConfigSpace, *, backend: str = "sim") -> int:
        """Bind a job to a free slot; returns the slot (bank row)."""
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} is already registered")
        if not self._free:
            raise RuntimeError(
                f"fleet is at capacity ({self.fleet.capacity} jobs); "
                f"deregister a job or boot with a larger FleetConfig")
        row = heapq.heappop(self._free)
        self.ingest.clear_row(row)
        self._jobs[job_id] = JobState(
            job_id=job_id, row=row, executor=executor, space=space,
            backend=backend, lc=LatencyConstraint(),
            registered_epoch=self.epoch)
        self._row_job[row] = job_id
        self.n_registered += 1
        obs.inc("fleet.registers")
        return row

    def deregister_job(self, job_id: str) -> None:
        job = self._jobs.pop(job_id, None)
        if job is None:
            raise ValueError(f"unknown job {job_id!r}")
        del self._row_job[job.row]
        self.ingest.clear_row(job.row)
        self._pending_reset.add(job.row)
        heapq.heappush(self._free, job.row)
        self.n_deregistered += 1
        obs.inc("fleet.deregisters")

    def job(self, job_id: str) -> JobState:
        try:
            return self._jobs[job_id]
        except KeyError:
            raise ValueError(f"unknown job {job_id!r}") from None

    @property
    def n_jobs(self) -> int:
        return len(self._jobs)

    # ------------------------------------------------------------------
    # telemetry ingress
    # ------------------------------------------------------------------
    def report_telemetry(self, job_id: str, t: float,
                         metrics: Mapping[str, float]) -> bool:
        """Queue one telemetry sample (host-side; nothing on the device)."""
        return self.ingest.offer(self.job(job_id).row, t, metrics)

    # ------------------------------------------------------------------
    # the epoch loop
    # ------------------------------------------------------------------
    def run_epoch(self) -> Dict[str, int]:
        """One service epoch: batched state maintenance + due decisions.

        Bank resets, the telemetry reduce, the forecast flush, the detector
        step and the GP refresh are each ONE batched call for the whole
        fleet, never one per job.
        """
        self.epoch += 1
        self.now_s += self.fleet.epoch_s
        with obs.timed_phase("fleet", "fleet.epoch", epoch=self.epoch,
                             jobs=len(self._jobs)):
            summary = self._run_epoch_inner()
        if obs.enabled():
            obs.inc("fleet.epochs")
            obs.inc("fleet.decisions", summary["decisions"])
        return summary

    def _run_epoch_inner(self) -> Dict[str, int]:
        # 1) return freed slots' bank rows to pristine state (one scatter
        #    per bank; rows may already be re-bound to new jobs: their
        #    telemetry only flushes after this point, so no signal is lost).
        if self._pending_reset:
            rows = sorted(self._pending_reset)
            self.bank.reset_rows(rows)
            self.detector.reset_rows(rows)
            self._pending_reset.clear()

        jobs = sorted(self._jobs.values(), key=lambda j: j.row)

        # 2) drain the ingest queues: ONE reduce for the fleet.
        means, counts = self.ingest.drain(self.now_s)
        ikey = {k: i for i, k in enumerate(self.ingest.keys)}

        # 3) stage observed rates, then apply them in ONE bank flush;
        #    latency constraints are tiny host rings, updated inline.
        observed: List[JobState] = []
        for job in jobs:
            r = job.row
            if not counts[r].any():
                continue
            rate = means[r, ikey["rate"]]
            lat = means[r, ikey["latency"]]
            if np.isfinite(rate):
                self.bank.stage(r, float(rate))
            if np.isfinite(lat):
                job.lc.observe(float(lat))
            job.epochs_observed += 1
            observed.append(job)
        self.bank.flush()

        # 4) ONE detector call over the latency plane: service-level
        #    anomaly flags (surfaced via recommend()/stats()).
        lat_col = means[:, ikey["latency"]]
        active = np.zeros(self.fleet.capacity, bool)
        for job in observed:
            active[job.row] = np.isfinite(lat_col[job.row])
        flags = self.detector.observe(np.nan_to_num(lat_col), active=active)
        for job in jobs:
            job.anomalous = bool(flags[job.row])
            if job.anomalous:
                self.n_anomalies += 1

        # 5) graduate cold jobs whose bank rows carry enough signal.
        for job in jobs:
            if job.ctl is None and \
                    job.epochs_observed >= self.fleet.cold_start_min_obs:
                self._warm_up(job)

        # 6) decisions. Cold jobs run their reactive guard every epoch
        #    (the 60 s baseline cadence); warm controllers optimize on the
        #    staggered opt_every cadence. All due warm controllers refresh
        #    their GP models through ONE ModelBank.batch_refresh call first.
        decided_before = self.n_decisions
        due_warm = [job for job in jobs
                    if job.ctl is not None and self._due(job)]
        if due_warm:
            ModelBank.batch_refresh([job.ctl.bank for job in due_warm])
        for job in jobs:
            if job.ctl is None:
                self._decide_cold(
                    job, self._epoch_metrics(job, means, counts, ikey))
        for job in due_warm:
            self._decide_warm(
                job, self._epoch_metrics(job, means, counts, ikey))
        return {"epoch": self.epoch, "jobs": len(jobs),
                "observed": len(observed),
                "decisions": self.n_decisions - decided_before,
                "warm": sum(1 for j in jobs if j.ctl is not None)}

    def _due(self, job: JobState) -> bool:
        # Stagger decision epochs across slots so a fully loaded fleet
        # spreads its per-job host work evenly instead of spiking every
        # opt_every epochs.
        return (self.epoch + job.row) % self.fleet.opt_every == 0

    def _epoch_metrics(self, job: JobState, means: np.ndarray,
                       counts: np.ndarray, ikey: Dict[str, int]
                       ) -> Dict[str, float]:
        if not counts[job.row].any():
            return {}
        out = {}
        for k in self.ingest.keys:
            v = means[job.row, ikey[k]]
            if np.isfinite(v):
                out[k] = float(v)
        return out

    # -- policies -----------------------------------------------------------
    def _warm_up(self, job: JobState) -> None:
        job.ctl = DemeterController(
            job.space, job.executor, tsf=self.bank.view(job.row),
            lc=job.lc, forecaster=self.fleet.forecaster, config=self.config,
            alloc=self._shared_alloc(job))
        self.n_warmed += 1
        obs.inc("fleet.warmups")

    def _shared_alloc(self, job: JobState) -> np.ndarray:
        """One allocated-cost vector per cost-model identity.

        ``allocated_cost`` is deterministic in (space, cost model, C_max),
        so jobs sharing those (the whole loadgen fleet) share one scan of
        the configuration space instead of |space| calls per warm-up.
        """
        ex = job.executor
        model = getattr(ex, "model", None)
        if model is None:
            batch = getattr(ex, "batch", None)      # ScenarioView
            model = getattr(batch, "model", None)
        if model is None:
            model = getattr(ex, "cluster", None)    # ServingExecutor
        key = (id(job.space), type(ex).__name__, id(model),
               tuple(sorted(ex.cmax_config().items())))
        alloc = self._alloc_cache.get(key)
        if alloc is None:
            alloc = np.asarray([ex.allocated_cost(c)
                                for c in job.space.enumerate()])
            self._alloc_cache[key] = alloc
        return alloc

    def _decide_cold(self, job: JobState, metrics: Mapping[str, float]
                     ) -> None:
        """Graceful degradation before the banks carry signal: hold the
        current configuration; revert to C_max on overload (detector flag,
        latency above the job's constraint, or saturated utilization)."""
        current = job.executor.current_config()
        cmax = job.executor.cmax_config()
        lat = metrics.get("latency", float("nan"))
        util = metrics.get("utilization", metrics.get("usage", float("nan")))
        overload = job.anomalous \
            or (np.isfinite(lat) and not job.lc.is_normal(lat)) \
            or (np.isfinite(util) and util > COLD_UTIL_REVERT)
        if overload and current != cmax:
            job.executor.reconfigure(cmax)
            self.n_reconfigurations += 1
            self._log_decision(job, cmax, "cold-revert")

    def _decide_warm(self, job: JobState, metrics: Mapping[str, float]
                     ) -> None:
        ctl = job.ctl
        assert ctl is not None
        if self.fleet.profiling and \
                (self.epoch + job.row) % self.fleet.profile_every == 0:
            with obs.timed_phase("fleet", "fleet.profile", job=job.job_id):
                ctl.profiling_step()
        before = ctl.n_reconfigurations
        new = ctl.optimization_step(metrics=metrics or None)
        if ctl.n_reconfigurations > before:
            self.n_reconfigurations += ctl.n_reconfigurations - before
            reason = ctl.events[-1][1]["reason"] if ctl.events else "opt"
        else:
            reason = "hold"
        self._log_decision(job, new, reason)

    # -- decision log --------------------------------------------------------
    def _log_decision(self, job: JobState, action: Optional[Mapping],
                      reason: str) -> None:
        entry = {"epoch": self.epoch, "job": job.job_id, "row": job.row,
                 "policy": job.policy, "reason": reason,
                 "action": dict(action) if action is not None else None}
        self.decision_log.append(entry)
        # The ring is bounded; the digest covers EVERY decision ever made,
        # so same-seed runs compare bit for bit without unbounded memory.
        self._log_digest.update(
            json.dumps(entry, sort_keys=True).encode())
        self.n_decisions += 1
        job.last_decision = entry

    def decision_digest(self) -> str:
        """sha256 over every decision so far (canonical JSON per entry)."""
        return self._log_digest.hexdigest()

    # ------------------------------------------------------------------
    # read surface
    # ------------------------------------------------------------------
    def recommend(self, job_id: str) -> Dict:
        """The service's current verdict for one job."""
        job = self.job(job_id)
        return {"job_id": job_id, "policy": job.policy,
                "config": job.executor.current_config(),
                "anomalous": job.anomalous,
                "epochs_observed": job.epochs_observed,
                "last_decision": job.last_decision}

    def stats(self) -> Dict:
        return {
            "epoch": self.epoch, "now_s": self.now_s,
            "jobs": len(self._jobs), "capacity": self.fleet.capacity,
            "free_slots": len(self._free),
            "warm": sum(1 for j in self._jobs.values()
                        if j.ctl is not None),
            "decisions": self.n_decisions,
            "reconfigurations": self.n_reconfigurations,
            "registered": self.n_registered,
            "deregistered": self.n_deregistered,
            "warmups": self.n_warmed,
            "anomalies": self.n_anomalies,
            "decision_digest": self.decision_digest(),
            "ingest": {
                "accepted": self.ingest.accepted,
                "drained": self.ingest.drained,
                "dropped_late": self.ingest.dropped_late,
                "dropped_overflow": self.ingest.dropped_overflow,
                "out_of_order": self.ingest.out_of_order,
                "max_queue_depth": self.ingest.max_queue_depth(),
            },
        }
