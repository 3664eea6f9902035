"""Closed-loop load generator: soak the fleet service at scale.

Replays the sweep grid's workload generators
(:data:`repro_torch.dsp.workloads.TRACE_GENERATORS`) plus failure schedules
as thousands of synthetic jobs against one :class:`FleetController`:

* ONE :class:`~repro_torch.dsp.executor.BatchedSweepExecutor` simulates
  every job (vectorized NumPy stepping on the host); each job binds to its
  row through a :class:`~repro_torch.core.executor.ScenarioView`;
* telemetry is sampled from the batched digest a few times per epoch and
  *delivered* through ``report_telemetry`` with seeded lateness and
  reordering, exercising the ingestion path's out-of-order handling;
* a seeded fraction of jobs churns every few epochs (deregister + fresh
  registration on the freed slot: the bank ``reset_rows`` path);
* failures inject on a periodic cadence.

Everything is deterministic under ``SoakConfig.seed``: :func:`run_soak`
run twice with the same config gives the same decision digest, on the
card and on the CPU alike. The fleet's banks and ingest reduce live on
``EngineConfig.device``, the card by default. Run standalone::

    PYTHONPATH=src python -m repro_torch.fleet.loadgen --jobs 1000 \\
        --epochs 8 --bench fleet_bench.json --trace-out fleet_trace.json
    PYTHONPATH=src python -m repro_torch.fleet.loadgen --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import obs
from ..core.config_space import paper_flink_space
from ..core.executor import EngineConfig, ScenarioView
from ..dsp.executor import BatchedSweepExecutor
from ..dsp.simulator import ClusterModel, JobConfig
from ..dsp.workloads import (TRACE_GENERATORS, PeriodicFailures, Trace,
                             make_trace)
from .service import FleetConfig, FleetController


@dataclass(frozen=True)
class SoakConfig:
    """One deterministic soak run."""

    n_jobs: int = 1000
    epochs: int = 8
    seed: int = 0
    #: simulation resolution (seconds per vectorized sim step)
    dt_s: float = 15.0
    #: telemetry deliveries per job per epoch
    samples_per_epoch: int = 4
    #: fraction of deliveries held back one epoch (late, in-allowance)
    late_frac: float = 0.1
    #: fraction of deliveries delayed past the lateness bound (dropped)
    lost_frac: float = 0.02
    #: every this many epochs, churn a batch of jobs (0 disables)
    churn_every: int = 3
    #: fraction of the fleet churned per churn event
    churn_frac: float = 0.01
    #: failure cadence per 7th job. The paper injects every 45 simulated
    #: minutes; soaks cover minutes, not hours, so the default compresses
    #: the cadence to keep recovery paths exercised.
    failure_interval_s: float = 150.0
    #: run the (expensive) profiling process inside the soak
    profiling: bool = False

    def __post_init__(self) -> None:
        if self.n_jobs < 1 or self.epochs < 1:
            raise ValueError("n_jobs and epochs must be >= 1")
        if not 0 <= self.late_frac <= 1 or not 0 <= self.lost_frac <= 1:
            raise ValueError("late_frac/lost_frac must be in [0, 1]")


def _job_traces(cfg: SoakConfig, duration_s: float) -> List[Trace]:
    kinds = sorted(TRACE_GENERATORS)
    return [make_trace(kinds[i % len(kinds)], duration_s=duration_s,
                       dt_s=cfg.dt_s, seed=cfg.seed * 31 + i)
            for i in range(cfg.n_jobs)]


def run_soak(cfg: SoakConfig,
             engine: Optional[EngineConfig] = None) -> Dict:
    """Drive one seeded soak; returns stats and the decision digest.

    ``engine=None`` is ``EngineConfig()``, whose device is the card (it
    raises where there is none: pass ``EngineConfig(device="cpu")``)."""
    t_wall = time.perf_counter()
    fleet = FleetController(
        config=engine,
        fleet=FleetConfig(capacity=cfg.n_jobs, profiling=cfg.profiling,
                          seed=cfg.seed))
    epoch_s = fleet.fleet.epoch_s
    duration_s = cfg.epochs * epoch_s
    steps_per_epoch = max(int(round(epoch_s / cfg.dt_s)), 1)
    n_steps = cfg.epochs * steps_per_epoch

    model = ClusterModel()
    start = JobConfig()                       # C_max (paper §3.2)
    ex = BatchedSweepExecutor(
        model, [start] * cfg.n_jobs,
        seeds=[cfg.seed * 31 + i for i in range(cfg.n_jobs)],
        dt=cfg.dt_s, n_steps=n_steps, device=fleet.config.device)
    traces = _job_traces(cfg, duration_s)
    space = paper_flink_space()
    fail_times = {
        i: PeriodicFailures(cfg.failure_interval_s).times(duration_s)
        for i in range(cfg.n_jobs) if i % 7 == 0}

    serial = cfg.n_jobs                        # next fresh job number
    row_jobs: Dict[int, str] = {}              # sim row -> live job id
    for i in range(cfg.n_jobs):
        job_id = f"job-{i:05d}"
        fleet.register_job(job_id, ScenarioView(ex, i), space,
                           backend="sim")
        row_jobs[i] = job_id

    #: deliveries deferred to a later epoch: (deliver_at_epoch, delivery).
    #: +1 epoch stays inside the lateness allowance (accepted late);
    #: +3 epochs lands behind the watermark (rejected, counted dropped).
    deferred: List[Dict] = []
    n_delivered = n_held = n_lost = n_failures = n_churned = 0
    t = 0.0
    for epoch in range(1, cfg.epochs + 1):
        rng = np.random.default_rng(cfg.seed * 9176 + epoch)
        # -- simulate one epoch, injecting scheduled failures ---------------
        sample_marks = {steps_per_epoch * (k + 1) // cfg.samples_per_epoch
                        for k in range(cfg.samples_per_epoch)}
        deliveries: List[Dict] = []
        for s in range(1, steps_per_epoch + 1):
            t_next = t + cfg.dt_s
            for row, times in fail_times.items():
                if np.any((times > t) & (times <= t_next)):
                    ex.inject_failure(row)
                    n_failures += 1
            t = t_next
            ex.step(np.asarray([tr.rate_at(t) for tr in traces]))
            if s in sample_marks:
                digest = ex.observe()
                for row, job_id in row_jobs.items():
                    deliveries.append({
                        "job_id": job_id, "t": t,
                        "metrics": {k: float(digest[k][row])
                                    for k in ("rate", "latency", "usage")}})
        # -- deliver telemetry: seeded lateness + reordering ----------------
        still_deferred: List[Dict] = []
        for d in deferred:                     # earlier epochs' stragglers
            if d["at"] > epoch:
                still_deferred.append(d)
            elif d["job_id"] in row_jobs.values():   # survived any churn
                if fleet.report_telemetry(d["job_id"], d["t"],
                                          d["metrics"]):
                    n_delivered += 1
                else:
                    n_lost += 1                # behind the watermark
        deferred = still_deferred
        u = rng.random(len(deliveries))
        order = rng.permutation(len(deliveries))   # out-of-order delivery
        for j in order:
            d, roll = deliveries[j], u[j]
            if roll < cfg.lost_frac:
                deferred.append({**d, "at": epoch + 3})
            elif roll < cfg.lost_frac + cfg.late_frac:
                deferred.append({**d, "at": epoch + 1})
                n_held += 1
            else:
                fleet.report_telemetry(**d)
                n_delivered += 1
        # -- churn: deregister a seeded batch, register replacements --------
        if cfg.churn_every and epoch % cfg.churn_every == 0:
            n_out = max(int(cfg.churn_frac * cfg.n_jobs), 1)
            live = sorted(row_jobs)
            picks = [live[int(k)] for k in
                     rng.choice(len(live), size=n_out, replace=False)]
            for row in picks:
                fleet.deregister_job(row_jobs.pop(row))
                job_id = f"job-{serial:05d}"
                serial += 1
                fleet.register_job(job_id, ScenarioView(ex, row), space,
                                   backend="sim")
                row_jobs[row] = job_id
                n_churned += 1
        summary = fleet.run_epoch()
    wall_s = time.perf_counter() - t_wall

    stats = fleet.stats()
    return {
        "config": {"n_jobs": cfg.n_jobs, "epochs": cfg.epochs,
                   "seed": cfg.seed, "profiling": cfg.profiling},
        "wall_s": wall_s,
        "decision_digest": fleet.decision_digest(),
        "decisions": stats["decisions"],
        "last_epoch": summary,
        "delivered": n_delivered, "held_late": n_held, "lost": n_lost,
        "failures": n_failures, "churned": n_churned,
        "sim_steps": n_steps,
        "decisions_per_s": stats["decisions"] / max(wall_s, 1e-9),
        "ingest_samples_per_s": stats["ingest"]["accepted"]
        / max(wall_s, 1e-9),
        "scenario_steps_per_s": cfg.n_jobs * n_steps / max(wall_s, 1e-9),
        "stats": stats,
    }


def _device_name(device: str) -> str:
    """The card's name for a CUDA ``device``, else ``"cpu"``."""
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _bench_leg(cfg: SoakConfig, result: Dict, device: str) -> Dict:
    return obs.make_leg(
        engine="torch-fleet-sim", devices=1, seed=cfg.seed, mode="soak",
        scenarios=cfg.n_jobs, epochs=cfg.epochs,
        device=_device_name(device),
        wall_s=round(result["wall_s"], 3),
        decisions_per_s=round(result["decisions_per_s"], 2),
        ingest_samples_per_s=round(result["ingest_samples_per_s"], 1),
        scenario_steps_per_s=round(result["scenario_steps_per_s"], 1))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="soak the fleet controller with synthetic jobs")
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--churn-every", type=int, default=3)
    ap.add_argument("--late-frac", type=float, default=0.1)
    ap.add_argument("--profiling", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the banks and the ingest reduce run "
                         "(default cuda; cpu to run without a card)")
    ap.add_argument("--bench", default=None, metavar="PATH",
                    help="merge a repro.bench/1 'fleet_soak' leg into PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the soak")
    args = ap.parse_args(argv)

    cfg = SoakConfig(n_jobs=args.jobs, epochs=args.epochs, seed=args.seed,
                     churn_every=args.churn_every, late_frac=args.late_frac,
                     profiling=args.profiling)
    if args.trace_out:
        obs.enable()
    result = run_soak(cfg, EngineConfig(device=args.device))
    print(f"soak: {cfg.n_jobs} jobs x {cfg.epochs} epochs on {args.device} "
          f"in {result['wall_s']:.2f}s — {result['decisions']} decisions "
          f"({result['decisions_per_s']:.1f}/s), "
          f"{result['ingest_samples_per_s']:.0f} samples/s, "
          f"digest {result['decision_digest'][:16]}")
    print(f"  churned={result['churned']} failures={result['failures']} "
          f"late={result['held_late']} lost={result['lost']} "
          f"warm={result['stats']['warm']}")
    if args.bench:
        obs.merge_bench(args.bench, "fleet_soak",
                        [_bench_leg(cfg, result, args.device)],
                        params={"samples_per_epoch": cfg.samples_per_epoch,
                                "churn_every": cfg.churn_every,
                                "profiling": cfg.profiling})
        print(f"merged fleet_soak leg into {args.bench}")
    if args.trace_out:
        obs.write_chrome_trace(args.trace_out)
        print(f"wrote {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
