"""End-to-end driver on the PyTorch port: serve a small model with batched
requests, Demeter in control of the fleet configuration.

    PYTHONPATH=src python examples/serve_autoscale_torch.py [--arch qwen2_7b]
    PYTHONPATH=src python examples/serve_autoscale_torch.py --device cpu

The port of ``examples/serve_autoscale.py``. Phase 1 serves real batched
requests through the continuous-batching engine (the reduced config, real
prefill and decode steps on the kernel route: the ``decode_attention``
kernel for the dense configs, ``ssd_scan`` for mamba2/zamba2,
``grouped_matmul`` for the MoE configs). Phase 2 runs the calibrated
cluster under a diurnal load with Demeter tuning replicas / TP / KV budget
/ decode slots / snapshot interval — the paper's §2 pipeline driving an LLM
fleet. Everything runs on ``--device``, the card by default (it raises
without one; pass ``--device cpu``).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import (DemeterController, DemeterHyperParams,
                              EngineConfig, tpu_serving_space)
from repro_torch.core.executor import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (ClusterModelParams, Request, ServingCluster,
                                 ServingEngine, ServingExecutor, calibrate)


def phase1_real_engine(cfg, device: str):
    """Serve 12 requests on 4 slots of 96 positions; returns the engine."""
    print(f"== phase 1: real batched serving ({cfg.name}, reduced) ==")
    model = init_params(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, model, n_slots=4, max_len=96, device=device)
    rng = np.random.default_rng(0)
    n_requests = 12
    for i in range(n_requests):
        eng.submit(Request(f"req-{i}",
                           rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(8, 24))),
                           max_tokens=8, arrival_s=time.monotonic()))
    steps = 0
    while eng.metrics.completed < n_requests:
        eng.admit()
        if eng.step() == 0 and not eng.queue:
            break
        steps += 1
    t = eng.telemetry()
    print(f"  completed {int(t['completed'])}/{n_requests} requests in "
          f"{steps} decode steps; p95 latency {t['p95_latency_s']:.2f}s; "
          f"mean step {t['mean_step_s']*1e3:.0f} ms")
    return eng


def phase2_autoscale(cfg, hours: float, device: str):
    """Demeter over the calibrated fleet for ``hours`` simulated hours;
    returns the controller."""
    print(f"== phase 2: Demeter-controlled fleet ({hours:.1f} sim-hours) ==")
    profile = calibrate(cfg, n_slots=4, prompt_len=16, steps=4,
                        device=device)
    print(f"  calibrated: decode {profile.decode_step_s*1e3:.0f} ms/step, "
          f"prefill {profile.prefill_s*1e3:.0f} ms")
    cluster = ServingCluster(profile, ClusterModelParams())
    execu = ServingExecutor(cluster)
    demeter = DemeterController(
        tpu_serving_space(), execu,
        hp=DemeterHyperParams(segment_size=2.0, recovery_constraint_s=120.0,
                              profile_parallelism=2,
                              profile_interval_s=900.0),
        config=EngineConfig(device=device))
    rng = np.random.default_rng(1)
    dur = hours * 3600.0
    t = 0.0
    last = {"obs": 0.0, "opt": 0.0, "prof": 450.0, "fail": 0.0}
    while t < dur:
        t += execu.dt
        rate = max(6.0 + 4.0 * np.sin(2 * np.pi * t / dur)
                   + rng.normal(0, 0.3), 0.1)
        execu.step(rate)
        if t - last["obs"] >= 30:
            last["obs"] = t
            demeter.ingest(execu.observe())
        if t - last["prof"] >= 900:
            last["prof"] = t
            ran = demeter.profiling_step()
            if ran:
                print(f"  [{t/60:5.0f} min] profiled {len(ran)} configs")
        if t - last["opt"] >= 300:
            last["opt"] = t
            new = demeter.optimization_step()
            if new:
                print(f"  [{t/60:5.0f} min] reconfigured -> "
                      f"replicas={new['replicas']:.0f} "
                      f"tp={new['tp_degree']:.0f} "
                      f"slots={new['decode_slots']:.0f} "
                      f"kv={new['kv_blocks']:.0f} "
                      f"snap={new['snapshot_interval_s']:.0f}s")
        if t - last["fail"] >= 2700:     # failure every 45 min (paper)
            last["fail"] = t
            cluster.inject_failure()
    obs = execu.observe()
    print(f"  final: chips={cluster.chips():.0f}/"
          f"{cluster.model.chips_total} latency={obs['latency']:.2f}s "
          f"usage={obs['usage']:.2f} "
          f"reconfigs={demeter.n_reconfigurations}")
    return demeter


def main(argv=None):
    """Runs both phases; returns phase 1's engine and phase 2's
    controller."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_7b")
    ap.add_argument("--hours", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = smoke_config(args.arch)
    eng = phase1_real_engine(cfg, args.device)
    demeter = phase2_autoscale(cfg, args.hours, args.device)
    return eng, demeter


if __name__ == "__main__":
    main()
