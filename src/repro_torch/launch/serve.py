"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

The port of ``repro/launch/serve.py``. Runs the batched serving engine on a
(reduced or full) config, replays a Poisson request trace, and optionally
puts the Demeter controller in charge of the cluster configuration
(replicas / TP / KV budget / slots / snapshot interval) — the paper's
optimization loop driving an LLM fleet. Everything runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from ..configs import arch_id, get_config, smoke_config
from ..core.config_space import tpu_serving_space
from ..core.demeter import DemeterController, DemeterHyperParams
from ..core.executor import EngineConfig
from ..models import init_params
from ..serving.autoscale import (ClusterModelParams, ReplicaProfile,
                                 ServingCluster, ServingExecutor, calibrate)
from ..serving.engine import Request, ServingEngine


def run_engine(cfg, args, *, device="cuda") -> Dict[str, float]:
    """Serve ``args.requests`` Poisson arrivals (``args.rate`` per second,
    prompts of ``args.prompt_len`` tokens, ``args.max_tokens`` new tokens
    each) on ``args.slots`` slots; returns the engine's telemetry."""
    model = init_params(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, model, n_slots=args.slots,
                        max_len=args.prompt_len + args.max_tokens + 8,
                        device=device)
    rng = np.random.default_rng(0)
    t_start = time.monotonic()
    next_arrival = 0.0
    submitted = 0
    while eng.metrics.completed < args.requests:
        now = time.monotonic() - t_start
        while submitted < args.requests and now >= next_arrival:
            eng.submit(Request(
                f"req-{submitted}",
                rng.integers(0, cfg.vocab_size, args.prompt_len),
                max_tokens=args.max_tokens,
                arrival_s=time.monotonic()))
            submitted += 1
            next_arrival += rng.exponential(1.0 / args.rate)
        eng.admit()
        if eng.step() == 0:
            time.sleep(0.005)
    t = eng.telemetry()
    print(f"[serve] completed={int(t['completed'])} "
          f"p95_latency={t['p95_latency_s']:.3f}s "
          f"mean_step={t['mean_step_s']*1e3:.1f}ms")
    return t


def run_autoscaled(cfg, args, *, device="cuda",
                   profile: Optional[ReplicaProfile] = None) -> Dict:
    """Demeter over a simulated replica fleet for ``args.duration_s``
    seconds of a diurnal rate around ``args.rate``. The replica profile is
    calibrated on ``device`` from real engine steps unless one is given;
    the controller's models run on ``device`` too."""
    if profile is None:
        print("[serve] calibrating replica profile (real engine steps)...")
        profile = calibrate(cfg, n_slots=4, prompt_len=16, steps=4,
                            device=device)
    print(f"  decode_step={profile.decode_step_s*1e3:.1f}ms "
          f"prefill={profile.prefill_s*1e3:.1f}ms")
    cluster = ServingCluster(profile, ClusterModelParams())
    execu = ServingExecutor(cluster)
    space = tpu_serving_space()
    hp = DemeterHyperParams(segment_size=args.rate / 4,
                            recovery_constraint_s=120.0)
    demeter = DemeterController(space, execu, hp=hp,
                                config=EngineConfig(device=device))

    rng = np.random.default_rng(1)
    t, dt = 0.0, execu.dt
    last_obs = last_opt = last_prof = 0.0
    while t < args.duration_s:
        t += dt
        # diurnal-ish rate pattern
        rate = args.rate * (0.6 + 0.4 * np.sin(2 * np.pi * t
                                               / args.duration_s))
        rate = max(rate + rng.normal(0, args.rate * 0.05), 0.1)
        execu.step(rate)
        if t - last_obs >= 30:
            last_obs = t
            obs = execu.observe()
            if obs:
                demeter.ingest(obs)
        if t - last_prof >= 240:
            last_prof = t
            demeter.profiling_step()
        if t - last_opt >= 120:
            last_opt = t
            demeter.optimization_step()
    out = {"profile": profile, "reconfigurations": demeter.n_reconfigurations,
           "final_config": execu.current_config(),
           "final_telemetry": execu.observe(), "controller": demeter}
    print(f"[serve] demeter reconfigurations: {demeter.n_reconfigurations}")
    print(f"  final config: {out['final_config']}")
    print(f"  final telemetry: {out['final_telemetry']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=arch_id, required=True,
                    help="an id of repro_torch.configs.ARCH_IDS (any "
                         "that decodes: deepseek_moe_16b, "
                         "deepseek_v2_lite_16b, qwen2_7b, ...) or an alias "
                         "(mamba2-1.3b, zamba2-2.7b, deepseek-v2-lite)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--autoscale", action="store_true",
                    help="Demeter-controlled cluster simulation")
    ap.add_argument("--duration-s", type=float, default=3600.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.autoscale:
        run_autoscaled(cfg, args, device=args.device)
    else:
        run_engine(cfg, args, device=args.device)


if __name__ == "__main__":
    main()
