"""Sweep demo on the PyTorch port: a multi-scenario grid in one run.

    PYTHONPATH=src python examples/dsp_sweep_torch.py
    PYTHONPATH=src python examples/dsp_sweep_torch.py --hours 2 --verify
    PYTHONPATH=src python examples/dsp_sweep_torch.py --device cpu --verify

The port of ``examples/dsp_sweep.py``: builds a (trace class x controller x
seed) grid, executes it as a single vectorized run, and prints a
per-scenario digest. ``--verify`` replays the same grid through the scalar
engine (one host ``SimJob`` per scenario) and checks step-for-step
equivalence; a mismatch exits non-zero.

One default differs from the reference's: ``--engine`` is the port's
``EngineConfig`` default, ``fused``, which on the card runs each decision
interval as one launch of the ``fused_interval`` kernel (the reference's
default is the NumPy ``batched`` engine, which the port also has).
Everything runs on ``--device``, the card by default (it raises without
one; pass ``--device cpu``).
"""
import argparse
import sys
from dataclasses import replace

from repro_torch.core import FORECASTER_KINDS, EngineConfig
from repro_torch.core.executor import resolve_device
from repro_torch.dsp import (PeriodicFailures, make_trace, run_sweep,
                             scenario_grid)


def main(argv=None):
    """Runs the grid (and with ``--verify`` its scalar replay); returns
    the grid's ``SweepResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=1.0)
    ap.add_argument("--traces", default="diurnal,flash,regime",
                    help="comma-separated trace classes")
    ap.add_argument("--controllers", default="static,reactive,ds2")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--forecast-backend", choices=("bank", "scalar"),
                    default="bank",
                    help="Demeter TSF path: shared batched ForecastBank "
                         "or per-scenario NumPy oracle")
    ap.add_argument("--forecasters", default="arima",
                    help="comma-separated forecaster kinds "
                         f"({','.join(FORECASTER_KINDS)}), cycled across "
                         "scenarios")
    ap.add_argument("--engine",
                    choices=("batched", "scalar", "sharded", "fused"),
                    default=EngineConfig.sim_backend,
                    help="simulation engine; 'fused' (default) runs whole "
                         "decision intervals in one kernel launch on the "
                         "card, 'batched' is the NumPy host engine, "
                         "'sharded' lays the scenario axis over a device "
                         "mesh (needs >= 2 devices)")
    ap.add_argument("--devices", type=int, default=None,
                    help="scenario-mesh width (default: all visible)")
    ap.add_argument("--verify", action="store_true",
                    help="also run the scalar oracle and check equivalence")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    traces = [make_trace(k, duration_s=args.hours * 3600.0, dt_s=5.0)
              for k in args.traces.split(",")]
    controllers = args.controllers.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    specs = scenario_grid(traces, controllers, seeds,
                          failures=PeriodicFailures(45 * 60.0))
    kinds = args.forecasters.split(",")
    if kinds != ["arima"]:
        specs = [replace(s, forecaster=kinds[i % len(kinds)])
                 for i, s in enumerate(specs)]
    print(f"== sweep: {len(specs)} scenarios, {args.hours:g} h each, "
          f"failures every 45 min ==")

    config = EngineConfig(sim_backend=args.engine, devices=args.devices,
                          forecast_backend=args.forecast_backend,
                          device=args.device)
    res = run_sweep(specs, config=config)
    print(f"{res.engine} engine: {res.wall_s:.2f} s wall for "
          f"{res.n_steps} steps x {len(specs)} scenarios\n")

    print(f"{'scenario':28s} {'p50 lat':>8s} {'<2s':>7s} "
          f"{'mean lag':>10s} {'reconf':>6s}")
    for sc in res.scenarios:
        s = sc.summary()
        print(f"{s['name']:28s} {s['latency_p50_s']:8.2f} "
              f"{s['frac_latency_below_2s']:7.1%} "
              f"{s['mean_consumer_lag']:10.0f} {s['n_reconfigurations']:6d}")

    if args.verify:
        ref = run_sweep(specs, config=config.replace(sim_backend="scalar"))
        ok = all(a.allclose(b)
                 for a, b in zip(res.scenarios, ref.scenarios))
        print(f"\nscalar oracle: {ref.wall_s:.2f} s wall -> "
              f"speedup {ref.wall_s / max(res.wall_s, 1e-9):.2f}x, "
              f"equivalence {'OK' if ok else 'MISMATCH'}")
        if not ok:
            sys.exit(1)
    return res


if __name__ == "__main__":
    main()
