"""Reproduce the paper's evaluation (Fig. 5/6, Table 3) on the PyTorch port.

    PYTHONPATH=src python examples/dsp_repro_torch.py --hours 3
    PYTHONPATH=src python examples/dsp_repro_torch.py --hours 18 --trace tsw
    PYTHONPATH=src python examples/dsp_repro_torch.py --device cpu

The port of ``examples/dsp_repro.py``: all four methods on the chosen
workload with failure injection every 45 minutes, through
``repro_torch.dsp.run_experiment``, printing the paper's headline numbers.
The job simulation runs on the host; Demeter's forecast bank (the
``arima_chunk`` kernel) and GP bank (``gp_lbfgs``) run on ``--device``, the
card by default (it raises without one; pass ``--device cpu``).
"""
import argparse

import numpy as np

from repro_torch.core import EngineConfig
from repro_torch.core.executor import resolve_device
from repro_torch.dsp import run_experiment, tsw_like, ysb_like


def fmt_recovery(r):
    if r is None:
        return "NR"
    if not np.isfinite(r):
        return "6m+"
    return f"{r:.0f}s"


def main(argv=None):
    """Runs the four methods; returns each one's ``RunResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=3.0)
    ap.add_argument("--trace", choices=["ysb", "tsw"], default="ysb")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of Demeter's banks: cuda (default) "
                         "or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    make = ysb_like if args.trace == "ysb" else tsw_like
    trace = make(duration_s=args.hours * 3600.0, dt_s=10.0)
    print(f"== {args.trace.upper()} experiment, {args.hours:g} h, "
          f"failures every 45 min ==")

    config = EngineConfig(device=args.device)
    results = {}
    for method in ("static", "demeter", "reactive", "ds2"):
        res = run_experiment(trace, method, seed=args.seed, config=config)
        results[method] = res
        rec = " ".join(fmt_recovery(r) for r in res.recovery_times())
        print(f"\n[{method}]")
        print(f"  latencies < 2s: {res.frac_latency_below(2.0)*100:.1f}%")
        print(f"  reconfigurations: {res.n_reconfigurations}")
        print(f"  recoveries: {rec}")
        print(f"  cpu usage: {res.cumulative_cpu_s()/3600:.0f} core-h "
              f"(profiling {res.profile_cpu_s/3600:.1f})")
        print(f"  mem usage: {res.cumulative_mem_mb_s()/3600/1024:.0f} GB-h")

    stat = results["static"]
    print("\n== vs static (net, profiling included) ==")
    for m in ("demeter", "reactive", "ds2"):
        r = results[m]
        print(f"  {m:9s} cpu {100*(1-r.cumulative_cpu_s()/stat.cumulative_cpu_s()):+5.1f}%  "
              f"mem {100*(1-r.cumulative_mem_mb_s()/stat.cumulative_mem_mb_s()):+5.1f}%")
    return results


if __name__ == "__main__":
    main()
