"""Quickstart on the PyTorch port: Demeter optimizing a simulated Flink job.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port of ``examples/quickstart.py``: the paper's controller (TSF +
segmented MOBO/RGPE + safety buffer / efficiency threshold) against the DSP
cluster simulation on a 90-minute high-variance workload, printing every
decision it takes. The job is a host ``SimJob``; the controller's forecast
bank (ARIMA flushes: the ``arima_chunk`` kernel) and GP bank (one
``gp_lbfgs`` launch a fit), posteriors and EHVI run on ``--device``. Without
a card the default raises; pass ``--device cpu`` to run on the CPU.
"""
import argparse

from repro_torch.core import (DemeterController, DemeterHyperParams,
                              EngineConfig, paper_flink_space)
from repro_torch.core.executor import resolve_device
from repro_torch.dsp import ClusterModel, DSPExecutor, JobConfig, ysb_like


def main(argv=None):
    """Runs the loop; returns the controller."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the controller's banks: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    trace = ysb_like(duration_s=90 * 60.0, dt_s=5.0)
    execu = DSPExecutor(ClusterModel(), JobConfig(), seed=0, dt=trace.dt_s)
    hp = DemeterHyperParams(profile_parallelism=2, profile_interval_s=600.0)
    demeter = DemeterController(paper_flink_space(), execu, hp=hp,
                                config=EngineConfig(device=args.device))

    print(f"C_max = {execu.cmax_config()}")
    last_ingest = last_opt = 0.0
    last_prof = 300.0
    for i in range(int(trace.duration_s / trace.dt_s)):
        t = i * trace.dt_s
        execu.step(trace.rate_at(t))
        if t - last_ingest >= 60:
            last_ingest = t
            demeter.ingest(execu.observe())
        if t - last_prof >= hp.profile_interval_s:
            last_prof = t
            ran = demeter.profiling_step()
            if ran:
                print(f"[{t/60:5.1f} min] profiled {len(ran)} configs "
                      f"at predicted rate "
                      f"{demeter.predicted_rate():,.0f} ev/s")
        if t - last_opt >= 600:
            last_opt = t
            new = demeter.optimization_step()
            if new is not None:
                print(f"[{t/60:5.1f} min] reconfigured -> {new}")

    obs = execu.observe()
    print(f"\nfinal: config={execu.current_config()}")
    print(f"latency={obs['latency']:.2f}s usage={obs['usage']:.2f} "
          f"(1.0 = C_max) reconfigurations={demeter.n_reconfigurations}")
    print(f"profiling cost: {execu.profile_cost.cpu_s/3600:.1f} core-h")
    return demeter


if __name__ == "__main__":
    main()
