"""Verify every registered backend's contract in the PyTorch port.

Imports the port's backend-defining modules (which attach their probe
factories to the registries — see
:meth:`repro_torch.core.registry.Registry.attach_contract`), then
enumerates ``SIM_ENGINES`` / ``FIT_BACKENDS`` / ``FORECAST_BACKENDS`` /
``DETECTOR_BACKENDS`` / ``FLEET_BACKENDS`` of :mod:`repro_torch` and runs
each entry's :class:`~repro_torch.analysis.contracts.ContractProbe` on
``--device`` through :func:`~repro_torch.analysis.contracts.run_probe`. A
registered entry *without* a contract is itself a failure: new backends
cannot skip the analyzer.

Exit code 0 when every contract holds; 1 otherwise. Run as::

    PYTHONPATH=src python scripts/check_contracts_torch.py --device cpu
    PYTHONPATH=src python scripts/check_contracts_torch.py   # on the card

``--seed-violation`` registers a backend that breaks three invariants at
once (an ``.item()`` inside the call, a float64 output under a float32
ceiling, state rebound instead of updated in place) and must turn the exit
code red, proving the checker can fail.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))


def registries():
    """The port's five registries, populated with entries and contracts."""
    import repro_torch.core.anomaly          # noqa: F401
    import repro_torch.core.demeter          # noqa: F401
    import repro_torch.core.forecast_bank    # noqa: F401
    import repro_torch.dsp.executor          # noqa: F401
    import repro_torch.dsp.fused             # noqa: F401
    import repro_torch.fleet.api             # noqa: F401
    from repro_torch.core.registry import (DETECTOR_BACKENDS, FIT_BACKENDS,
                                           FLEET_BACKENDS, FORECAST_BACKENDS,
                                           SIM_ENGINES)
    return (SIM_ENGINES, FIT_BACKENDS, FORECAST_BACKENDS, DETECTOR_BACKENDS,
            FLEET_BACKENDS)


def seed_violation() -> None:
    """Register a backend that must fail: a host read inside the call, a
    float64 output under a float32 ceiling, and state rebound instead of
    updated in place."""
    import torch

    from repro_torch.analysis.contracts import (CompilationContract,
                                                ContractProbe)
    from repro_torch.core.registry import SIM_ENGINES

    def probe(device: str = "cuda"):
        state = {"acc": torch.zeros(4, dtype=torch.float32, device=device)}

        def bad_step(x):
            scale = x.sum().item()                  # a host read
            state["acc"] = state["acc"] + x         # rebound, not in place
            return x.to(torch.float64) * scale      # float64 output

        contract = CompilationContract(
            name="engine:seeded-violation", in_place=("acc",),
            dtype_ceiling="float32", forbid_host_sync=True,
            note="synthetic contract breaker (--seed-violation)")
        return ContractProbe(
            contract=contract, fn=bad_step,
            args=(torch.ones(4, dtype=torch.float32, device=device),),
            state=state, device=device)

    SIM_ENGINES.register("seeded-violation", object())
    SIM_ENGINES.attach_contract("seeded-violation", probe)


def check_all(device: str, only=None, out=print):
    """Run every registered entry's probes on ``device``; returns the
    reports (a missing contract or a probe that raised is a failed
    report)."""
    from repro_torch.analysis.contracts import ContractReport, run_probe

    reports = []
    for reg in registries():
        for name in reg:
            label = f"{reg.kind}:{name}"
            if only is not None and only not in label:
                continue
            if not reg.has_contract(name):
                reports.append(ContractReport(
                    name=label, ok=False, note="no contract attached"))
                out(f"FAIL {label}: registered without a contract (attach "
                    f"one with {type(reg).__name__}.attach_contract)")
                continue
            t0 = time.perf_counter()
            try:
                probes = reg.contract_for(name)(device)
                probes = probes if isinstance(probes, list) else [probes]
            except Exception as e:       # building the probe blew up
                reports.append(ContractReport(
                    name=label, ok=False,
                    note=f"probe factory raised {type(e).__name__}: {e}",
                    seconds=time.perf_counter() - t0))
                out(f"FAIL {reports[-1].summary()}")
                continue
            for probe in probes:
                t1 = time.perf_counter()
                try:
                    report = run_probe(probe)
                except Exception as e:   # the call itself blew up
                    report = ContractReport(
                        name=probe.contract.name or label, ok=False,
                        note=f"probe raised {type(e).__name__}: {e}")
                report.seconds = time.perf_counter() - t1
                reports.append(report)
                out(f"{'ok  ' if report.ok else 'FAIL'} {report.summary()}")
                if report.note and report.ok:
                    out(f"       {report.note}")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the probes run: cuda (default) or cpu")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the per-contract reports as JSON")
    ap.add_argument("--seed-violation", action="store_true",
                    help="register a deliberately broken backend; the run "
                         "must exit non-zero")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="check only entries whose '<kind>:<name>' label "
                         "contains SUBSTR")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("--device cuda needs a CUDA device; pass --device cpu")
            return 1
    if args.seed_violation:
        registries()
        seed_violation()
    reports = check_all(args.device, args.only)
    failed = sum(not r.ok for r in reports)

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"ok": failed == 0, "device": args.device,
             "reports": [r.to_dict() for r in reports]}, indent=2) + "\n")
        print(f"wrote {args.json}")

    print(f"{len(reports) - failed}/{len(reports)} contracts hold")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
