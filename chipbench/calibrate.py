"""Readings that the limits of ``correct`` are set from: for each seed,
one run of a cell at its own load with a short window, in which the fp8
control takes the program's place in the comparison that decides
``correct``, and the program's own mean gap on the same sample. All seeds
run in one process, so imports and kernel builds are paid once.

    python3 chipbench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one JSON line a seed and, last, the largest program reading and the
smallest control reading of the number compared (the mean gap). Exits
with 1 unless, on every seed, the control came out not correct and the
program within the cell's limit.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "chipbench":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from chipbench import run
    run.environment()
    import torch
    torch.set_num_threads(1)
    from chipbench import harness
    prog, ctl, ok = [], [], True
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device="cuda", control=True)
        res, got = out["result"], out["sample"]
        limit = res["checks"]["mean_logit_gap"]["limit"]
        prog.append(got["program_mean_logit_gap"])
        ctl.append(got["mean_logit_gap"])
        ok = (ok and res["correct"] is False and res["failed"] == 0
              and prog[-1] <= limit)
        print(json.dumps({"seed": seed, "control_correct": res["correct"],
                          **got, "limit": limit,
                          "metrics": res["metrics"]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(prog),
                      "program_max": max(prog), "control_min": min(ctl),
                      "program": prog, "control": ctl, "sound": ok,
                      "forbidden_modules": harness.forbidden_modules()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
