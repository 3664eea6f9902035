"""Two sets of runs of one cell, the same seeds in both, and the spreads
that the bounds of its end-to-end metrics are set from; then its traced
runs.

    python3 chipbench/sets.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--traced <n> ...] [--out <dir>]

Each run is ``chipbench/run.py`` in a process of its own, one after
another; its standard output and error go to ``<out>/<workload>.<set>.
<seed>.out`` and ``.err``. A line a run, then a line a metric: each set's
spread (the distance between the first and third quartile of
``statistics.quantiles(values, n=4)`` over the median), the wider of the
two, the mean of the two with each set's run farthest from its median
left out, and how far set B's median lies from set A's. Exits with 1 if a
run exited with another code than 0 or was not correct.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def run(workload, seed, seconds, trace, stem: Path):
    t0 = time.monotonic()
    with open(f"{stem}.out", "w") as out, open(f"{stem}.err", "w") as err:
        rc = subprocess.call(
            [sys.executable, "chipbench/run.py", "--workload", workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(trace)], cwd=ROOT, stdout=out, stderr=err)
    lines = Path(f"{stem}.out").read_text().strip().splitlines()
    res = json.loads(lines[-1]) if rc == 0 and lines else None
    print(json.dumps({"run": stem.name, "rc": rc,
                      "wall_s": time.monotonic() - t0, "result": res}),
          flush=True)
    return res if res and res["correct"] else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    sets, bad = {}, 0
    for name in ("A", "B"):
        sets[name] = []
        for seed in args.seeds:
            res = run(args.workload, seed, args.seconds, 0,
                      out / f"{args.workload}.{name}.{seed}")
            bad += res is None
            if res:
                sets[name].append(res["metrics"])
    for seed in args.traced:
        bad += run(args.workload, seed, args.seconds, 1,
                   out / f"{args.workload}.T.{seed}") is None
    names = sets["A"][0] if sets["A"] else {}
    for metric in names:
        v = {s: [m[metric]["value"] for m in rows if metric in m]
             for s, rows in sets.items()}
        if min(len(x) for x in v.values()) < 3:
            continue
        each = {s: spread(x) for s, x in v.items()}
        print(json.dumps({
            "metric": metric, "spread": each, "wider": max(each.values()),
            "tight": statistics.mean(spread(without_farthest(x))
                                     for x in v.values()),
            "medians": {s: statistics.median(x) for s, x in v.items()},
            "b_against_a": statistics.median(v["B"])
            / statistics.median(v["A"]) - 1}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
