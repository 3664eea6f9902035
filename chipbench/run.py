"""Run one cell of the port's benchmark once, on the card.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(``python3 -m chipbench.run`` works too.) It runs from the root of a
checkout, puts ``src/`` on the path, keeps every build and kernel cache
under ``build/`` in the checkout, and prints the result as the last line
of standard output and the compared numbers beside their limits as the
last lines of standard error. Without a card, or with fewer than the cell
asks for, it exits with 2 and prints no result; it never falls back to
the CPU. A run that has loaded JAX or the reference package ``repro``
exits with 4 and prints no result.
"""
import time

START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, Python puts chipbench/ first on the path, where its
# modules would shadow the standard library's: the checkout's root instead
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "chipbench":
    sys.path[0] = str(ROOT)


def environment() -> None:
    """Fixed cache directories inside the checkout, and one host thread
    for the CPU's own operator pools (the host only dispatches to the card;
    idle pool threads spinning on a shared machine's cores slow it)."""
    build = ROOT / "build" / "chipbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(build / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}; known: {sorted(chips)}",
              file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from chipbench import harness
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           chips=chips[args.workload], t0=START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no module of JAX or of the reference "
              f"package may run here", file=sys.stderr)
        return 4
    print(json.dumps(out["result"]), flush=True)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
