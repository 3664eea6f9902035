#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU, run in turns A, B,
B, A so that the card and its host are shared alike. Each run times:

- the GP fit kernel ``gp_lbfgs`` alone, one launch a fit of 60 iterations,
  at this checkout's ``chip_smoke.GP_FIT_SHAPES`` (the same inputs for
  both checkouts): device time a launch, evaluations a row and
  microseconds an evaluation;
- the baseline sweep (``chip_smoke.py`` phase 4);
- the Demeter main path (phase 6).

Each run is a fresh process started in the checkout's root, which imports
that checkout's own ``chip_smoke`` and builds that checkout's kernels. The
lines each run prints (sweep walls, the Demeter path's layer walls and
launch counts, the fit kernel's times) are printed here under a ``== run i
label`` header, and each run's whole output is written to
``build/compare/<i>_<label>.log`` under the directory this script is run
from.

    python3 chip_compare.py PARENT_CHECKOUT [THIS_CHECKOUT]
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

RUN = r'''
import json, sys, time
sys.path[:0] = [".", "src"]
import torch
if not torch.cuda.is_available():
    sys.exit("chip_compare: torch.cuda.is_available() is False")
torch.set_num_threads(1)
import chip_smoke as c
from repro_torch.kernels import build
GP_FIT_SHAPES = {shapes!r}
for name in build.build_all(["fused_tick", "rls_update", "gp_fit"]):
    build.load(name)
print(c.nvidia_smi_line(), flush=True)
from repro_torch.core.demeter import FIT_MAX_ITER
from repro_torch.kernels.gp_fit import gp_lbfgs
for label, n_sets, seed, sizes in GP_FIT_SHAPES:
    datasets, seeds = c.gp_datasets(n_sets, seed, tuple(sizes))
    x, y, mask, t0s = c.fit_operands(datasets, seeds, "cuda")
    B, R, D = t0s.shape
    t0 = t0s.reshape(B * R, D)
    fit = lambda: gp_lbfgs(x, y, mask, t0, restarts=R, max_iter=FIT_MAX_ITER)
    _, counts, evals = fit()
    ms = c.device_ms(fit, n=5, warmup=1, host_n=3)
    per_row = float(evals.float().mean())
    print("gp_fit " + json.dumps({{
        "shape": label, "members": B, "restarts": R, "n_max": x.shape[1],
        "ms": ms, "evals_per_row": per_row, "evals_max": int(evals.max()),
        "us_per_eval": ms * 1e3 / per_row,
        "iterations_max": int(counts.max())}}), flush=True)
t0 = time.perf_counter()
c.baseline_path()
print("baseline phase s", time.perf_counter() - t0, flush=True)
t0 = time.perf_counter()
c.demeter_main_path(c.DEMETER_SEEDS)
print("demeter phase s", time.perf_counter() - t0, flush=True)
'''


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"A": Path(argv[1]).resolve(),
             "B": Path(argv[2] if len(argv) == 3 else ".").resolve()}
    for label, tree in trees.items():
        if not (tree / "chip_smoke.py").is_file():
            print(f"chip_compare: {tree} ({label}) holds no chip_smoke.py",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import GP_FIT_SHAPES
    run = RUN.format(shapes=GP_FIT_SHAPES)
    out = Path("build") / "compare"
    out.mkdir(parents=True, exist_ok=True)
    rc = 0
    for i, label in enumerate("ABBA"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", run], cwd=trees[label],
                           capture_output=True, text=True)
        (out / f"{i}_{label}.log").write_text(
            r.stdout + "\n--- stderr ---\n" + r.stderr)
        print(f"== run {i} {label} ({trees[label]}) rc {r.returncode} "
              f"wall {time.perf_counter() - t0:.1f} s", flush=True)
        for line in r.stdout.splitlines():
            if not line.startswith("table3"):
                print(line, flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
