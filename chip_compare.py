#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU: the baseline sweep
(``chip_smoke.py`` phase 4) and the Demeter main path (phase 6) of each,
run in turns A, B, B, A so that the card and its host are shared alike.

Each run is a fresh process started in the checkout's root, which imports
that checkout's own ``chip_smoke`` and builds that checkout's kernels. The
lines each run prints (sweep walls, the Demeter path's layer walls and
launch counts) are printed here under a ``== run i label`` header, and
each run's whole output is written to ``build/compare/<i>_<label>.log``
under the directory this script is run from.

    python3 chip_compare.py PARENT_CHECKOUT [THIS_CHECKOUT]
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

RUN = r'''
import sys, time
sys.path[:0] = [".", "src"]
import torch
if not torch.cuda.is_available():
    sys.exit("chip_compare: torch.cuda.is_available() is False")
torch.set_num_threads(1)
import chip_smoke as c
from repro_torch.kernels import build
for name in build.build_all(["fused_tick", "rls_update"]):
    build.load(name)
print(c.nvidia_smi_line(), flush=True)
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
    out = Path("build") / "compare"
    out.mkdir(parents=True, exist_ok=True)
    rc = 0
    for i, label in enumerate("ABBA"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", RUN], cwd=trees[label],
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
