#!/usr/bin/env python3
"""Where an evaluation of the GP fit kernel's tiled body spends its cycles.

Builds ``src/repro_torch/csrc/gp_fit.cu`` with ``-DGP_FIT_STAGES`` (the
port's nvcc command, into ``build/gp_fit_stages/``): thread 0 of each CTA
then reads ``clock64`` at the source's ``STAGE_MARK``s and sums each
stage's cycles. Fits ``chip_smoke.GP_FIT_SHAPES`` with it (60 iterations)
and prints, for each shape, the slowest row's cycles per evaluation by
stage. The marks cost some tens of cycles each, so the sum runs above the
plain kernel's time. Needs an NVIDIA GPU and ``nvcc``:

    python3 scripts/gp_fit_stages.py

Stages: ``matrix`` (from the posted point's barrier: the kernel matrix
entries), ``sweep``, ``alpha`` (alpha, y.alpha, the log-determinant and
their barrier), ``grad`` (the traces and the totals), ``barrier`` (the
last one), ``value``, ``trial`` (warp 0's line-search step), ``direction``
(the two-loop recursion, once an iteration) and ``post`` (the next point
and its barrier).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "gp_fit_stages"
#: stage k ends at the source's STAGE_MARK(k + 1); the last at mark 0
STAGES = ("matrix", "sweep", "alpha", "grad", "barrier", "value", "trial",
          "direction", "post")


def main() -> int:
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gp_fit_stages: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch.core.demeter import FIT_MAX_ITER
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "libgp_fit_stages.so"
    subprocess.run([*build.nvcc_command(build.find_nvcc(),
                                        build.CSRC_DIR / "gp_fit.cu",
                                        lib_path), "-DGP_FIT_STAGES"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gp_lbfgs_launch.argtypes = build.SIGNATURES["gp_fit"][
        "gp_lbfgs_launch"]
    lib.gp_stage_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    print(c.nvidia_smi_line(), flush=True)
    for label, n_sets, seed, sizes in c.GP_FIT_SHAPES:
        datasets, seeds = c.gp_datasets(n_sets, seed, sizes)
        x, y, mask, t0s = c.fit_operands(datasets, seeds, "cuda")
        B, R, D = t0s.shape
        rows = B * R
        t0 = t0s.reshape(rows, D).contiguous()
        theta = torch.empty_like(t0)
        counts = torch.empty(rows, dtype=torch.int32, device="cuda")
        evals = torch.empty_like(counts)
        rc = lib.gp_lbfgs_launch(
            ptr(x), ptr(y), ptr(mask), ptr(t0), ptr(theta), ptr(counts),
            ptr(evals), None, rows, x.shape[1], x.shape[2], R, FIT_MAX_ITER,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        cycles = np.zeros((rows, len(STAGES)), np.uint64)
        rc = lib.gp_stage_read(cycles.ctypes.data, rows)
        if rc != 0:
            raise RuntimeError(f"reading the stages failed: CUDA error {rc}")
        j = int(np.argmax(cycles.sum(1)))
        n = float(evals[j])
        per = [float(cycles[j, (k + 1) % len(STAGES)]) / n
               for k in range(len(STAGES))]
        print(json.dumps({
            "shape": label, "n_max": x.shape[1], "row": j, "evals": n,
            "iterations": int(counts[j]), "cycles_per_eval": sum(per),
            "stages": dict(zip(STAGES, (round(v, 1) for v in per)))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
