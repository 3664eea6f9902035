#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each of which exits non-zero on failure:

1. environment: torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``); requires compute capability 9.0 (Hopper);
2. build: compiles every kernel of the path from ``src/repro_torch/csrc``;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at several row counts (the main path's included), with CUDA-event times;
4. main path: ``SweepEngine``/``run_sweep`` over a baseline-controller grid
   (traces ysb and tsw x static/reactive/ds2 x seeds 0-47 = 288 scenarios,
   the paper's 18 h at dt = 5 s, a failure every 45 minutes) on the fused
   engine on the card, then on the NumPy batched engine and the fused
   engine on the CPU; every scenario must agree with the batched engine at
   rtol 1e-9, the detector triggers with the CPU run's, and the kernel must
   have launched once per tick stepped.

The last three lines of standard output are the ``nvidia-smi`` line, the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py            # from the root of a checkout
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NoReturn

REPO = Path(__file__).resolve().parent

#: H100 SXM data sheet: HBM3 bandwidth and float64 rate outside the tensor
#: cores (the kernels here do scalar float64 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

#: Row counts the kernel phase checks; 288 is the main path's scenario count.
KERNEL_ROWS = (3, 37, 288, 65_536)
MAIN_PATH_ROWS = 288
LAM, THRESH, DT = 0.995, 3.0, 5.0
#: float64 operations per row of one fused tick, counted from
#: csrc/fused_tick.cu (log1p counted as one): lag update 7, prediction and
#: error 5, flag 2, Pphi 6, quadratic form and denominator 4, gains 2,
#: weights 4, covariance 12.
FUSED_TICK_OPS_PER_ROW = 42


def fail(msg: str) -> NoReturn:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 60, warmup: int = 10) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, in ms.

    Before each call a sleep kernel holds the stream while the host
    enqueues the call between its pair of events, so the events measure
    the device's work and not the host's dispatch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = host_ms(fn) * 1e-3
    # at most ~2 GHz: this many cycles outlast twice the host's enqueue time
    cycles = int(4e9 * host_s) + 200_000
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(fn, n: int = 100) -> float:
    """Mean wall time per call of ``fn`` when called back to back, in ms
    (what a caller on the host waits: dispatch included)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def tick_operands(n: int, seed: int, device):
    """Random fused-tick operands shaped like the main path's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = dict(lag=rng.uniform(0.0, 1e5, n), lag_add=rng.uniform(0.0, 1e4, n),
             rates=rng.uniform(1e4, 9e4, n), cap=rng.uniform(1e4, 8e4, n),
             down_pre=rng.random(n) < 0.3, w=rng.normal(size=(n, 2)) * 0.1,
             P=np.broadcast_to(10.0 * np.eye(2), (n, 2, 2)).copy(),
             y_prev=rng.uniform(0.0, 12.0, n))
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


def check_fused_tick(n: int) -> dict:
    """The CUDA fused tick against its plain version on ``n`` rows."""
    import torch
    from repro_torch.kernels import fused_tick as kmod
    from repro_torch.kernels.ref import fused_tick_ref
    ops = tick_operands(n, seed=n, device="cuda")
    got = kmod.fused_tick(**ops, lam=LAM, thresh=THRESH, dt=DT)
    torch.cuda.synchronize()
    want = fused_tick_ref(**ops, lam=LAM, thresh=THRESH, dt=DT)
    if not torch.equal(got[0], want[0]):
        fail(f"fused_tick B={n}: new_lag differs from the plain version "
             f"(max {float((got[0] - want[0]).abs().max())})")
    for g, r, name in zip(got[1:4], want[1:4], ("w'", "P'", "err")):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12,
                                   msg=f"fused_tick B={n}: {name}")
    if not torch.equal(got[4], want[4]):
        fail(f"fused_tick B={n}: flag differs from the plain version")
    max_err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, want))
    n_bytes = sum(t.numel() * t.element_size() for t in ops.values()) \
        + sum(t.numel() * t.element_size() for t in got)
    bound_bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = FUSED_TICK_OPS_PER_ROW * n / FP64_OPS_PER_S * 1e3
    return {
        "rows": n, "max_abs_err": max_err, "bytes": n_bytes,
        "ms": device_ms(lambda: kmod.fused_tick(**ops, lam=LAM,
                                                thresh=THRESH, dt=DT)),
        "plain_ms": device_ms(lambda: fused_tick_ref(**ops, lam=LAM,
                                                     thresh=THRESH, dt=DT)),
        "dispatch_ms": host_ms(lambda: kmod.fused_tick(**ops, lam=LAM,
                                                       thresh=THRESH, dt=DT)),
        "plain_dispatch_ms": host_ms(lambda: fused_tick_ref(
            **ops, lam=LAM, thresh=THRESH, dt=DT)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
    }


def largest_rel_diff(a, b) -> float:
    import numpy as np
    worst = 0.0
    for sa, sb in zip(a.scenarios, b.scenarios):
        for f in ("rates", "latencies", "usage_cpu", "usage_mem_mb",
                  "workers", "consumer_lag"):
            x, y = getattr(sa, f), getattr(sb, f)
            d = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            worst = max(worst, float(np.max(d, initial=0.0)))
    return worst


def check_result(res, n_scenarios: int, n_steps: int) -> None:
    """The repo's own checks on a sweep result: shapes and finite values."""
    import numpy as np
    if len(res.scenarios) != n_scenarios or res.n_steps != n_steps:
        fail(f"{res.engine}: {len(res.scenarios)} scenarios x "
             f"{res.n_steps} steps, expected {n_scenarios} x {n_steps}")
    for s in res.scenarios:
        for f in ("rates", "latencies", "usage_cpu", "usage_mem_mb",
                  "workers", "consumer_lag"):
            a = getattr(s, f)
            if a.shape != (n_steps,) or not np.all(np.isfinite(a)):
                fail(f"{res.engine} {s.name}: {f} is not {n_steps} finite "
                     f"values")
        if not s.failures:
            fail(f"{res.engine} {s.name}: no failure was injected")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch ({e}); run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import EngineConfig
    from repro_torch.dsp import SweepEngine, paper_grid
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_tick as kmod

    # -- 1. environment ------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    print(f"card: {name}  capability {cap}  nvidia-smi: {smi}", flush=True)
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build("fused_tick")
    build.load("fused_tick")
    print(f"build: fused_tick in {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(REPO)}")
    log = lib.with_suffix(".log")
    if log.exists():
        print("ptxas: " + " | ".join(
            ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln), flush=True)

    # -- 3. kernels against their plain versions -----------------------------
    rows = {}
    for n in KERNEL_ROWS:
        rows[n] = r = check_fused_tick(n)
        print("kernel fused_tick " + json.dumps(r), flush=True)

    # -- 4. the main path ----------------------------------------------------
    seeds = range(MAIN_PATH_ROWS // 6)
    specs = paper_grid(controllers=("static", "reactive", "ds2"),
                       seeds=seeds, trace_kinds=("ysb", "tsw"))
    S = len(specs)
    runs = {}
    for label, config in (
            ("fused-cuda", EngineConfig(sim_backend="fused", device="cuda")),
            ("batched", EngineConfig(sim_backend="batched", device="cpu")),
            ("fused-cpu", EngineConfig(sim_backend="fused", device="cpu"))):
        eng = SweepEngine(specs, config=config)
        if label == "fused-cuda":
            kmod.fused_tick.launches = 0
        res = eng.run()
        if label == "fused-cuda":
            launches = kmod.fused_tick.launches
            ticks_stepped = eng.executor.step_index + 1
        check_result(res, S, eng.n_steps)
        runs[label] = (res, eng.executor)
        print(f"sweep {label}: {S} scenarios x {res.n_steps} ticks, "
              f"wall_s {res.wall_s}, scenario-ticks/s "
              f"{S * res.n_steps / res.wall_s}", flush=True)

    batched = runs["batched"][0]
    for label in ("fused-cuda", "fused-cpu"):
        res = runs[label][0]
        bad = [a.name for a, b in zip(res.scenarios, batched.scenarios)
               if a.name != b.name or not a.allclose(b, rtol=1e-9)]
        if bad:
            fail(f"{label} differs from batched in {len(bad)} scenarios, "
                 f"e.g. {bad[:3]}")
        print(f"{label} vs batched: all {S} scenarios allclose at rtol 1e-9; "
              f"largest relative difference {largest_rel_diff(res, batched)}")
    trig_cuda = runs["fused-cuda"][1].anomaly_triggers
    trig_cpu = runs["fused-cpu"][1].anomaly_triggers
    if not np.array_equal(trig_cuda, trig_cpu):
        fail(f"anomaly_triggers differ between cuda and cpu in "
             f"{int(np.sum(trig_cuda != trig_cpu))} scenarios")
    print(f"anomaly_triggers equal on cuda and cpu (total "
          f"{int(trig_cuda.sum())})")
    n_steps = runs["fused-cuda"][0].n_steps
    if not launches == ticks_stepped == n_steps:
        fail(f"fused_tick launched {launches} times for {ticks_stepped} "
             f"ticks stepped ({n_steps} in the run)")
    print(f"fused_tick launches in the cuda sweep: {launches} "
          f"(one per tick of {n_steps})")

    # -- 5. summary lines ----------------------------------------------------
    main_row = rows[MAIN_PATH_ROWS]
    kernels = [{
        "name": "fused_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:72",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
    }]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} is not finite")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
