#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Phases, each of which exits non-zero on failure:

1. environment: torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``); requires compute capability 9.0 (Hopper);
2. build: compiles every kernel of the path from ``src/repro_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the shapes both main paths give it and larger ones, with CUDA-event
   times: ``fused_tick`` (K2) and ``rls_update`` (K1, float64 and float32);
4. baseline path: ``SweepEngine``/``run_sweep`` over a baseline-controller
   grid (traces ysb and tsw x static/reactive/ds2 x seeds 0-47 = 288
   scenarios, the paper's 18 h at dt = 5 s, a failure every 45 minutes) on
   the fused engine on the card, then on the NumPy batched engine and the
   fused engine on the CPU; every scenario must agree with the batched
   engine at rtol 1e-9, the detector triggers with the CPU run's, and K2
   must have launched once per tick stepped;
5. components on the card: a 288-stream mixed-family ``ForecastBank``
   against the scalar zoo (rtol 1e-9, equal binned-forecast decisions), a
   96-member ``GPBank.fit`` against the scalar ``GP.fit`` (posterior within
   5% of scale), and the same profiling batch selected either way;
6. the Demeter main path: ``paper_grid(controllers=("demeter",),
   trace_kinds=("ysb", "tsw"))`` at the paper's 18 h under the default
   ``EngineConfig()`` (fused engine, forecast bank with K1, GP bank,
   acquisition, all on the card); finite results, a failure in every
   scenario, GP fits made, and K1 launched once per ARIMA tick replayed;
7. the Demeter path, card against CPU: a 3-scenario, 2 h grid with the
   scalar GP fits, run on ``cuda`` and on ``cpu``; every scenario must agree
   at rtol 1e-9 with equal reconfiguration, fit and forecast-update counts.

The last three lines of standard output are the ``nvidia-smi`` line, the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``. The
``kernels`` line reports each kernel's launches on the Demeter main path
beside its times at that path's width.

    python3 chip_smoke.py                     # from the root of a checkout
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

#: H100 SXM data sheet: HBM3 bandwidth and the rates outside the tensor
#: cores (the kernels here do scalar float64 / float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12

#: Row counts the fused-tick check uses; 288 is the baseline path's width,
#: and the Demeter main path's own row count is added.
KERNEL_ROWS = (3, 37, 288, 65_536)
BASELINE_ROWS = 288
LAM, THRESH, DT = 0.995, 3.0, 5.0
#: float64 operations per row of one fused tick, counted from
#: csrc/fused_tick.cu (log1p counted as one): lag update 7, prediction and
#: error 5, flag 2, Pphi 6, quadratic form and denominator 4, gains 2,
#: weights 4, covariance 12.
FUSED_TICK_OPS_PER_ROW = 42
#: Rows and orders the RLS check uses (k = p_max + 1 of the forecast bank:
#: 5, 9 and 17); the Demeter main path's own row count is added.
RLS_ROWS = (16, 288, 65_536)
RLS_ORDERS = (5, 9, 17)
#: the forecast bank's default ARIMA order p = 8 gives k = 9
MAIN_K = 9
#: Demeter main path width: paper seeds (2 scenarios each; seed 0 alone is
#: the paper's own two 18 h runs, §3.4, Figs. 5-6). On NVIDIA H100 80GB
#: HBM3, 700.00 W the path took 75.0 s at 1 seed and 153.0 s at 3 (about
#: 39 s a seed, nearly all host-bound GP fits), the rest of the script about
#: 195 s: 4 seeds keep the whole run near 390 s, inside half the 1200-s
#: limit even on a host 30% slower.
DEMETER_SEEDS = 4

SWEEP_ARRAYS = ("rates", "latencies", "usage_cpu", "usage_mem_mb", "workers",
                "consumer_lag")


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


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

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
    call = lambda: kmod.fused_tick(**ops, lam=LAM, thresh=THRESH,  # noqa
                                   dt=DT)
    plain = lambda: fused_tick_ref(**ops, lam=LAM, thresh=THRESH,  # noqa
                                   dt=DT)
    return {"rows": n, "max_abs_err": max_err, "bytes": n_bytes,
            "ms": device_ms(call), "plain_ms": device_ms(plain),
            "dispatch_ms": host_ms(call), "plain_dispatch_ms": host_ms(plain),
            **bound(n_bytes, FUSED_TICK_OPS_PER_ROW * n, FP64_OPS_PER_S)}


def rls_operands(B: int, k: int, dtype, device):
    """Random symmetric positive definite covariances, regressors and
    forgetting factors (the reference's own test case, widened)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(B * 100 + k)
    a = rng.normal(0, 1, (B, k, k))
    P = a @ a.transpose(0, 2, 1) + np.eye(k)
    phi = rng.normal(0, 1, (B, k))
    lam = np.full(B, 0.995)
    return [torch.as_tensor(v, dtype=dtype, device=device)
            for v in (P, phi, lam)]


def check_rls(B: int, k: int, dtype) -> dict:
    """The CUDA RLS step against its plain version: error relative to the
    largest magnitude of each output, at most 1e-12 in float64 (the
    reference's bar for its kernel) and 1e-5 in float32."""
    import torch
    from repro_torch.kernels import rls_update as kmod
    from repro_torch.kernels.ref import rls_rank1_update_ref
    P, phi, lam = rls_operands(B, k, dtype, "cuda")
    got = kmod.rls_rank1_update(P, phi, lam)
    torch.cuda.synchronize()
    want = rls_rank1_update_ref(P, phi, lam)
    rel = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, want))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    name = f"rls_update B={B} k={k} {str(dtype).split('.')[-1]}"
    if not rel <= tol:
        fail(f"{name}: relative error {rel} exceeds {tol}")
    max_err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    item = P.element_size()
    call = lambda: kmod.rls_rank1_update(P, phi, lam)  # noqa: E731
    plain = lambda: rls_rank1_update_ref(P, phi, lam)  # noqa: E731
    return {"rows": B, "k": k, "dtype": str(dtype).split(".")[-1],
            "max_rel_err": rel, "max_abs_err": max_err,
            "ms": device_ms(call), "plain_ms": device_ms(plain),
            "dispatch_ms": host_ms(call), "plain_dispatch_ms": host_ms(plain),
            **bound(item * (2 * k * k + 2 * k + 1) * B,
                    (5 * k * k + 2 * k) * B,
                    FP64_OPS_PER_S if dtype == torch.float64
                    else FP32_OPS_PER_S)}


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def largest_rel_diff(a, b) -> float:
    import numpy as np
    worst = 0.0
    for sa, sb in zip(a.scenarios, b.scenarios):
        for f in SWEEP_ARRAYS:
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
        for f in SWEEP_ARRAYS:
            a = getattr(s, f)
            if a.shape != (n_steps,) or not np.all(np.isfinite(a)):
                fail(f"{res.engine} {s.name}: {f} is not {n_steps} finite "
                     f"values")
        if not s.failures:
            fail(f"{res.engine} {s.name}: no failure was injected")


def baseline_path() -> int:
    """Phase 4; returns K2's launches in the card sweep."""
    import numpy as np
    from repro_torch.core import EngineConfig
    from repro_torch.dsp import SweepEngine, paper_grid
    from repro_torch.kernels import fused_tick as kmod
    seeds = range(BASELINE_ROWS // 6)
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
    print(f"baseline path: fused_tick launches {launches} (one per tick of "
          f"{n_steps})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def check_forecast_bank(device: str) -> dict:
    """288 mixed-family streams fed one value per minute of 18 h traces
    (in thousands of events/s) against the scalar zoo."""
    import numpy as np
    from repro_torch.core import ForecastBank, binned_forecast
    from repro_torch.core.forecast import make_scalar_forecaster
    from repro_torch.dsp import TRACE_GENERATORS, make_trace
    from repro_torch.kernels import rls_update as kmod
    n, kinds = 288, ("arima", "holt", "seasonal")
    trace_kinds = sorted(TRACE_GENERATORS)
    vals = np.stack([make_trace(trace_kinds[j % len(trace_kinds)],
                                duration_s=18 * 3600.0, dt_s=60.0,
                                seed=1000 + j).rates / 1000.0
                     for j in range(n)], axis=1)
    row_kinds = [kinds[j % 3] for j in range(n)]
    bank = ForecastBank(row_kinds, horizon=10, device=device)
    views = bank.views()
    scalars = [make_scalar_forecaster(k) for k in row_kinds]
    launches0 = kmod.rls_rank1_update.launches
    worst, n_reads = 0.0, 0
    t0 = time.perf_counter()
    for t in range(vals.shape[0]):
        for j in range(n):
            views[j].update(vals[t, j])
            scalars[j].update(vals[t, j])
        if t % 10 == 9:                       # a read epoch every 10 minutes
            n_reads += 1
            for j in range(n):
                got, want = views[j].forecast(10), scalars[j].forecast(10)
                if not np.allclose(got, want, rtol=1e-9, atol=1e-9):
                    fail(f"forecast bank row {j} ({row_kinds[j]}) at tick "
                         f"{t}: {got} != {want}")
                worst = max(worst, float(np.max(
                    np.abs(got - want) / np.maximum(np.abs(want), 1e-300))))
                b, w = binned_forecast(views[j], 10, 5), \
                    binned_forecast(scalars[j], 10, 5)
                # the decision the controller takes from it: the segment
                if int(b * 1000 // 10_000) != int(w * 1000 // 10_000):
                    fail(f"forecast bank row {j}: binned-forecast decision "
                         f"{b} vs {w}")
    launches = kmod.rls_rank1_update.launches - launches0
    if device == "cuda" and launches != bank.arima_ticks:
        fail(f"forecast bank: {launches} rls_update launches for "
             f"{bank.arima_ticks} ARIMA ticks")
    return {"streams": n, "ticks": int(vals.shape[0]), "reads": n_reads,
            "max_rel_diff": worst, "rls_launches": launches,
            "arima_ticks": bank.arima_ticks,
            "update_wall_s": bank.update_wall_s,
            "wall_s": time.perf_counter() - t0}


def gp_datasets(n_sets: int, seed: int):
    """Seeded controller-shaped datasets: d = 5, 3 to 60 points each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    datasets = []
    for i in range(n_sets):
        n = int(rng.integers(3, 61))
        x = rng.uniform(0, 1, (n, 5))
        y = (1.0 + 0.3 * (i % 7)) * (1.2 - x[:, 0]) + 0.4 * x[:, 1] ** 2 \
            + rng.normal(0, 0.05, n)
        datasets.append((x, y))
    return datasets, [i * 131 for i in range(n_sets)]


def check_gp_bank(device: str, n_sets: int = 96) -> dict:
    """``GPBank.fit`` on ``device`` against the scalar ``GP.fit`` on the
    host: posterior within 5% of scale (the reference's bar)."""
    import numpy as np
    import torch
    from repro_torch.core import GP, GPBank
    from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS
    datasets, seeds = gp_datasets(n_sets, seed=12)
    t0 = time.perf_counter()
    bank = GPBank.fit(datasets, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seeds=seeds, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    bank_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalars = [GP.fit(x, y, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seed=s) for (x, y), s in zip(datasets, seeds)]
    scalar_wall = time.perf_counter() - t0
    xq = np.random.default_rng(0).uniform(0, 1, (128, 5))
    mu_b, var_b = bank.posterior(xq)
    worst_mu = worst_var = 0.0
    for i, ((_, y), gp) in enumerate(zip(datasets, scalars)):
        mu, var = gp.posterior(xq)
        scale = np.std(y) or 1.0
        dm = float(np.max(np.abs(mu - mu_b[i])) / scale)
        dv = float(np.max(np.abs(var - var_b[i])) / scale ** 2)
        if not (dm < 0.05 and dv < 0.05):
            fail(f"GPBank member {i} (n={len(y)}): posterior drifted from "
                 f"the scalar fit (mean {dm}, variance {dv} of scale)")
        worst_mu, worst_var = max(worst_mu, dm), max(worst_var, dv)
    return {"members": n_sets, "bank_fit_wall_s": bank_wall,
            "scalar_fit_wall_s": scalar_wall, "max_mean_diff": worst_mu,
            "max_var_diff": worst_var}


def check_selection(device: str) -> list:
    """The same profiling batch from the scalar fits + NumPy EHVI as from
    the GP bank + batched EHVI on ``device`` (three seeds)."""
    import numpy as np
    from repro_torch.core import GP, GPBank, select_profiling_batch
    from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS

    def posterior(gu, gl):
        def post(xq):
            mu_u, var_u = gu.posterior(xq)
            mu_l, var_l = gl.posterior(xq)
            return np.stack([mu_u, mu_l], 1), np.stack([var_u, var_l], 1)
        return post

    picks = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n = 15
        x = rng.uniform(0, 1, (n, 4))
        usage = 1.5 - x[:, 0] + 0.2 * x[:, 1] + rng.normal(0, 0.03, n)
        lat = 0.5 + x[:, 0] ** 2 + rng.normal(0, 0.03, n)
        su = GP.fit(x, usage, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                    seed=3)
        sl = GP.fit(x, lat, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                    seed=4)
        bank = GPBank.fit([(x, usage), (x, lat)], restarts=FIT_RESTARTS,
                          max_iter=FIT_MAX_ITER, seeds=[3, 4], device=device)
        cand = rng.uniform(0, 1, (96, 4))
        front = np.stack([usage, lat], 1)
        ref = (float(usage.max()) * 1.2, float(lat.max()) * 1.2)
        a = select_profiling_batch(cand, posterior(su, sl), None, front, ref,
                                   q=3, backend="numpy")
        b = select_profiling_batch(
            cand, posterior(bank.member(0), bank.member(1)), None, front,
            ref, q=3, backend="torch", device=device)
        if a != b:
            fail(f"selection seed {seed}: scalar picked {a}, bank {b}")
        picks.append(a)
    return picks


# ---------------------------------------------------------------------------
# the Demeter path
# ---------------------------------------------------------------------------

def demeter_specs(n_seeds: int):
    from repro_torch.dsp import paper_grid
    return paper_grid(controllers=("demeter",), seeds=range(n_seeds),
                      trace_kinds=("ysb", "tsw"))


class LayerTimers:
    """Host wall per layer of a sweep, by wrapping the layers' entry points
    on the instances and classes of one run (the sweep's own walls cover
    the forecast bank and the model updates)."""

    def __init__(self):
        self.wall = {}
        self.calls = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.wall[label] = self.wall.get(label, 0.0) \
                    + time.perf_counter() - t0
                self.calls[label] = self.calls.get(label, 0) + 1
        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def demeter_main_path(n_seeds: int, device: str = "cuda") -> dict:
    """Phase 6: the Demeter grid under ``EngineConfig(device=device)``."""
    import torch
    from repro_torch.core import EngineConfig
    from repro_torch.core.demeter import DemeterController
    from repro_torch.dsp import FusedSweepExecutor, SweepEngine
    from repro_torch.dsp.executor import SweepExecutorBase
    from repro_torch.kernels import fused_tick as k2
    from repro_torch.kernels import rls_update as k1
    specs = demeter_specs(n_seeds)
    S = len(specs)
    eng = SweepEngine(specs, config=EngineConfig(device=device))
    timers = LayerTimers()
    timers.wrap(FusedSweepExecutor, "step_interval", "fused engine")
    timers.wrap(SweepExecutorBase, "profile", "profiling clones")
    timers.wrap(DemeterController, "_pick_config", "pick config")
    timers.wrap(DemeterController, "_select_profiles", "select profiles")
    k1.rls_rank1_update.launches = 0
    k2.fused_tick.launches = 0
    try:
        res = eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        timers.restore()
    launches = {"rls_update": k1.rls_rank1_update.launches,
                "fused_tick": k2.fused_tick.launches}
    check_result(res, S, eng.n_steps)
    if not res.n_model_fits > 0:
        fail("Demeter main path fitted no GP")
    ticks = eng.executor.step_index + 1
    if device == "cuda":
        if launches["rls_update"] != eng.forecast_bank.arima_ticks \
                or launches["rls_update"] == 0:
            fail(f"rls_update launched {launches['rls_update']} times for "
                 f"{eng.forecast_bank.arima_ticks} ARIMA ticks replayed")
        if launches["fused_tick"] != ticks:
            fail(f"fused_tick launched {launches['fused_tick']} times for "
                 f"{ticks} ticks")
    out = {"scenarios": S, "n_steps": res.n_steps, "wall_s": res.wall_s,
           "model_update_wall_s": res.model_update_wall_s,
           "model_update_compile_wall_s": res.model_update_compile_wall_s,
           "forecast_update_wall_s": res.forecast_update_wall_s,
           "forecast_update_compile_wall_s":
               res.forecast_update_compile_wall_s,
           "n_model_fits": res.n_model_fits,
           "n_forecast_updates": res.n_forecast_updates,
           "reconfigurations": sum(s.n_reconfigurations
                                   for s in res.scenarios),
           "arima_ticks": eng.forecast_bank.arima_ticks,
           "launches": launches, "layer_wall_s": timers.wall,
           "layer_calls": timers.calls}
    print("demeter main path " + json.dumps(out), flush=True)
    for s in res.scenarios:
        print("table3 " + json.dumps(s.summary()), flush=True)
    return out


def first_difference(a, b) -> str:
    """Where two runs of one scenario part: the first tick whose worker
    count or rate-path metrics differ, and the configs chosen there."""
    import numpy as np
    for f in SWEEP_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        bad = np.flatnonzero(~np.isclose(x, y, rtol=1e-9, atol=1e-9))
        if len(bad):
            i = int(bad[0])
            return (f"first at tick {i} (t = {a.times[i]} s) in {f}: "
                    f"{x[i]} vs {y[i]}; workers {a.workers[i]} vs "
                    f"{b.workers[i]}")
    return "no array differs (a count does)"


def decision_margin(eng_a, eng_b, j: int) -> str:
    """The two runs' reconfiguration events of scenario ``j`` where they
    first differ, with each config's predicted usage under the first run's
    models (the margin between the two candidates)."""
    ca, cb = eng_a.policies[j].ctl, eng_b.policies[j].ctl
    ea = [e for e in ca.events if e[0] == "reconfigure"]
    eb = [e for e in cb.events if e[0] == "reconfigure"]
    for k, (x, y) in enumerate(zip(ea, eb)):
        if x != y:
            seg = ca.store.segment_for(ca.predicted_rate())
            ua = ca._predicted_usage(seg, x[1]["config"])
            ub = ca._predicted_usage(seg, y[1]["config"])
            return (f"event {k}: {x[1]} vs {y[1]}; predicted usage "
                    f"{ua} vs {ub}, margin "
                    f"{None if ua is None or ub is None else abs(ua - ub)}")
    return f"events agree on their common prefix ({len(ea)} vs {len(eb)})"


def demeter_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Phase 7: the same 3-scenario, 2 h grid with scalar fits on each
    device; every scenario must agree at rtol 1e-9."""
    from repro_torch.core import EngineConfig
    from repro_torch.core.demeter import DemeterHyperParams
    from repro_torch.dsp import (PeriodicFailures, ScenarioSpec, SweepEngine,
                                 make_trace)
    specs = [ScenarioSpec(trace=make_trace(k, duration_s=2 * 3600.0),
                          controller="demeter", seed=s,
                          failures=PeriodicFailures(2700.0), forecaster=f)
             for s, (k, f) in enumerate((("diurnal", "arima"),
                                         ("flash", "holt"),
                                         ("regime", "seasonal")))]
    hp = DemeterHyperParams(profile_interval_s=600)
    engines, results = {}, {}
    for dev in devices:
        eng = SweepEngine(specs, config=EngineConfig(
            device=dev, fit_backend="scalar", hp=hp))
        results[dev] = eng.run()
        engines[dev] = eng
        check_result(results[dev], len(specs), eng.n_steps)
        r = results[dev]
        print(f"demeter 2 h on {dev}: wall_s {r.wall_s}, n_model_fits "
              f"{r.n_model_fits}, n_forecast_updates {r.n_forecast_updates}, "
              f"reconfigurations "
              f"{[s.n_reconfigurations for s in r.scenarios]}", flush=True)
    a, b = (results[d] for d in devices)
    problems = []
    for j, (sa, sb) in enumerate(zip(a.scenarios, b.scenarios)):
        if not sa.allclose(sb, rtol=1e-9) \
                or sa.n_reconfigurations != sb.n_reconfigurations:
            problems.append(f"{sa.name}: {first_difference(sa, sb)}; "
                            f"{decision_margin(*engines.values(), j)}")
    for key in ("n_model_fits", "n_forecast_updates"):
        if getattr(a, key) != getattr(b, key):
            problems.append(f"{key}: {getattr(a, key)} vs {getattr(b, key)}")
    if problems:
        fail("Demeter card vs CPU: " + " | ".join(problems))
    out = {"scenarios": len(specs), "n_model_fits": a.n_model_fits,
           "n_forecast_updates": a.n_forecast_updates,
           "largest_rel_diff": largest_rel_diff(a, b),
           "wall_s": {d: results[d].wall_s for d in devices}}
    print("demeter card vs cpu " + json.dumps(out), flush=True)
    return out


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
    from repro_torch.kernels import build

    # The port's host-side work (scalar GP fits, posteriors on the host, the
    # CPU legs of the comparisons) is thousands of tiny tensor operations,
    # which run fastest on one thread: the 96 scalar fits of phase 5 took
    # 183.7 s on the default 8 threads of an NVIDIA H100 80GB HBM3,
    # 700.00 W machine's host and 28.2 s on one.
    torch.set_num_threads(1)
    t_start = time.perf_counter()
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
    libs = build.build_all(["fused_tick", "rls_update"])
    for lib_name in libs:
        build.load(lib_name)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for lib_name, lib in sorted(libs.items()):
        log = lib.with_suffix(".log")
        if log.exists():
            print(f"ptxas {lib_name}: " + " | ".join(
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln or "stack" in ln),
                flush=True)

    # -- 3. kernels against their plain versions -----------------------------
    # the Demeter main path's widths: K2 steps every scenario, K1 every
    # ARIMA stream of the forecast bank
    specs = demeter_specs(DEMETER_SEEDS)
    main_tick_rows = len(specs)
    main_rls_rows = sum(1 for s in specs if s.forecaster == "arima")
    tick_rows, rls_rows = {}, {}
    for n in sorted({main_tick_rows, *KERNEL_ROWS}):
        tick_rows[n] = r = check_fused_tick(n)
        print("kernel fused_tick " + json.dumps(r), flush=True)
    for B in sorted({main_rls_rows, *RLS_ROWS}):
        for k in RLS_ORDERS:
            for dtype in (torch.float64, torch.float32):
                r = check_rls(B, k, dtype)
                rls_rows[(B, k, r["dtype"])] = r
                print("kernel rls_update " + json.dumps(r), flush=True)
    print(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. the baseline path ------------------------------------------------
    baseline_path()
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # -- 5. components on the card -------------------------------------------
    fb = check_forecast_bank("cuda")
    print("component forecast_bank " + json.dumps(fb), flush=True)
    gb = check_gp_bank("cuda")
    print("component gp_bank " + json.dumps(gb), flush=True)
    picks = check_selection("cuda")
    print(f"component selection: same batches {picks}", flush=True)
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # -- 6. the Demeter main path --------------------------------------------
    main_path = demeter_main_path(DEMETER_SEEDS)
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. the Demeter path, card against CPU -------------------------------
    demeter_card_vs_cpu()
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # -- 8. summary lines: launches and times from the Demeter main path ----
    tick = tick_rows[main_tick_rows]
    rls = rls_rows[(main_rls_rows, MAIN_K, "float64")]
    print(f"Demeter path launches {main_path['launches']}")
    kernels = [{
        "name": "fused_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:72",
        "launches": main_path["launches"]["fused_tick"],
        "max_abs_err": max(r["max_abs_err"] for r in tick_rows.values()),
        "ms": tick["ms"], "plain_ms": tick["plain_ms"],
        "bound_ms": tick["bound_ms"], "bound_by": tick["bound_by"],
        "library_ms": None,
    }, {
        "name": "rls_update", "route": "cuda",
        "source": "src/repro_torch/csrc/rls_update.cu",
        "replaces": "src/repro/kernels/rls_update.py:41",
        "launches": main_path["launches"]["rls_update"],
        "max_abs_err": max(r["max_abs_err"] for r in rls_rows.values()
                           if r["dtype"] == "float64"),
        "ms": rls["ms"], "plain_ms": rls["plain_ms"],
        "bound_ms": rls["bound_ms"], "bound_by": rls["bound_by"],
        "library_ms": None,
    }]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} is not finite")
        if not k["launches"] > 0:
            fail(f"{k['name']} was not launched on the main path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
