"""The port's CUDA kernels, fused engine and Demeter path on the card
(marker ``cuda``).

These need an NVIDIA GPU and skip without one; on the GPU machine, which
has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They hold the fused-tick, fused-interval, RLS, ARIMA-chunk,
decode-attention, SSD-scan, flash-attention, grouped-matmul and
fused-RMSNorm kernels against their plain versions, and the fused engine, a short Demeter sweep, the
detector bank, one short ``run_experiment``, an 8-job fleet soak (and the
obs counters against the kernels' launch counters), small serving
runs (dense, mamba2, zamba2, deepseek-moe, deepseek-v2-lite), hubert's
``encode`` and pixtral's ``train_loss`` on the card against the same runs
on the CPU, and the contract probes on the card (no host sync under the
sync debug mode; K2's interval, K1's chunk and the GP fit kernel replayed
bit-equal from a CUDA graph).
``chip_smoke.py`` does the same at the main paths' full size.
"""
import copy
import math

import numpy as np
import pytest
import torch

from helpers import int8_ties
from helpers.sharded_diff import VOLATILE
from repro_torch.configs import smoke_config
from repro_torch.core import EngineConfig
from repro_torch.core.demeter import DemeterHyperParams
from repro_torch.dsp import (FailuresAt, PeriodicFailures, ScenarioSpec,
                             SweepEngine, make_trace)
from repro_torch.kernels import decode_attention as attn_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import fused_tick as kmod
from repro_torch.kernels import grouped_matmul as gmm_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rls_update as rls_mod
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.dsp import ClusterModel
from repro_torch.kernels.ref import (METRIC_KEYS, arima_chunk_ref,
                                     decode_attention_ref,
                                     flash_attention_ref, fused_interval_ref,
                                     fused_rmsnorm_ref, fused_tick_ref,
                                     grouped_matmul_ref,
                                     rls_rank1_update_ref, ssd_scan_ref)
from repro_torch.models import encode, init_params, train_loss
from repro_torch.serving import Request, ServingEngine

LAM, THRESH, DT = 0.995, 3.0, 5.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(n, seed, device):
    rng = np.random.default_rng(seed)
    a = dict(lag=rng.uniform(0.0, 1e5, n), lag_add=rng.uniform(0.0, 1e4, n),
             rates=rng.uniform(1e4, 9e4, n), cap=rng.uniform(1e4, 8e4, n),
             down_pre=rng.random(n) < 0.3, w=rng.normal(size=(n, 2)) * 0.1,
             P=np.broadcast_to(10.0 * np.eye(2), (n, 2, 2)).copy(),
             y_prev=rng.uniform(0.0, 12.0, n))
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 288, 1000])
def test_kernel_matches_plain_version(cuda, n):
    t = _operands(n, seed=n, device=cuda)
    before = kmod.fused_tick.launches
    got = ops.fused_tick(**t, lam=LAM, thresh=THRESH, dt=DT)
    torch.cuda.synchronize()
    assert kmod.fused_tick.launches == before + 1
    want = fused_tick_ref(**t, lam=LAM, thresh=THRESH, dt=DT)
    assert torch.equal(got[0], want[0])          # new_lag: bit for bit
    for g, r in zip(got[1:4], want[1:4]):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)
    assert torch.equal(got[4], want[4])


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    t = _operands(8, seed=0, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        kmod.fused_tick(**{**t, "cap": t["cap"].float()}, lam=LAM,
                        thresh=THRESH, dt=DT)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.fused_tick(**{**t, "P": t["P"].transpose(1, 2)}, lam=LAM,
                        thresh=THRESH, dt=DT)


@pytest.mark.cuda
def test_fused_engine_on_card_matches_cpu(cuda):
    specs = [ScenarioSpec(trace=make_trace(k, duration_s=1800.0),
                          controller=c, seed=s, failures=f)
             for k, c, s, f in (
                 ("diurnal", "reactive", 3, FailuresAt(100.0, 150.0, 900.0)),
                 ("flash", "static", 1, PeriodicFailures(300.0)),
                 ("ysb", "ds2", 2, PeriodicFailures(600.0)))]
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = SweepEngine(specs, config=EngineConfig(device=dev))
        before = (kmod.fused_interval.launches, kmod.fused_tick.launches)
        res = eng.run()
        runs[dev] = (res, eng.executor.anomaly_triggers,
                     kmod.fused_interval.launches - before[0],
                     eng.executor.intervals_stepped,
                     kmod.fused_tick.launches - before[1])
    # one launch an interval, and the per-tick kernel off the path
    assert runs["cuda"][2] == runs["cuda"][3] > 0
    assert runs["cuda"][4] == 0
    assert runs["cpu"][2] == runs["cpu"][4] == 0
    for a, b in zip(runs["cuda"][0].scenarios, runs["cpu"][0].scenarios):
        assert a.allclose(b, rtol=1e-12, atol=1e-12), a.name
    np.testing.assert_array_equal(runs["cuda"][1], runs["cpu"][1])


def _rls_operands(B, k, dtype, device):
    rng = np.random.default_rng(B * 100 + k)
    a = rng.normal(0, 1, (B, k, k))
    P = a @ a.transpose(0, 2, 1) + np.eye(k)
    phi = rng.normal(0, 1, (B, k))
    lam = np.full(B, 0.995)
    return [torch.as_tensor(v, dtype=dtype, device=device)
            for v in (P, phi, lam)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,k", [(1, 5), (13, 9), (288, 9), (1000, 17),
                                 (37, 3), (64, 33)])
def test_rls_kernel_matches_plain_version(cuda, B, k, dtype, tol):
    P, phi, lam = _rls_operands(B, k, dtype, cuda)
    before = rls_mod.rls_rank1_update.launches
    g, p = ops.rls_rank1_update(P, phi, lam)
    torch.cuda.synchronize()
    assert rls_mod.rls_rank1_update.launches == before + 1
    g_ref, p_ref = rls_rank1_update_ref(P, phi, lam)
    for got, want in ((g, g_ref), (p, p_ref)):
        assert got.dtype == dtype and got.shape == want.shape
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= tol, err


@pytest.mark.cuda
def test_rls_kernel_rejects_bad_operands(cuda):
    P, phi, lam = _rls_operands(8, 9, torch.float64, cuda)
    with pytest.raises(TypeError, match="float64"):
        rls_mod.rls_rank1_update(P, phi.float(), lam)
    with pytest.raises(TypeError, match="float64 or float32"):
        rls_mod.rls_rank1_update(P.half(), phi.half(), lam.half())
    with pytest.raises(ValueError, match="contiguous"):
        rls_mod.rls_rank1_update(P.transpose(1, 2), phi, lam)
    with pytest.raises(ValueError, match="phi must have shape"):
        rls_mod.rls_rank1_update(P, phi[:, :5].contiguous(), lam)
    with pytest.raises(ValueError, match="CUDA device"):
        rls_mod.rls_rank1_update(P, phi.cpu(), lam)
    big = torch.eye(65, dtype=torch.float64, device=cuda)[None]
    with pytest.raises(ValueError, match="k <= 64"):
        rls_mod.rls_rank1_update(big, big[:, 0], lam[:1])


def _interval_operands(S, K, seed, device):
    """One fused-engine interval's operands (state mid-run, mixed configs,
    down rows, rollback lag), as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    down_pre = rng.random((K, S)) < 0.15
    down_post = down_pre & (rng.random((K, S)) < 0.7)
    z2 = np.abs(rng.normal(size=(K, S)))
    z2[down_post] = 0.0
    a = dict(
        lag=rng.uniform(0.0, 2e5, S) * (rng.random(S) < 0.6),
        det_w=rng.normal(size=(S, 2)) * 0.1,
        det_p=np.broadcast_to(10.0 * np.eye(2), (S, 2, 2)).copy(),
        det_y=rng.uniform(0.0, 12.0, S),
        det_trig=rng.integers(0, 5, S).astype(np.int64),
        rates=rng.uniform(1e4, 9e4, (K, S)),
        lag_add=rng.uniform(0.0, 5e4, (K, S)) * (rng.random((K, S)) < 0.1),
        down_pre=down_pre, down_post=down_post,
        z1=rng.normal(size=(K, S)), z2=z2,
        workers=rng.integers(1, 25, S).astype(np.float64),
        cpu_cores=rng.integers(1, 5, S).astype(np.float64),
        memory_mb=rng.choice([1024.0, 2048.0, 4096.0], S),
        task_slots=rng.integers(1, 4, S).astype(np.float64),
        cap_base=rng.uniform(1e4, 8e4, S))
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


INTERVAL_STATE = ("lag", "det_w", "det_p", "det_y", "det_trig")
INTERVAL_REST = ("rates", "lag_add", "down_pre", "down_post", "z1", "z2",
                 "workers", "cpu_cores", "memory_mb", "task_slots",
                 "cap_base")


def _run_interval(fn, t):
    """``fn`` on a copy of the operands; returns (metrics, state)."""
    state = {k: t[k].clone() for k in INTERVAL_STATE}
    out = fn(ClusterModel(), *state.values(), *(t[k] for k in INTERVAL_REST),
             LAM, THRESH, DT)
    torch.cuda.synchronize()
    return out, state


@pytest.mark.cuda
@pytest.mark.parametrize("S,K", [(8, 12), (37, 1), (288, 12), (37, 100),
                                 (1000, 5)])
def test_interval_kernel_matches_plain_version(cuda, S, K):
    t = _interval_operands(S, K, seed=S + K, device=cuda)
    before = kmod.fused_interval.launches
    got, got_state = _run_interval(ops.fused_interval, t)
    assert kmod.fused_interval.launches == before + 1
    want, want_state = _run_interval(fused_interval_ref, t)
    assert got.shape == (len(METRIC_KEYS), K, S)
    for q, key in enumerate(METRIC_KEYS):      # bit for bit
        assert torch.equal(got[q], want[q]), key
    assert torch.equal(got_state["lag"], want_state["lag"])
    for key in ("det_w", "det_p", "det_y"):
        torch.testing.assert_close(got_state[key], want_state[key],
                                   rtol=1e-12, atol=1e-12, msg=key)
    assert torch.equal(got_state["det_trig"], want_state["det_trig"])
    again, again_state = _run_interval(kmod.fused_interval, t)
    assert torch.equal(again, got)
    for key in INTERVAL_STATE:
        assert torch.equal(again_state[key], got_state[key]), key


@pytest.mark.cuda
def test_interval_kernel_rejects_bad_operands(cuda):
    t = _interval_operands(8, 3, seed=0, device=cuda)

    def call(**over):
        u = {**t, **over}
        kmod.fused_interval(ClusterModel(),
                            *(u[k] for k in INTERVAL_STATE + INTERVAL_REST),
                            LAM, THRESH, DT)
    with pytest.raises(TypeError, match="float64"):
        call(z1=t["z1"].float())
    with pytest.raises(TypeError, match="torch.bool"):
        call(down_pre=t["down_pre"].double())
    with pytest.raises(TypeError, match="torch.int64"):
        call(det_trig=t["det_trig"].int())
    with pytest.raises(ValueError, match="contiguous"):
        call(det_p=t["det_p"].transpose(1, 2))
    with pytest.raises(ValueError, match="lag_add must have shape"):
        call(lag_add=t["lag_add"][:2].contiguous())
    with pytest.raises(ValueError, match="K >= 1"):
        call(**{k: t[k][:0] for k in INTERVAL_REST[:6]})
    with pytest.raises(ValueError, match="CUDA device"):
        call(cap_base=t["cap_base"].cpu())


def _chunk_operands(B, k, T, seed, device):
    """ARIMA family state after a warm-up and a (T, B) chunk of ticks in
    thousands of events/s: orders p up to k - 1, depths 1 and 2, NaN gaps
    and padding ticks, and one stream whose 1e308 spike makes the step
    overflow (the divergence reset)."""
    rng = np.random.default_rng(seed)
    p_max = k - 1
    p = rng.integers(1, p_max + 1, B)
    p[0] = p_max
    d = rng.integers(1, 3, B)
    ridge = rng.uniform(1.0, 20.0, B)
    lam = rng.uniform(0.97, 1.0, B)
    ts = np.arange(T + 40)[:, None]
    vals = 40.0 + 8.0 * np.sin(2 * np.pi * ts / 37.0 + rng.uniform(0, 6, B)) \
        + rng.normal(0, 0.5, (T + 40, B))
    vals[rng.random(vals.shape) < 0.05] = np.nan
    chunk = vals[40:]
    if T >= 4:
        chunk[-2:] = np.nan                         # padding ticks
    spike = max(T - 4, 0)
    chunk[spike, -1] = 1e308
    if spike + 1 < T:
        chunk[spike + 1, -1] = 40.0
    f64 = dict(dtype=torch.float64, device=device)
    state = [torch.zeros((B, k), **f64),
             torch.as_tensor(ridge[:, None, None] * np.eye(k), **f64),
             torch.zeros((B, p_max), **f64), torch.zeros((B, 2), **f64),
             torch.zeros(B, dtype=torch.int64, device=device),
             torch.zeros(B, **f64)]
    params = [torch.as_tensor(p, device=device),
              torch.as_tensor(d, device=device), torch.as_tensor(lam, **f64),
              torch.as_tensor(ridge, **f64)]
    cap = params[3] * (params[0] + 1).double() * 1e4
    warm = torch.as_tensor(vals[:40], **f64)
    arima_chunk_ref(*state, *params, cap, warm)
    return state, params + [cap], torch.as_tensor(vals[40:], **f64)


def _same_bits(a, b):
    """Equal bit for bit, NaN payloads included."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def _rel(got, want, stream_dim=0):
    """Largest difference relative to each stream's largest finite
    magnitude; non-finite entries must match in place."""
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    g, w, f = (x.movedim(stream_dim, 0).reshape(x.shape[stream_dim], -1)
               for x in (got, want, fin))
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    scale = torch.where(f, w.abs(), zero).amax(1).clamp_min(1e-300)
    diff = torch.where(f, (g - w).abs(), zero).amax(1)
    return float((diff / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,T", [(8, 9, 12), (1, 5, 4), (288, 17, 12),
                                   (37, 9, 128), (13, 3, 7), (5, 33, 9),
                                   (300, 5, 1)])
def test_arima_chunk_kernel_matches_plain_version(cuda, B, k, T):
    state, params, vals = _chunk_operands(B, k, T, seed=B * k + T,
                                          device=cuda)
    got_state = [t.clone() for t in state]
    want_state = [t.clone() for t in state]
    before = rls_mod.arima_chunk.launches
    got = ops.arima_chunk(*got_state, *params, vals)
    torch.cuda.synchronize()
    assert rls_mod.arima_chunk.launches == before + 1
    want = arima_chunk_ref(*want_state, *params, vals)
    assert got[0].shape == (T, B) and got[1].dtype == torch.bool
    assert torch.equal(got[1], want[1])                       # do_rls
    assert _rel(got[0], want[0], stream_dim=1) <= 1e-12       # resid
    for name, g, r in zip(("w", "P", "lags", "tails", "count", "last"),
                          got_state, want_state):
        if g.dtype == torch.int64:
            assert torch.equal(g, r), name
        else:
            assert _rel(g, r) <= 1e-12, name
    again_state = [t.clone() for t in state]
    again = rls_mod.arima_chunk(*again_state, *params, vals)
    torch.cuda.synchronize()
    assert _same_bits(again[0], got[0]) and torch.equal(again[1], got[1])
    for g, a in zip(got_state, again_state):
        assert _same_bits(g, a)


@pytest.mark.cuda
def test_arima_chunk_kernel_rejects_bad_operands(cuda):
    state, params, vals = _chunk_operands(8, 9, 4, seed=0, device=cuda)

    def call(i, t):
        args = state + params + [vals]
        args[i] = t
        rls_mod.arima_chunk(*args)
    with pytest.raises(TypeError, match="float64"):
        call(1, state[1].float())
    with pytest.raises(TypeError, match="torch.int64"):
        call(6, params[0].int())
    with pytest.raises(ValueError, match="contiguous"):
        call(1, state[1].transpose(1, 2))
    with pytest.raises(ValueError, match="lags must have shape"):
        call(2, state[2][:, :3].contiguous())
    with pytest.raises(ValueError, match="T >= 1"):
        call(11, vals[:0])
    with pytest.raises(ValueError, match="CUDA device"):
        call(10, params[4].cpu())
    with pytest.raises(ValueError, match="d_max <= 32"):
        call(3, torch.zeros((8, 33), dtype=torch.float64, device=cuda))
    big = torch.zeros((8, 65), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="k <= 64"):
        call(0, big)


@pytest.mark.cuda
def test_demeter_sweep_on_card_matches_cpu(cuda):
    specs = [ScenarioSpec(trace=make_trace(k, duration_s=1.5 * 3600.0),
                          controller="demeter", seed=s,
                          failures=PeriodicFailures(2700.0), forecaster=f)
             for s, (k, f) in enumerate((("diurnal", "arima"),
                                         ("flash", "holt")))]
    hp = DemeterHyperParams(profile_interval_s=600)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = (rls_mod.arima_chunk.launches,
                  rls_mod.rls_rank1_update.launches)
        eng = SweepEngine(specs, config=EngineConfig(
            device=dev, fit_backend="scalar", hp=hp))
        res = eng.run()
        runs[dev] = (res, rls_mod.arima_chunk.launches - before[0],
                     eng.forecast_bank.arima_chunks,
                     rls_mod.rls_rank1_update.launches - before[1])
    (card, launches, chunks, per_step), (cpu, cpu_launches, _, _) = \
        runs["cuda"], runs["cpu"]
    # one launch a chunk, and the per-step kernel off the path
    assert launches == chunks > 0 and per_step == 0 and cpu_launches == 0
    assert card.n_model_fits == cpu.n_model_fits > 0
    assert card.n_forecast_updates == cpu.n_forecast_updates
    for a, b in zip(card.scenarios, cpu.scenarios):
        assert a.allclose(b, rtol=1e-9), a.name



def _detector_streams(n, T, seed):
    """Throughput-like streams: outages to zero, NaN gaps, inactive rows."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    v = rng.uniform(1e3, 8e4, n) * (1 + 0.1 * np.sin(t / 9.0)) \
        * (1 + 0.01 * rng.normal(0, 1, (T, n)))
    v[60:80, ::4] = 0.0
    v[rng.random((T, n)) < 0.03] = np.nan
    act = np.ones((T, n), bool)
    act[(t[:, 0] // 20) % 2 == 1, 2::8] = False
    return v, act


@pytest.mark.cuda
def test_detector_bank_on_card_matches_cpu(cuda):
    from repro_torch.core import DetectorBank
    n, T = 64, 200
    vals, act = _detector_streams(n, T, seed=0)
    card, cpu = DetectorBank(n, device="cuda"), DetectorBank(n, device="cpu")
    probe = DetectorBank(n, device="cuda")
    before = rls_mod.arima_chunk.launches
    n_flags = 0
    for i in range(T):
        shared = i % 50 == 25
        if shared:             # one sample from the CPU bank's state
            old = [x.clone() for x in (*cpu._state, cpu._ring)]
            probe.load_state([x.to(cuda) for x in cpu._state],
                             cpu._ring.to(cuda), cpu._rn.to(cuda))
        got = card.observe(vals[i], act[i])
        want = cpu.observe(vals[i], act[i])
        np.testing.assert_array_equal(got, want)
        n_flags += int(got.sum())
        if shared:
            np.testing.assert_array_equal(probe.observe(vals[i], act[i]),
                                          want)
            # the streams that take the sample, relative to each one's
            # largest magnitude before or after it (a flagged stream coasts
            # on its prediction: its residuals are rounding noise)
            rows = ~torch.as_tensor(want)
            for a, b, c in zip((*probe._state, probe._ring),
                               (*cpu._state, cpu._ring), old):
                a, b, c = (x[rows].cpu().double() for x in (a, b, c))
                mag = torch.maximum(b.abs(), c.abs()).reshape(len(b), -1)
                err = (a - b).abs().reshape(len(b), -1).amax(1) \
                    / mag.amax(1).clamp_min(1e-300)
                assert float(err.max()) <= 1e-12
    assert n_flags > 0
    # one launch a sample for each bank on the card, the probe's included
    assert rls_mod.arima_chunk.launches - before == T + T // 50


@pytest.mark.cuda
def test_run_experiment_on_card_matches_cpu(cuda):
    from repro_torch.dsp import run_experiment, ysb_like
    trace = ysb_like(duration_s=2 * 3600.0, dt_s=10.0)
    before = rls_mod.arima_chunk.launches
    card = run_experiment(trace, "demeter", seed=3, config=EngineConfig(
        fit_backend="scalar"))
    launches = rls_mod.arima_chunk.launches - before
    cpu = run_experiment(trace, "demeter", seed=3, config=EngineConfig(
        device="cpu", fit_backend="scalar"))
    assert launches > 0 and rls_mod.arima_chunk.launches - before == launches
    for f in ("rates", "latencies", "usage_cpu", "usage_mem_mb", "workers"):
        np.testing.assert_allclose(getattr(card, f), getattr(cpu, f),
                                   rtol=1e-9, err_msg=f)
    assert card.n_reconfigurations == cpu.n_reconfigurations
    assert [f.recovery_s for f in card.failures] == \
        [f.recovery_s for f in cpu.failures]
    assert card.profile_cpu_s > 0


@pytest.mark.cuda
def test_fleet_soak_on_card_matches_cpu(cuda):
    """An 8-job fleet on the card gives the CPU's digest and stats; K1
    runs once per forecast-bank flush and once per detector sample."""
    from repro_torch import obs
    from repro_torch.fleet import SoakConfig, run_soak
    cfg = SoakConfig(n_jobs=8, epochs=8, seed=1)
    rls_mod.arima_chunk.launches = 0
    obs.enable(clear=True)
    obs.reset()
    try:
        card = run_soak(cfg, EngineConfig())
    finally:
        obs.disable()
    launches = rls_mod.arima_chunk.launches
    snap = obs.snapshot()
    obs.reset()
    cpu = run_soak(cfg, EngineConfig(device="cpu"))
    assert card["decision_digest"] == cpu["decision_digest"]
    assert card["stats"] == cpu["stats"] and card["decisions"] > 0
    c = snap["counters"]
    assert launches == c["sweep.forecast_flushes"] \
        + c["sweep.detector_samples"] > 0
    assert c["sweep.detector_samples"] == cfg.epochs
    assert snap["gauges"]["launches.arima_chunk"] == launches
    assert snap["gauges"]["kernel_libs.detector"] == 1


@pytest.mark.cuda
def test_obs_counters_on_card_equal_launch_counters(cuda):
    """With obs on, a Demeter sweep on the card counts one interval per
    K2 launch, and the launch gauges hold the kernels' own counters."""
    from repro_torch import obs
    specs = [ScenarioSpec(trace=make_trace("diurnal", duration_s=3600.0),
                          controller="demeter", seed=0,
                          failures=PeriodicFailures(1200.0))]
    config = EngineConfig(fit_backend="scalar",
                          hp=DemeterHyperParams(profile_interval_s=600))
    runs = {}
    for on in (False, True):
        kmod.fused_interval.launches = rls_mod.arima_chunk.launches = 0
        eng = SweepEngine(specs, config=config)
        if on:
            obs.enable(clear=True)
            obs.reset()
        try:
            runs[on] = eng.run()
        finally:
            obs.disable()
    snap = obs.snapshot()
    obs.reset()
    c, g = snap["counters"], snap["gauges"]
    assert c["sweep.intervals"] == kmod.fused_interval.launches \
        == eng.executor.intervals_stepped > 0
    assert g["launches.fused_interval"] == kmod.fused_interval.launches
    assert g["launches.arima_chunk"] == rls_mod.arima_chunk.launches \
        == eng.forecast_bank.arima_chunks > 0
    assert g["kernel_libs.fused_scan"] == 1
    assert g["kernel_libs.forecast_bank"] == 1
    assert {k: v for k, v in runs[True].to_json().items()
            if k not in VOLATILE} == \
        {k: v for k, v in runs[False].to_json().items() if k not in VOLATILE}


def _attention_operands(B, S, Hkv, G, D, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape), dtype=dtype,
                               device=device)
               for shape in ((B, 1, Hkv * G, D), (B, S, Hkv, D),
                             (B, S, Hkv, D)))
    lengths = rng.integers(1, S + 1, B)
    lengths[:3] = [0, 1, S][:B]
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32,
                                    device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Hkv,G,D", [(16, 4096, 4, 7, 128),
                                         (3, 37, 2, 1, 64),
                                         (5, 300, 1, 4, 256),
                                         (4, 129, 3, 16, 128),
                                         (2, 1000, 8, 2, 64)])
def test_decode_attention_kernel_matches_plain_version(cuda, B, S, Hkv, G,
                                                       D, dtype, tol):
    """Ragged lengths with 0, 1 and S_max; any S_max; groups 1 to 16. The
    plain version rounds the softmax weights to bf16 before the weighted
    sum and the kernel does not, hence the bf16 bar."""
    q, k, v, lengths = _attention_operands(B, S, Hkv, G, D, dtype, cuda)
    before = attn_mod.decode_attention.launches
    got = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert attn_mod.decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, lengths)
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, err
    assert not got[0].any()                     # length 0 gives zeros
    scalar = ops.decode_attention(q, k, v, 5)
    torch.testing.assert_close(scalar.float(),
                               decode_attention_ref(q, k, v, 5).float(),
                               rtol=0, atol=tol)


@pytest.mark.cuda
def test_decode_attention_kernel_rejects_bad_operands(cuda):
    q, k, v, lengths = _attention_operands(4, 64, 2, 4, 128, torch.float32,
                                           cuda)
    with pytest.raises(TypeError, match="like q"):
        attn_mod.decode_attention(q, k.bfloat16(), v, lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn_mod.decode_attention(q.half(), k.half(), v.half(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        attn_mod.decode_attention(q, k.transpose(0, 1).contiguous()
                                  .transpose(0, 1), v, lengths)
    with pytest.raises(ValueError, match="head dims"):
        attn_mod.decode_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), lengths)
    with pytest.raises(ValueError, match="groups of 1 to 16"):
        wide = torch.zeros(4, 1, 34, 128, device=cuda)
        attn_mod.decode_attention(wide, k, v, lengths)
    with pytest.raises(ValueError, match="do not group"):
        attn_mod.decode_attention(q[:, :, :7].contiguous(), k, v, lengths)
    with pytest.raises(ValueError, match="CUDA device"):
        attn_mod.decode_attention(q, k.cpu(), v, lengths)
    with pytest.raises(ValueError, match="lengths"):
        attn_mod.decode_attention(q, k, v, lengths[:3])


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _decode_agrees(q, k, v, lengths, tol):
    """One launch (both passes), within ``tol`` of the plain version, zeros
    for a row of length 0, and a second call equal bit for bit."""
    before = attn_mod.decode_attention.launches
    got = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert attn_mod.decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, lengths)
    assert got.shape == want.shape and got.isfinite().all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, err
    empty = torch.as_tensor(lengths, device=q.device).reshape(-1) <= 0
    assert not got[empty.expand(q.shape[0])].any()
    assert torch.equal(ops.decode_attention(q, k, v, lengths), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_attention_one_long_row(cuda, dtype, tol):
    """B = 1 and 32 768 positions: one CTA per (row, head) would walk the
    row alone; the split spreads it over the card."""
    q, k, v, _ = _attention_operands(1, 32_768, 4, 7, 128, dtype, cuda)
    chunk, n_split = attn_mod.split_plan(1, 32_768, 4, _sm_count())
    assert n_split > 1 and 4 * n_split >= _sm_count()   # fills the card
    for length in (32_768, 32_768 - chunk + 1, 1):
        _decode_agrees(q, k, v, torch.tensor([length], dtype=torch.int32,
                                             device=cuda), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Hkv,G,D", [(16, 4096, 4, 7, 128),
                                         (3, 1000, 2, 16, 64),
                                         (4, 600, 1, 4, 256)])
def test_decode_attention_lengths_on_chunk_boundaries(cuda, B, S, Hkv, G, D,
                                                      dtype, tol):
    """Rows that end one short of, on, and one past a chunk boundary, and
    in the last chunk; the empty chunks past them merge as nothing."""
    q, k, v, _ = _attention_operands(B, S, Hkv, G, D, dtype, cuda)
    chunk, n_split = attn_mod.split_plan(B, S, Hkv, _sm_count())
    edges = [0, chunk - 1, chunk, chunk + 1, 2 * chunk, S - 1, S,
             (n_split - 1) * chunk]
    lengths = [min(max(x, 0), S) for x in edges]
    lengths = (lengths * B)[:B] if B < len(lengths) else \
        lengths + [S] * (B - len(lengths))
    _decode_agrees(q, k, v, torch.tensor(lengths, dtype=torch.int32,
                                         device=cuda), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_attention_deepseek_moe_group(cuda, dtype, tol):
    """deepseek-moe-16b's decode: G = 1 over Hkv = 16 heads of 128."""
    q, k, v, lengths = _attention_operands(16, 4096, 16, 1, 128, dtype, cuda)
    _decode_agrees(q, k, v, lengths, tol)


@pytest.mark.cuda
def test_decode_attention_is_deterministic(cuda):
    """The merge adds the chunks in a fixed order: ten calls on the serving
    shape give the same bits."""
    q, k, v, lengths = _attention_operands(16, 4096, 4, 7, 128,
                                           torch.bfloat16, cuda)
    first = ops.decode_attention(q, k, v, lengths)
    for _ in range(9):
        assert torch.equal(ops.decode_attention(q, k, v, lengths), first)


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda):
    """A narrow qwen2-shaped decoder (G = 7, D = 64, float32) serves the
    same ragged requests on the card, through the kernel, and on the CPU,
    through its plain version: equal tokens, one launch per layer and
    decode step."""
    cfg = smoke_config("qwen2_7b").scaled(n_heads=7, n_kv_heads=1,
                                          head_dim=64)
    cpu_model = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    outputs = {}
    for dev, model in (("cuda", copy.deepcopy(cpu_model)), ("cpu",
                                                            cpu_model)):
        eng = ServingEngine(cfg, model, n_slots=3, max_len=96, device=dev)
        rng = np.random.default_rng(0)
        for i, n in enumerate((8, 12, 16, 9, 11)):
            eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, n),
                               max_tokens=6, arrival_s=0.0))
        before = attn_mod.decode_attention.launches
        while eng.queue or eng.cache_mgr.active():
            eng.admit()
            eng.step()
        launches = attn_mod.decode_attention.launches - before
        assert launches == (eng.metrics.decode_steps * cfg.n_layers
                            if dev == "cuda" else 0)
        assert eng.metrics.completed == 5
        outputs[dev] = [eng.requests[f"r{i}"].output for i in range(5)]
    assert outputs["cuda"] == outputs["cpu"]


def _ssd_operands(B, S, H, P, G, N, dtype, device, a_log_max=1.5,
                  dt_max=0.1, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)
    return (t(rng.normal(size=(B, S, H, P))),
            t(rng.uniform(0.001, dt_max, (B, S, H)), torch.float32),
            t(rng.uniform(0.0, a_log_max, H), torch.float32),
            t(rng.normal(size=(B, S, G, N))), t(rng.normal(size=(B, S, G, N))))


def _ssd_agrees(got, want, dtype, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.isfinite().all()
        err = (g.float() - w.float()).abs()
        assert float((err - tol * w.float().abs()).max()) <= tol, \
            float(err.max())
    assert got[0].dtype == dtype and got[1].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 2048, 64, 64, 1, 128, 256),      # mamba2-1.3b's prefill
    (1, 2048, 80, 64, 1, 64, 256),       # zamba2-2.7b's prefill
    (2, 512, 4, 64, 1, 128, 128),        # tests/test_kernels.py's shapes
    (1, 256, 8, 64, 2, 128, 256),
    (2, 256, 4, 64, 4, 128, 128),
    (1, 100, 3, 32, 1, 32, 20),          # a chunk that no tile divides
    (2, 64, 4, 16, 1, 16, 16)])          # the smoke configs'
def test_ssd_scan_kernel_matches_plain_version(cuda, B, S, H, P, G, N,
                                               chunk, dtype, tol):
    """y and the final state within ``tol`` (atol and rtol) of the plain
    version's: the reference's 5e-5 in float32, and in bf16 the output's
    rounding."""
    args = _ssd_operands(B, S, H, P, G, N, dtype, cuda,
                         a_log_max=math.log(16) if S == 2048 else 1.5)
    before = ssd_mod.ssd_scan.launches
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan.launches == before + 1
    _ssd_agrees(got, ssd_scan_ref(*args, chunk), dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ssd_scan_kernel_under_strong_decay(cuda, dtype, tol):
    """A up to 16 and dt up to 1: exp(cum_i - cum_j) would overflow above
    the diagonal, where the kernel never computes it; no NaN."""
    args = _ssd_operands(1, 2048, 64, 64, 1, 128, dtype, cuda,
                         a_log_max=math.log(16), dt_max=1.0)
    got = ssd_mod.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    _ssd_agrees(got, ssd_scan_ref(*args, 256), dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dt_max", [
    (1, 2048, 80, 64, 1, 64, 256, 1.0),   # zamba2-2.7b, strong decay
    (1, 4096, 8, 64, 1, 128, 256, 0.1),   # 16 chunks
    (1, 256, 8, 64, 1, 128, 16, 0.1),     # 16 chunks of 16
    (1, 256, 64, 64, 1, 128, 256, 1.0),   # a one-chunk prompt
    (2, 300, 4, 64, 2, 32, 100, 0.1),     # ragged tiles, N = 32
    (1, 320, 4, 32, 1, 64, 160, 0.1)])    # the CUDA-core body in bf16
def test_ssd_scan_each_design(cuda, B, S, H, P, G, N, chunk, dt_max, dtype,
                              tol):
    """Each body (``design``: tensor cores for bf16 at P = 64 and N = 32,
    64 or 128, the CUDA cores otherwise) within ``tol`` of the plain
    version, finite under strong decay (A up to 16, dt up to 1), and a
    second call equal bit for bit: the states pass from chunk to chunk in
    a fixed order, with no atomics."""
    args = _ssd_operands(B, S, H, P, G, N, dtype, cuda,
                         a_log_max=math.log(16), dt_max=dt_max)
    tc = dtype == torch.bfloat16 and P == 64 and N in (32, 64, 128)
    assert ssd_mod.design(dtype, P, N, chunk) == ("tensor-cores" if tc
                                                  else "cuda-cores")
    before = ssd_mod.ssd_scan.launches
    got = ssd_mod.ssd_scan(*args, chunk=chunk)
    again = ssd_mod.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan.launches == before + 2
    _ssd_agrees(got, ssd_scan_ref(*args, chunk), dtype, tol)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_ssd_scan_kernel_rejects_bad_operands(cuda):
    x, dt, a_log, b, c = _ssd_operands(1, 64, 4, 64, 2, 128, torch.float32,
                                       cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_mod.ssd_scan(x.half(), dt, a_log, b.half(), c.half(), chunk=16)
    with pytest.raises(TypeError, match="b must be"):
        ssd_mod.ssd_scan(x, dt, a_log, b.bfloat16(), c, chunk=16)
    with pytest.raises(TypeError, match="dt must be"):
        ssd_mod.ssd_scan(x, dt.double(), a_log, b, c, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                         dt, a_log, b, c, chunk=16)
    with pytest.raises(ValueError, match="divide"):
        ssd_mod.ssd_scan(x, dt, a_log, b, c, chunk=48)
    with pytest.raises(ValueError, match="head dims"):
        ssd_mod.ssd_scan(x[..., :48].contiguous(), dt, a_log, b, c,
                         chunk=16)
    with pytest.raises(ValueError, match="groups"):
        ssd_mod.ssd_scan(x[:, :, :3].contiguous(), dt[..., :3].contiguous(),
                         a_log[:3].contiguous(), b, c, chunk=16)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_mod.ssd_scan(x, dt, a_log.cpu(), b, c, chunk=16)
    long = _ssd_operands(1, 16384, 4, 64, 2, 128, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_mod.ssd_scan(*long, chunk=16384)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b"])
def test_state_space_serving_on_card_matches_cpu(cuda, arch):
    """The smoke configs (chunk 16) in float32 serve the same requests on
    the card, through K5, and on the CPU, through its plain version: a
    one-token prompt, prompts across chunks, slots reused; equal tokens,
    and K5 launched once per layer and prefill of more than one token."""
    cfg = smoke_config(arch)
    cpu_model = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    lens = (1, 12, 37, 9, 20)
    outputs = {}
    for dev, model in (("cuda", copy.deepcopy(cpu_model)), ("cpu",
                                                            cpu_model)):
        eng = ServingEngine(cfg, model, n_slots=3, max_len=64, device=dev)
        rng = np.random.default_rng(0)
        for i, n in enumerate(lens):
            eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, n),
                               max_tokens=6, arrival_s=0.0))
        before = ssd_mod.ssd_scan.launches
        while eng.queue or eng.cache_mgr.active():
            eng.admit()
            eng.step()
        launches = ssd_mod.ssd_scan.launches - before
        assert launches == (sum(n > 1 for n in lens) * cfg.n_layers
                            if dev == "cuda" else 0)
        assert eng.metrics.completed == len(lens)
        outputs[dev] = [eng.requests[f"r{i}"].output
                        for i in range(len(lens))]
    assert outputs["cuda"] == outputs["cpu"]


def _flash_operands(B, Sq, Skv, Hq, Hkv, D, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                            device=device)
            for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                          (B, Skv, Hkv, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [
    (2, 256, 256, 4, 2, 64),       # tests/test_kernels.py's shapes
    (1, 384, 384, 2, 2, 256),
    (2, 300, 300, 16, 16, 80),     # hubert's heads, a partial tile
    (1, 520, 520, 32, 8, 128),     # pixtral's group of 4
    (2, 70, 333, 28, 4, 14),       # qwen2 smoke's head dim, G = 7, Sq < Skv
    (1, 200, 77, 4, 1, 32)])       # Sq > Skv
def test_flash_attention_kernel_matches_plain_version(cuda, B, Sq, Skv, Hq,
                                                      Hkv, D, dtype, tol,
                                                      causal):
    """Any lengths, groups and head dims up to 256; causal is top-left
    aligned. The bf16 bar covers the weights' rounding, which the kernel
    and the plain version take at different running maxima."""
    q, k, v = _flash_operands(B, Sq, Skv, Hq, Hkv, D, dtype, cuda)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,dtype,causal,design", [
    (2, 300, 300, 16, 16, 80, torch.bfloat16, False, "wgmma-tma"),
    (2, 300, 300, 16, 16, 80, torch.bfloat16, True, "wgmma-tma"),
    (1, 640, 640, 32, 8, 128, torch.bfloat16, True, "wgmma-tma"),
    (2, 130, 513, 8, 2, 128, torch.bfloat16, True, "wgmma-tma"),
    (2, 513, 130, 8, 2, 64, torch.bfloat16, False, "wgmma-tma"),
    (1, 257, 129, 4, 4, 64, torch.bfloat16, True, "wgmma-tma"),
    (1, 1, 1, 2, 2, 128, torch.bfloat16, True, "wgmma-tma"),
    (1, 3, 700, 4, 4, 80, torch.bfloat16, False, "wgmma-tma"),
    (1, 384, 384, 2, 2, 256, torch.bfloat16, True, "mma.sync"),
    (1, 200, 77, 4, 1, 32, torch.bfloat16, False, "mma.sync"),
    (2, 300, 300, 16, 16, 80, torch.float32, False, "cuda-cores"),
    (1, 520, 520, 32, 8, 128, torch.float32, True, "cuda-cores")])
def test_flash_attention_each_design(cuda, B, Sq, Skv, Hq, Hkv, D, dtype,
                                     causal, design):
    """Each body at the widths that pick it: D = 80 over partial tiles,
    D = 128 causal at G = 4, Sq != Skv both ways (one query row of one key,
    three rows of 700 keys), and D = 256, D = 32 and
    float32 on the kept mma.sync and CUDA-core bodies; one launch each,
    within the bars of the test above, and the same bits on a second
    call."""
    assert flash_mod.design(D, dtype) == design
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    q, k, v = _flash_operands(B, Sq, Skv, Hq, Hkv, D, dtype, cuda, seed=D)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention.launches == before + 1
    assert got.isfinite().all()
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_bad_operands(cuda):
    q, k, v = _flash_operands(2, 64, 64, 8, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="like q"):
        flash_mod.flash_attention(q, k.bfloat16(), v, causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_mod.flash_attention(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mod.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v, causal=True)
    with pytest.raises(ValueError, match="head dims up to 256"):
        wide = _flash_operands(1, 8, 8, 2, 2, 320, torch.float32, cuda)
        flash_mod.flash_attention(*wide, causal=True)
    with pytest.raises(ValueError, match="do not group"):
        flash_mod.flash_attention(q[:, :, :7].contiguous(), k, v,
                                  causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_mod.flash_attention(q, k.cpu(), v, causal=True)
    with pytest.raises(ValueError, match="k's shape"):
        flash_mod.flash_attention(q, k, v[:, :32].contiguous(), causal=True)


@pytest.mark.cuda
def test_flash_attention_has_no_backward(cuda):
    q, k, v = _flash_operands(1, 16, 16, 2, 2, 32, torch.float32, cuda)
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="training"):
        out.sum().backward()


@pytest.mark.cuda
def test_cacheless_forward_on_card_matches_cpu(cuda):
    """hubert's encode (2 clips of 70 frames) and pixtral's train_loss
    (with its 8-patch prefix) on the smoke configs in float32: the card,
    through K4 (one launch per layer), against the CPU, through its plain
    version."""
    rng = np.random.default_rng(0)
    for arch in ("hubert_xlarge", "pixtral_12b"):
        cfg = smoke_config(arch)
        cpu_model = init_params(cfg, seed=0, device="cpu",
                                dtype=torch.float32)
        card_model = copy.deepcopy(cpu_model).to(cuda)
        if arch == "hubert_xlarge":
            batch = {"frames": torch.as_tensor(
                rng.normal(size=(2, 70, cfg.frontend.d_in)),
                dtype=torch.float32)}
            run = encode
        else:
            batch = {"tokens": torch.as_tensor(
                         rng.integers(0, cfg.vocab_size, (2, 70))),
                     "labels": torch.as_tensor(
                         rng.integers(0, cfg.vocab_size, (2, 70))),
                     "patches": torch.as_tensor(
                         rng.normal(size=(2, 8, cfg.frontend.d_in)),
                         dtype=torch.float32)}
            run = lambda m, b: train_loss(m, b)[0]  # noqa: E731
        before = flash_mod.flash_attention.launches
        got = run(card_model, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert flash_mod.flash_attention.launches == before + cfg.n_layers
        want = run(cpu_model, batch)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def _gmm_operands(n_tok, e, k, n, blk, dtype, device, seed=0):
    """Assignments of n_tok tokens to e experts (a fifth dropped), sorted
    into the model path's static buffer (tiles of -1 past the last
    group)."""
    rng = np.random.default_rng(seed)
    eids = torch.as_tensor(rng.integers(0, e, n_tok), device=device)
    keep = torch.as_tensor(rng.random(n_tok) < 0.8, device=device)
    srt = gmm_mod.sort_assignments(eids, keep, e, blk)
    lhs = torch.zeros(srt.rows + 1, k, device=device)
    lhs[srt.dest] = torch.as_tensor(rng.normal(size=(n_tok, k)),
                                    dtype=torch.float32, device=device)
    rhs = torch.as_tensor(rng.normal(size=(e, k, n)) / math.sqrt(k),
                          dtype=dtype, device=device)
    return lhs[:srt.rows].to(dtype), rhs, srt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_tok,e,k,n,blk", [
    (300, 4, 128, 256, 128), (1000, 8, 256, 128, 128), (64, 2, 128, 128, 16),
    (96, 64, 2048, 1408, 16), (700, 64, 1408, 2048, 64), (50, 3, 48, 80, 32)])
def test_grouped_matmul_kernel_matches_plain_version(cuda, n_tok, e, k, n,
                                                     blk, dtype, tol):
    """The reference tests' shapes, deepseek-moe's decode (16 tokens x
    top-6 over 64 experts, gate: 2048 -> 1408) and down-projection shapes,
    and K, N that no tile divides; every blk_m the model path takes. Within
    ``tol`` of the plain version's scale (float32 sums in another order;
    in bf16, one rounding of each either way)."""
    lhs, rhs, srt = _gmm_operands(n_tok, e, k, n, blk, dtype, cuda)
    before = gmm_mod.grouped_matmul.launches
    got = ops.grouped_matmul(lhs, rhs, srt.tile_expert, blk_m=blk)
    torch.cuda.synchronize()
    assert gmm_mod.grouped_matmul.launches == before + 1
    want = grouped_matmul_ref(lhs, rhs, srt.tile_expert, blk)
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= tol, err
    assert not got.view(-1, blk, n)[srt.tile_expert < 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [64, 128])
@pytest.mark.parametrize("n_tok,e,k,n", [
    (400, 5, 144, 272),                  # a K tail and a column tail
    (2048 * 6, 64, 2048, 1408),          # deepseek-moe's prompt: gate/up
    (2048 * 6, 64, 1408, 2048)])         # and down
def test_grouped_matmul_wgmma_body(cuda, n_tok, e, k, n, blk):
    """The wgmma/TMA body (bf16 at blk_m 64 and 128): K = 144 reads a
    zero-filled tail of its last 64-deep stage, within the expert's slab;
    N = 272 ends in a partial tile whose columns past N are not stored;
    a fifth of the assignments dropped leaves tiles of -1 past the last
    group, which must come out zero. Within the bf16 bar of the plain
    version's scale, and a second call equal bit for bit."""
    assert gmm_mod.design(blk, torch.bfloat16) == "wgmma-tma"
    lhs, rhs, srt = _gmm_operands(n_tok, e, k, n, blk, torch.bfloat16, cuda)
    assert bool((srt.tile_expert < 0).any())
    got = gmm_mod.grouped_matmul(lhs, rhs, srt.tile_expert, blk_m=blk)
    again = gmm_mod.grouped_matmul(lhs, rhs, srt.tile_expert, blk_m=blk)
    torch.cuda.synchronize()
    want = grouped_matmul_ref(lhs, rhs, srt.tile_expert, blk)
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= 2e-2, err
    assert not got.view(-1, blk, n)[srt.tile_expert < 0].any()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("blk,dtype", [(16, torch.bfloat16),
                                       (32, torch.bfloat16),
                                       (64, torch.float32)])
def test_grouped_matmul_is_deterministic(cuda, blk, dtype):
    """The mma.sync and CUDA-core bodies give the same bits on a second
    call too."""
    lhs, rhs, srt = _gmm_operands(300, 8, 144, 272, blk, dtype, cuda)
    first = gmm_mod.grouped_matmul(lhs, rhs, srt.tile_expert, blk_m=blk)
    second = gmm_mod.grouped_matmul(lhs, rhs, srt.tile_expert, blk_m=blk)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_grouped_matmul_kernel_rejects_bad_operands(cuda):
    lhs, rhs, srt = _gmm_operands(40, 4, 64, 32, 16, torch.bfloat16, cuda)
    te = srt.tile_expert
    with pytest.raises(ValueError, match="blk_m"):
        gmm_mod.grouped_matmul(lhs, rhs, te, blk_m=8)
    with pytest.raises(ValueError, match="multiples of 16"):
        gmm_mod.grouped_matmul(lhs[:, :40].contiguous(),
                               rhs[:, :40].contiguous(), te, blk_m=16)
    with pytest.raises(TypeError, match="int32"):
        gmm_mod.grouped_matmul(lhs, rhs, te.long(), blk_m=16)
    with pytest.raises(TypeError, match="like lhs"):
        gmm_mod.grouped_matmul(lhs, rhs.float(), te, blk_m=16)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_mod.grouped_matmul(
            lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2), te,
            blk_m=16)
    with pytest.raises(ValueError, match="CUDA device"):
        gmm_mod.grouped_matmul(lhs, rhs.cpu(), te, blk_m=16)


@pytest.mark.cuda
def test_grouped_matmul_has_no_backward(cuda):
    lhs, rhs, srt = _gmm_operands(40, 4, 64, 32, 16, torch.float32, cuda)
    out = ops.grouped_matmul(lhs, rhs.requires_grad_(), srt.tile_expert,
                             blk_m=16)
    with pytest.raises(NotImplementedError, match="K6"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 37, 512), (2, 256, 128), (7, 64),
                                   (16, 256, 2048), (3, 5120), (5, 33)])
def test_fused_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    """The reference tests' shapes, deepseek's width, pixtral's 5120 and a
    width with no 16-byte vectors (33): y and s within 1e-5 in float32 and
    one bf16 ulp of each element in bf16."""
    rng = np.random.default_rng(shape[-1])
    x, res = (torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                              device=cuda) for _ in range(2))
    sc = torch.as_tensor(rng.normal(size=shape[-1:]) * 0.1, dtype=dtype,
                         device=cuda)
    before = rms_mod.fused_rmsnorm.launches
    got = ops.fused_rmsnorm(x, res, sc)
    torch.cuda.synchronize()
    assert rms_mod.fused_rmsnorm.launches == before + 1
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=0.0))
    for g, w in zip(got, fused_rmsnorm_ref(x, res, sc)):
        assert g.dtype == dtype and g.shape == shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.cuda
def test_fused_rmsnorm_has_no_backward(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    y, s = ops.fused_rmsnorm(x, torch.randn_like(x),
                             torch.zeros(64, device=cuda))
    with pytest.raises(NotImplementedError, match="K7"):
        (y.sum() + s.sum()).backward()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b"])
def test_moe_serving_on_card_matches_cpu(cuda, arch):
    """The smoke config with one head of 64 (K3's smallest head dim) in
    float32, 3 requests through 2 slots: the card (K6 three times per MoE
    layer and model call, K3 in deepseek-moe's decode attention) gives the
    CPU's tokens."""
    cfg = smoke_config(arch).scaled(n_heads=1, n_kv_heads=1)
    model = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 20, 13)]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, copy.deepcopy(model), n_slots=2, max_len=48,
                            device=dev)
        before = gmm_mod.grouped_matmul.launches
        for i, pr in enumerate(prompts):
            eng.submit(Request(f"r{i}", pr, max_tokens=5, arrival_s=0.0))
        calls = 0
        while eng.queue or eng.cache_mgr.active():
            calls += eng.admit()
            calls += 1 if eng.step() else 0
        outs[dev] = [eng.requests[f"r{i}"].output for i in range(3)]
        moe_layers = cfg.n_layers - cfg.moe.first_dense_layers
        if dev == "cuda":
            assert gmm_mod.grouped_matmul.launches - before \
                == 3 * moe_layers * calls
    assert outs["cuda"] == outs["cpu"]


def _kernel_launches() -> dict:
    """Every kernel wrapper's launch count (K1-K7 and the per-tick
    kernels)."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     fused_tick, grouped_matmul, rls_update,
                                     rmsnorm, ssd_scan)
    fns = (fused_tick.fused_tick, fused_tick.fused_interval,
           rls_update.rls_rank1_update, rls_update.arima_chunk,
           decode_attention.decode_attention, ssd_scan.ssd_scan,
           flash_attention.flash_attention, grouped_matmul.grouped_matmul,
           rmsnorm.fused_rmsnorm)
    return {f.__name__: f.launches for f in fns}


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One train step of the dense smoke config in float32 (TF32 off), with
    compression and accumulation, from the same parameters on the card and
    on the CPU: loss and grad norm within 1e-5, and the error feedback and
    parameters as the CPU's (parameters within 1e-5 of each tensor's
    scale) but where a gradient within float32 rounding of a tie of its
    int8 code took the neighbouring code on one device: there the residual
    differs by exactly one quantum and the parameter by at most 2 lr
    (``helpers.int8_ties``); the step launches none of the port's
    kernels."""
    from repro_torch import training
    cfg = smoke_config("deepseek_7b").scaled(attention_impl="reference",
                                             dtype="float32")
    tc = training.TrainConfig(
        optimizer=training.OptimizerConfig(lr=1e-3, warmup_steps=0,
                                           eps=1e-3),
        accum_steps=2, compress_grads=True)
    batch = training.make_pipeline(cfg, training.DataConfig(4, 16)).batch(0)
    base = init_params(cfg, seed=0, device="cpu")
    out = {}
    launches = _kernel_launches()
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(base).to(dev)
            state = training.init_train_state(model, tc)
            with int8_ties.compression_inputs() as calls:
                model, state, m = training.make_train_step(cfg, tc)(
                    model, state, {k: torch.from_numpy(v).to(dev)
                                   for k, v in batch.items()})
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {n: p.detach().cpu()
                         for n, p in model.named_parameters()},
                        {n: e.cpu() for n, e in state["ef"].items()},
                        calls[0], float(m["lr"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    (lc, gc, pc, ec, _, _), (lh, gh, ph, eh, call, lr) = \
        out["cuda"], out["cpu"]
    assert launches == _kernel_launches()
    assert lc == pytest.approx(lh, rel=1e-5)
    assert gc == pytest.approx(gh, rel=1e-5)
    parted = int8_ties.assert_only_ties_part(call, ec, eh, pc, ph, lr=lr,
                                             bar=1e-5, names=list(ph))
    assert parted <= 1e-4 * sum(p.numel() for p in ph.values()), parted


@pytest.mark.cuda
def test_checkpoint_saved_on_card_restores_on_cpu(cuda, tmp_path):
    """A trainer's tree saved on the card restores onto the CPU (the
    like tree moved there by ``rescale``) bit for bit, bf16 included."""
    from repro_torch.distributed import rescale
    from repro_torch.training import CheckpointManager
    cfg = smoke_config("deepseek_7b")
    model = init_params(cfg, seed=3, device="cuda")
    tree = {"params": dict(model.named_parameters()),
            "step": torch.tensor(4, dtype=torch.int32, device="cuda")}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree, blocking=True)
    step, back = mgr.restore(like=rescale(tree, "cpu"))
    assert step == 4
    for name, p in tree["params"].items():
        q = back["params"][name]
        assert q.device.type == "cpu" and q.dtype == p.dtype
        assert torch.equal(q, p.detach().cpu())
    assert int(back["step"]) == 4


@pytest.mark.cuda
def test_gp_fit_kernel_matches_plain_version(cuda):
    """The GP bank's fit kernel against its plain version
    (``kernels.ref.gp_lbfgs_ref``: the batched L-BFGS over the autograd
    objective) on the card: the first two
    iterates within 1e-3 of theta's scale, and the members' best
    objectives after the full fit within 1e-3 relative."""
    from repro_torch.core.gp import neg_mll_and_grad, restart_inits
    from repro_torch.kernels.gp_fit import gp_lbfgs
    from repro_torch.kernels.ref import gp_lbfgs_ref
    rng = np.random.default_rng(5)
    B, n, d, R = 6, 16, 5, 2
    x = rng.uniform(0, 1, (B, n, d))
    y = rng.normal(0, 1, (B, n))
    mask = np.ones((B, n))
    mask[::2, 11:] = 0.0
    y *= mask
    t0 = np.concatenate([restart_inits(d, R, 7 * i) for i in range(B)])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device="cuda")
    x, y, mask, t0 = f32(x), f32(y), f32(mask), f32(t0)
    xr, yr, mr = (t.repeat_interleave(R, dim=0) for t in (x, y, mask))
    for it in (1, 2):
        got, counts, _ = gp_lbfgs(x, y, mask, t0, restarts=R, max_iter=it)
        want, _ = gp_lbfgs_ref(x, y, mask, t0, R, it)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-3
        assert (counts == it).all()
    got, _, evals = gp_lbfgs(x, y, mask, t0, restarts=R, max_iter=60)
    want, _ = gp_lbfgs_ref(x, y, mask, t0, R, 60)
    fk = neg_mll_and_grad(got, xr, yr, mr)[0].reshape(B, R).min(1).values
    fp = neg_mll_and_grad(want, xr, yr, mr)[0].reshape(B, R).min(1).values
    assert float(((fk - fp).abs() / fp.abs().clamp_min(1.0)).max()) < 1e-3
    _, counts, _ = gp_lbfgs(x, y, mask, t0, restarts=R, max_iter=60)
    assert ((counts >= 1) & (counts <= 60) & (evals > counts)).all()


def _card_probes():
    """Every probe of the port's five registries, built on the card."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from check_contracts_torch import registries
    out = {}
    for reg in registries():
        for name in reg:
            probes = reg.contract_for(name)("cuda")
            for p in probes if isinstance(probes, list) else [probes]:
                out[p.contract.name] = p
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["engine:fused", "forecast backend:bank",
                                  "kernel:gp-lbfgs"])
def test_kernel_probe_replays_from_a_cuda_graph(cuda, name):
    """K2's interval, K1's chunk and the GP fit kernel are captured in a
    CUDA graph and replayed bit-equal to the eager call, launches counted
    on the card."""
    from repro_torch.analysis.contracts import run_probe
    probe = _card_probes()[name]
    assert probe.contract.graph_capturable and probe.device == "cuda"
    report = run_probe(probe)
    assert report.ok, report.summary()
    assert report.skipped == ()
    assert report.launches == dict(probe.contract.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["engine:fused", "kernel:fused-tick",
                                  "engine:sharded", "fit backend:bank",
                                  "kernel:gp-lbfgs", "forecast backend:bank",
                                  "kernel:rls-rank1-update",
                                  "detector backend:bank",
                                  "fleet backend:ingest"])
def test_probe_never_syncs_on_the_card(cuda, name):
    """No host sync in any device probe, also under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.analysis.contracts import run_probe
    probe = _card_probes()[name]
    assert probe.contract.forbid_host_sync
    report = run_probe(probe)
    assert report.ok, report.summary()


@pytest.mark.cuda
def test_sync_debug_mode_catches_a_host_read(cuda):
    from repro_torch.analysis.contracts import (CompilationContract,
                                                check_contract)
    x = torch.ones(4, device="cuda")
    report = check_contract(lambda t: t * float(t.sum()), (x,),
                            CompilationContract(), device="cuda")
    assert not report.ok
    assert {v.field for v in report.violations} == {"forbid_host_sync"}
