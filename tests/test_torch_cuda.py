"""The port's CUDA kernels, fused engine and Demeter path on the card
(marker ``cuda``).

These need an NVIDIA GPU and skip without one; on the GPU machine, which
has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They hold the fused-tick and RLS kernels against their plain versions,
and the fused engine and a short Demeter sweep on the card against the
same runs on the CPU. ``chip_smoke.py`` does the same at the main path's
full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig
from repro_torch.core.demeter import DemeterHyperParams
from repro_torch.dsp import (FailuresAt, PeriodicFailures, ScenarioSpec,
                             SweepEngine, make_trace)
from repro_torch.kernels import fused_tick as kmod
from repro_torch.kernels import ops
from repro_torch.kernels import rls_update as rls_mod
from repro_torch.kernels.ref import fused_tick_ref, rls_rank1_update_ref

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
        before = kmod.fused_tick.launches
        res = eng.run()
        runs[dev] = (res, eng.executor.anomaly_triggers,
                     kmod.fused_tick.launches - before)
    assert runs["cuda"][2] == runs["cuda"][0].n_steps   # one launch a tick
    assert runs["cpu"][2] == 0
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
        before = rls_mod.rls_rank1_update.launches
        eng = SweepEngine(specs, config=EngineConfig(
            device=dev, fit_backend="scalar", hp=hp))
        res = eng.run()
        runs[dev] = (res, rls_mod.rls_rank1_update.launches - before,
                     eng.forecast_bank.arima_ticks)
    (card, launches, ticks), (cpu, cpu_launches, _) = runs["cuda"], \
        runs["cpu"]
    assert launches == ticks > 0 and cpu_launches == 0
    assert card.n_model_fits == cpu.n_model_fits > 0
    assert card.n_forecast_updates == cpu.n_forecast_updates
    for a, b in zip(card.scenarios, cpu.scenarios):
        assert a.allclose(b, rtol=1e-9), a.name

