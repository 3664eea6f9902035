"""The port's CUDA kernel and fused engine on the card (marker ``cuda``).

These need an NVIDIA GPU and skip without one; on the GPU machine, which
has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They hold the fused-tick kernel against its plain version and the fused
engine on the card against the same engine on the CPU. ``chip_smoke.py``
does the same at the main path's full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig
from repro_torch.dsp import (FailuresAt, PeriodicFailures, ScenarioSpec,
                             SweepEngine, make_trace)
from repro_torch.kernels import fused_tick as kmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_tick_ref

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
