"""The port's paper-protocol harness and scalar engine against the
reference's.

* ``run_experiment`` for all four methods on ``ysb_like`` (2 h, dt 10 s),
  seed 3, on the CPU against the reference's: every array at 1e-12 (as
  ``test_torch_demeter.py`` holds the sweep), equal reconfigurations and
  failure records. The profiling cost is held at 1e-12 under the scalar
  forecaster. Under the forecast bank the cost is held at 1e-7: the rates
  the profiling clones run at are binned forecasts, and on raw rates
  (~4e4 events/s) the bank's float64 RLS agrees with the reference's bank
  to ~5e-8 only (see ``test_torch_forecast.py``'s ``_stream``);
* ``measure_recovery`` equal to the reference's;
* ``ScalarSweepExecutor`` (``EngineConfig(sim_backend="scalar")``)
  reproduces the scalar leg of ``tests/golden/sweep_small.json`` bit for
  bit, and a Demeter grid with the bank detector in its profiling clones
  equals the grid with the scalar detector;
* ``DSPExecutor`` behind ``ScalarAdapter`` against the port's batched
  sweep executor and against the reference's ``DSPExecutor``.
"""
import json

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from helpers.sharded_diff import GOLDEN_PATH, VOLATILE, _specs  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.dsp import DSPExecutor as RefDSPExecutor  # noqa: E402
from repro.dsp import ClusterModel as RefModel  # noqa: E402
from repro.dsp import JobConfig as RefJob  # noqa: E402
from repro.dsp import SimJob as RefSimJob  # noqa: E402
from repro.dsp import measure_recovery as ref_measure_recovery  # noqa: E402
from repro.dsp import run_experiment as ref_run_experiment  # noqa: E402
from repro.dsp import ysb_like as ref_ysb_like  # noqa: E402
from repro_torch.core import EngineConfig, ScalarAdapter  # noqa: E402
from repro_torch.core.demeter import DemeterHyperParams  # noqa: E402
from repro_torch.dsp import (BatchedSweepExecutor, ClusterModel,  # noqa: E402
                             DSPExecutor, JobConfig, PeriodicFailures,
                             RunResult, ScalarSweepExecutor, ScenarioSpec,
                             SimJob, SweepEngine, baseline_config,
                             make_trace, measure_recovery, run_experiment,
                             run_sweep, ysb_like)
from test_torch_sweep import port_specs  # noqa: E402

METHODS = ("static", "reactive", "ds2", "demeter")
ARRAYS = ("times", "rates", "latencies", "usage_cpu", "usage_mem_mb",
          "workers")
#: profiling cost under the forecast bank (see the module docstring)
BANK_COST_BAR = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace():
    return ysb_like(duration_s=2 * 3600.0, dt_s=10.0)


def _records(res):
    return [(f.t_inject, f.workload, f.recovery_s, f.capped)
            for f in res.failures]


@pytest.mark.parametrize("method,forecast", [(m, "bank") for m in METHODS]
                         + [("demeter", "scalar")])
def test_run_experiment_matches_reference(method, forecast):
    want = ref_run_experiment(ref_ysb_like(duration_s=2 * 3600.0, dt_s=10.0),
                              method, seed=3, config=RefEngineConfig(
                                  forecast_backend=forecast))
    got = run_experiment(_trace(), method, seed=3, config=EngineConfig(
        device="cpu", forecast_backend=forecast))
    assert isinstance(got, RunResult)
    assert (got.method, got.trace) == (want.method, want.trace)
    for f in ARRAYS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert got.n_reconfigurations == want.n_reconfigurations
    assert _records(got) == _records(want) and got.failures
    bar = BANK_COST_BAR if forecast == "bank" else 1e-12
    for f in ("profile_cpu_s", "profile_mem_mb_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=bar)
    assert (got.profile_cpu_s > 0) == (method == "demeter")
    # the summary helpers of the paper's tables
    for name, args in (("cumulative_cpu_s", (False,)),
                       ("cumulative_mem_mb_s", (False,)),
                       ("frac_latency_below", (2.0,))):
        assert getattr(got, name)(*args) == \
            pytest.approx(getattr(want, name)(*args), rel=1e-12)
    assert got.recovery_times() == want.recovery_times()
    for a, b in zip(got.latency_ecdf(), want.latency_ecdf()):
        np.testing.assert_array_equal(a, b)


def test_run_experiment_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(_trace(), "static")


def test_run_experiment_schedule_duration_and_hp():
    res = run_experiment(_trace(), "demeter", seed=1, duration_s=1800.0,
                         failures_schedule=PeriodicFailures(600.0),
                         hp=DemeterHyperParams(profile_interval_s=600),
                         config=EngineConfig(device="cpu"))
    assert len(res.times) == 180
    assert [f.t_inject for f in res.failures] == [600.0, 1200.0]
    assert np.isfinite(res.latencies).all()
    with pytest.raises(ValueError, match="unknown method"):
        run_experiment(_trace(), "bogus", config=EngineConfig(device="cpu"))


@pytest.mark.parametrize("workers,rate", [(24, 50_000.0), (4, 45_000.0),
                                          (12, 90_000.0)])
def test_measure_recovery_matches_reference(workers, rate):
    cfg = dict(workers=workers, cpu_cores=2, memory_mb=2048, task_slots=2,
               checkpoint_interval_s=30.0)
    job = SimJob(ClusterModel(), JobConfig(**cfg), seed=workers)
    ref = RefSimJob(RefModel(), RefJob(**cfg), seed=workers)
    for _ in range(30):
        job.step(rate, 5.0)
        ref.step(rate, 5.0)
    got = measure_recovery(job, lambda t: rate, 0.0, 5.0)
    want = ref_measure_recovery(ref, lambda t: rate, 0.0, 5.0)
    assert got == want
    assert job.last == ref.last


def _digest(result) -> dict:
    return json.loads(json.dumps({k: v for k, v in result.to_json().items()
                                  if k not in VOLATILE}))


def test_scalar_engine_reproduces_golden_bit_for_bit():
    eng = SweepEngine(port_specs(_specs("golden")),
                      config=EngineConfig(sim_backend="scalar", device="cpu"))
    res = eng.run()
    assert isinstance(eng.executor, ScalarSweepExecutor)
    assert res.engine == "scalar"
    assert _digest(res) == json.loads(GOLDEN_PATH.read_text())


def _demeter_grid():
    trace = make_trace("diurnal", duration_s=1.5 * 3600.0)
    return [ScenarioSpec(trace=trace, controller="demeter", seed=s,
                         failures=PeriodicFailures(2700.0), forecaster=f)
            for s, f in ((0, "arima"), (1, "holt"))]


def test_demeter_grid_bank_detector_and_scalar_engine_agree():
    hp = DemeterHyperParams(profile_interval_s=600)
    base = EngineConfig(device="cpu", fit_backend="scalar", hp=hp)
    runs = {label: run_sweep(_demeter_grid(), config=base.replace(**kw))
            for label, kw in (("scalar", {}),
                              ("bank", dict(detector_backend="bank")),
                              ("scalar engine", dict(sim_backend="scalar")),
                              ("batched", dict(sim_backend="batched")))}
    ref = runs["scalar"]
    assert ref.n_model_fits > 0
    assert all(s.profile_cpu_s > 0 for s in ref.scenarios)
    for label, res in runs.items():
        assert res.n_model_fits == ref.n_model_fits, label
        for a, b in zip(res.scenarios, ref.scenarios):
            assert a.allclose(b, rtol=1e-12, atol=1e-12), (label, a.name)
            assert a.n_reconfigurations == b.n_reconfigurations
            assert a.profile_cpu_s == b.profile_cpu_s, label


def _fresh(seed=0):
    return DSPExecutor(ClusterModel(), JobConfig(), seed=seed, dt=5.0)


def test_dsp_executor_behind_adapter_matches_batched_executor():
    n_steps, dt = 24, 5.0
    execu = _fresh(0)
    adapter = ScalarAdapter(execu)
    batched = BatchedSweepExecutor(ClusterModel(), [JobConfig()], [0],
                                   dt=dt, n_steps=n_steps, device="cpu")
    for _ in range(n_steps):
        execu.step(45_000.0)
        batched.step(np.array([45_000.0]))
    a, b = adapter.observe_one(0), batched.observe_one(0)
    assert set(a) == set(b) == {"rate", "latency", "usage"}
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12)
    cfg = baseline_config(6).to_dict()
    assert adapter.allocated_cost(0, cfg) == batched.allocated_cost(0, cfg)
    assert adapter.cmax_config(0) == batched.cmax_config(0)
    arr = batched.observe()
    for k in b:
        assert arr[k][0] == pytest.approx(b[k], rel=1e-12)
    # profiling: the same seeds on both sides of the adapter
    cfgs = [baseline_config(4).to_dict(), baseline_config(8).to_dict()]
    assert adapter.profile([(0, c, 40_000.0) for c in cfgs]) == \
        batched.profile([(0, c, 40_000.0) for c in cfgs])


def test_dsp_executor_matches_reference():
    execu = _fresh(4)
    ref = RefDSPExecutor(RefModel(), RefJob(), seed=4, dt=5.0)
    for i in range(30):
        rate = 40_000.0 + 500.0 * i
        assert execu.step(rate) == ref.step(rate)
    assert execu.observe() == ref.observe()
    assert execu.window(60.0) == ref.window(60.0)
    cfgs = [baseline_config(4).to_dict(), baseline_config(8).to_dict()]
    assert execu.profile(cfgs, 40_000.0) == ref.profile(cfgs, 40_000.0)
    assert (execu.profile_cost.cpu_s, execu.profile_cost.mem_mb_s) == \
        (ref.profile_cost.cpu_s, ref.profile_cost.mem_mb_s)
    cfg = baseline_config(6).to_dict()
    execu.reconfigure(cfg)
    ref.reconfigure(cfg)
    assert execu.current_config() == ref.current_config() == cfg
    assert execu.allocated_cost(cfg) == ref.allocated_cost(cfg)
