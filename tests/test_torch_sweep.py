"""The port's sweep engines against the reference's.

* the port's ``batched`` and ``fused`` engines (``device="cpu"``) reproduce
  ``tests/golden/sweep_small.json`` and the reference ``run_sweep`` on the
  ``ragged`` case of ``tests/helpers/sharded_diff.py`` at 1e-12;
* the port's ``anomaly_triggers`` equal the reference fused engine's;
* a port and a reference fused executor started from the same mid-run
  state (carried across by ``repro_torch.interop``) step one interval to
  the same carry;
* the entry points run on the card unless asked for the CPU.
"""
import dataclasses
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

from helpers.sharded_diff import (GOLDEN_PATH, VOLATILE, _approx,  # noqa: E402
                                  _specs)
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.dsp import run_sweep as ref_run_sweep  # noqa: E402
from repro.dsp import workloads as jw  # noqa: E402
from repro.dsp.fused import FusedSweepExecutor as RefFused  # noqa: E402
from repro.dsp.sweep import SweepEngine as RefSweepEngine  # noqa: E402
from repro_torch.core import EngineConfig  # noqa: E402
from repro_torch.dsp import (FusedSweepExecutor, ScenarioSpec,  # noqa: E402
                             SweepEngine, run_sweep)
from repro_torch.dsp import workloads as tw  # noqa: E402
from repro_torch.interop import (cluster_model_from_dict,  # noqa: E402
                                 fused_state_from_arrays,
                                 job_config_from_dict)

CPU_ENGINES = {"batched": EngineConfig(sim_backend="batched", device="cpu"),
               "fused": EngineConfig(sim_backend="fused", device="cpu")}


def _port_failures(f):
    """The reference's failure schedule as the port's."""
    if isinstance(f, jw.NoFailures):
        return tw.NoFailures()
    if isinstance(f, jw.PeriodicFailures):
        return tw.PeriodicFailures(f.interval_s, f.offset_s)
    if isinstance(f, jw.FailuresAt):
        return tw.FailuresAt(*f.at_s)
    if isinstance(f, jw._UnionSchedule):
        return _port_failures(f.a) | _port_failures(f.b)
    raise TypeError(f"no port counterpart for {f!r}")


def port_specs(ref_specs):
    """The reference's ScenarioSpecs rebuilt from plain values."""
    return [ScenarioSpec(trace=tw.Trace(rates=np.array(s.trace.rates),
                                        dt_s=s.trace.dt_s, name=s.trace.name),
                         controller=s.controller, seed=s.seed,
                         failures=_port_failures(s.failures), label=s.label,
                         forecaster=s.forecaster)
            for s in ref_specs]


def _digest(result) -> dict:
    return {k: v for k, v in result.to_json().items() if k not in VOLATILE}


@pytest.fixture(scope="module")
def ragged_reference():
    specs = _specs("ragged")
    batched = ref_run_sweep(specs)
    eng = RefSweepEngine(specs, config=RefEngineConfig(sim_backend="fused"))
    fused = eng.run()
    return batched, fused, eng.executor.anomaly_triggers


@pytest.mark.parametrize("engine", sorted(CPU_ENGINES))
def test_engine_reproduces_golden(engine):
    res = run_sweep(port_specs(_specs("golden")),
                    config=CPU_ENGINES[engine])
    assert res.engine == engine
    _approx(_digest(res), json.loads(GOLDEN_PATH.read_text()), 1e-12)


@pytest.mark.parametrize("engine", sorted(CPU_ENGINES))
def test_engine_matches_reference_on_ragged_grid(engine, ragged_reference):
    ref_batched, ref_fused, _ = ragged_reference
    res = run_sweep(port_specs(_specs("ragged")), config=CPU_ENGINES[engine])
    for want in (ref_batched, ref_fused):
        _approx(_digest(res), _digest(want), 1e-12)
        for a, b in zip(res.scenarios, want.scenarios):
            assert a.name == b.name
            assert a.allclose(b, rtol=1e-12, atol=1e-12), a.name


@pytest.mark.parametrize("case", ["ragged", "golden"])
def test_anomaly_triggers_match_reference_fused_engine(case,
                                                       ragged_reference):
    if case == "ragged":
        want = ragged_reference[2]
    else:
        ref = RefSweepEngine(_specs(case),
                             config=RefEngineConfig(sim_backend="fused"))
        ref.run()
        want = ref.executor.anomaly_triggers
    eng = SweepEngine(port_specs(_specs(case)), config=CPU_ENGINES["fused"])
    eng.run()
    np.testing.assert_array_equal(eng.executor.anomaly_triggers, want)
    assert want.sum() > 0        # the detector did fire somewhere


def test_interop_mid_run_state_gives_the_same_interval():
    # Run the reference for a few intervals, carry its whole state across
    # (model and configs by dict, host mirror and RNG streams by value,
    # device state through fused_state_from_arrays), then step the same
    # interval, with a failure inside it, on both.
    from repro.dsp.simulator import ClusterModel as RefModel
    from repro.dsp.simulator import JobConfig as RefJob
    S, n_steps = 6, 60
    ref_cfgs = [RefJob(workers=w) for w in (24, 12, 6, 3, 18, 9)]
    ref_model = RefModel()
    seeds = list(range(10, 10 + S))
    rng = np.random.default_rng(7)
    R = rng.uniform(2e4, 8e4, (n_steps, S))
    ref = RefFused(ref_model, ref_cfgs, seeds, dt=5.0, n_steps=n_steps)
    inject = np.zeros((12, S), bool)
    inject[3, 1] = inject[7, 4] = True
    ref.step_interval(R[:12], inject)
    ref.step_interval(R[12:24])

    port = FusedSweepExecutor(
        cluster_model_from_dict(dataclasses.asdict(ref_model)),
        [job_config_from_dict(dataclasses.asdict(c)) for c in ref_cfgs],
        seeds, dt=5.0, n_steps=n_steps, device="cpu")
    for f in ("downtime_left_s", "since_checkpoint_s", "last_rate"):
        setattr(port.state, f, getattr(ref.state, f)[:S].copy())
    for a, b in zip(port.rngs.rngs, ref.rngs.rngs[:S]):
        a.bit_generator.state = b.bit_generator.state
    port.rngs._buf[:] = ref.rngs._buf[:S]
    port.rngs._pos[:] = ref.rngs._pos[:S]
    port._lag_add[:] = ref._lag_add[:S]
    arrays = {"lag": ref._lag, "det_w": ref._det_w, "det_p": ref._det_p,
              "det_y": ref._det_y, "det_trig": ref._det_trig}
    port.load_device_state(fused_state_from_arrays(
        {k: np.asarray(v)[:S] for k, v in arrays.items()}, device="cpu"))
    port.step_index = ref.step_index

    inject = np.zeros((12, S), bool)
    inject[0, 2] = inject[11, 5] = True
    want = ref.step_interval(R[24:36], inject)
    got = port.step_interval(R[24:36], inject)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    carry = port.device_state()
    for k, v in arrays.items():
        ref_now = np.asarray(getattr(ref, f"_{k}"))[:S]
        np.testing.assert_allclose(carry[k].numpy(), ref_now, rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(port._lag_add, ref._lag_add[:S])
    for f in ("downtime_left_s", "since_checkpoint_s", "lag_events"):
        np.testing.assert_allclose(getattr(port.state, f),
                                   getattr(ref.state, f)[:S], rtol=1e-12)


def test_fused_state_from_arrays_rejects_mismatched_rows():
    arrays = {"lag": np.zeros(3), "det_w": np.zeros((3, 2)),
              "det_p": np.zeros((3, 2, 2)), "det_y": np.zeros(2),
              "det_trig": np.zeros(3, np.int64)}
    with pytest.raises(ValueError, match="det_y"):
        fused_state_from_arrays(arrays, device="cpu")


def test_run_sweep_defaults_to_the_card():
    assert EngineConfig().device == "cuda"
    specs = port_specs(_specs("golden"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep(specs)


def test_unknown_controller_lists_the_registered_ones():
    trace = tw.make_trace("diurnal", duration_s=60.0)
    with pytest.raises(ValueError, match=r"unknown controller 'pid'; "
                       r"available: \('demeter', 'ds2', 'reactive', "
                       r"'static'\)"):
        ScenarioSpec(trace=trace, controller="pid")
    with pytest.raises(ValueError, match=r"unknown forecaster 'prophet'; "
                       r"available: \('arima', 'holt', 'seasonal'\)"):
        ScenarioSpec(trace=trace, controller="demeter", forecaster="prophet")
    with pytest.raises(ValueError, match="unknown engine 'torch'"):
        EngineConfig(sim_backend="torch")
