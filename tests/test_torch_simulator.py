"""The port's simulator against the reference's NumPy simulator.

``step_batch_arrays`` in float64 torch on the CPU must be bit-equal to the
reference's ``ClusterModel.step_batch`` for the same state and draws, and
the port's NumPy copies (``ClusterModel.step_batch``, ``BatchedNormals``)
must stay bit-equal to the reference's.
"""
import dataclasses

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

from repro.dsp import simulator as jsim  # noqa: E402
from repro_torch.dsp import simulator as tsim  # noqa: E402
from repro_torch.interop import (cluster_model_from_dict,  # noqa: E402
                                 job_config_from_dict)

DT = 5.0
KEYS = ("rate", "throughput", "capacity", "consumer_lag", "latency",
        "utilization", "usage_cpu", "usage_mem_mb", "down")


def _states(n, seed):
    """Matching reference and port BatchStates: mixed configs, some rows
    down (downtime that ends mid-run), some with backlog."""
    rng = np.random.default_rng(seed)
    cfgs = [jsim.JobConfig(workers=int(rng.integers(1, 25)),
                           cpu_cores=int(rng.integers(1, 5)),
                           memory_mb=int(rng.choice([1024, 2048, 4096])),
                           task_slots=int(rng.integers(1, 4)),
                           checkpoint_interval_s=float(rng.choice([5., 10.,
                                                                   30.])))
            for _ in range(n)]
    ref = jsim.BatchState.from_configs(cfgs)
    ref.lag_events = rng.uniform(0.0, 2e5, n) * (rng.random(n) < 0.5)
    ref.downtime_left_s = rng.uniform(0.0, 40.0, n) * (rng.random(n) < 0.4)
    ref.since_checkpoint_s = rng.uniform(0.0, 10.0, n)
    port = tsim.BatchState(**{f.name: getattr(ref, f.name).copy()
                              for f in dataclasses.fields(ref)})
    return ref, port, [job_config_from_dict(dataclasses.asdict(c))
                       for c in cfgs]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_step_batch_arrays_is_bit_equal_to_reference_step_batch(seed):
    n, ticks = 23, 12
    rng = np.random.default_rng(1000 + seed)
    ref_state, host, _ = _states(n, seed)
    jmodel = jsim.ClusterModel()
    model = cluster_model_from_dict(dataclasses.asdict(jmodel))
    seeds = list(range(seed * 100, seed * 100 + n))
    ref_rngs = jsim.BatchedNormals(seeds)
    port_rngs = tsim.BatchedNormals(seeds)
    cap_base = jmodel.capacity_batch(ref_state)
    lag = torch.from_numpy(host.lag_events.copy())
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    for _ in range(ticks):
        rates = rng.uniform(1e4, 9e4, n)
        lag_add = rng.uniform(0.0, 5e3, n) * (rng.random(n) < 0.2)
        ref_state.lag_events = ref_state.lag_events + lag_add
        want = jmodel.step_batch(ref_state, rates, DT, ref_rngs,
                                 capacity_base=cap_base)
        # the host half the fused engine precomputes: clocks, then draws
        down_pre = host.downtime_left_s > 0.0
        host.downtime_left_s = np.where(
            down_pre, np.maximum(host.downtime_left_s - DT, 0.0),
            host.downtime_left_s)
        down_post = host.downtime_left_s > 0.0
        z1 = port_rngs.draw()
        z2 = np.abs(port_rngs.draw(~down_post))
        new_lag, got = tsim.step_batch_arrays(
            model, lag, f64(lag_add), f64(rates), f64(host.workers),
            f64(host.cpu_cores), f64(host.memory_mb), f64(host.task_slots),
            f64(cap_base), torch.from_numpy(down_pre),
            torch.from_numpy(down_post), f64(z1), f64(z2), DT)
        for k in KEYS:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
        lag = new_lag
    assert (host.downtime_left_s == ref_state.downtime_left_s).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_numpy_step_batch_copy_is_bit_equal_to_reference(seed):
    n = 17
    ref_state, port_state, port_cfgs = _states(n, seed)
    jmodel, model = jsim.ClusterModel(), tsim.ClusterModel()
    ref_rngs = jsim.BatchedNormals(range(n))
    port_rngs = tsim.BatchedNormals(range(n))
    np.testing.assert_array_equal(model.capacity_batch(port_state),
                                  jmodel.capacity_batch(ref_state))
    assert [model.capacity(c) for c in port_cfgs] == \
        [jmodel.capacity(ref_state.config_of(i)) for i in range(n)]
    rng = np.random.default_rng(seed)
    for t in range(30):
        rates = rng.uniform(1e4, 9e4, n)
        want = jmodel.step_batch(ref_state, rates, DT, ref_rngs)
        got = model.step_batch(port_state, rates, DT, port_rngs)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if t == 10:
            jmodel.inject_failure_batch(ref_state, 3)
            model.inject_failure_batch(port_state, 3)
    np.testing.assert_array_equal(port_rngs._pos, ref_rngs._pos)


def test_batched_normals_rows_are_buffered_streams():
    # row i of BatchedNormals is BufferedNormals(seeds[i]) whatever the mask
    seeds = [4, 9, 2]
    batched = tsim.BatchedNormals(seeds)
    scalars = [tsim.BufferedNormals(s) for s in seeds]
    rng = np.random.default_rng(0)
    for _ in range(50):
        mask = rng.random(3) < 0.6
        got = batched.draw(mask)
        for i, s in enumerate(scalars):
            assert got[i] == (s.standard_normal() if mask[i] else 0.0)
