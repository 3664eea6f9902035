"""The port's scenario mesh and its partitioned engines and banks (a port of
``tests/test_sweep_sharded.py`` under the port's names).

The reference splits one host into virtual XLA devices in a subprocess;
the port's CPU host partitions come from ``REPRO_TORCH_HOST_DEVICES``,
read whenever a mesh is built, so every case here runs in-process with the
variable set by ``monkeypatch``:

* ``BatchState`` pad/unpad and the host mirror against the reference's on
  the same configs;
* the ``"sharded"`` and ``"fused"`` engines against ``"batched"`` and
  ``"scalar"`` at 1, 2 and 4 host partitions, uniform and ragged, with
  failures and reconfigurations (rtol 1e-9; on the CPU they agree bit for
  bit), and against the reference's ``ShardedSweepExecutor`` and
  ``BatchedSweepExecutor`` run in-process as the reference's own tests run
  them;
* the ``"engine:sharded"`` contract (no collective, lag in place);
* ``EngineConfig`` device validation, case for case with the reference's;
* ``GPBank.fit``/``batched_posterior`` at 1 and 3 partitions and
  ``ForecastBank`` at 1 and 4, member by member, and a Demeter grid at
  ``devices=4`` against ``devices=1``.
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

import repro.dsp as ref_dsp  # noqa: E402
from helpers.sharded_diff import VOLATILE, _approx, _specs  # noqa: E402
from repro_torch.core import (DemeterHyperParams, EngineConfig,  # noqa: E402
                              ForecastBank, GPBank, batched_posterior)
from repro_torch.distributed.mesh import (  # noqa: E402
    HOST_DEVICES_ENV, device_count_hint, force_host_device_env,
    pad_to_multiple, partition_bounds, scenario_mesh)
from repro_torch.dsp import (BatchedSweepExecutor, BatchState,  # noqa: E402
                             ClusterModel, FusedSweepExecutor, JobConfig,
                             NoFailures, PeriodicFailures, ScenarioSpec,
                             ShardedSweepExecutor, SweepEngine, make_trace,
                             run_sweep)
from test_torch_sweep import port_specs  # noqa: E402

MODEL = ClusterModel()
PARTITIONS = (1, 2, 4)


@pytest.fixture
def host4(monkeypatch):
    """Four CPU host partitions visible."""
    monkeypatch.setenv(HOST_DEVICES_ENV, "4")


def _digest(result) -> dict:
    return {k: v for k, v in result.to_json().items() if k not in VOLATILE}


# ---------------------------------------------------------------------------
# the scenario mesh
# ---------------------------------------------------------------------------

class TestScenarioMesh:
    def test_cpu_mesh_follows_the_variable(self, monkeypatch):
        monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
        assert scenario_mesh(device="cpu") == [torch.device("cpu")]
        monkeypatch.setenv(HOST_DEVICES_ENV, "3")
        assert scenario_mesh(device="cpu") == [torch.device("cpu")] * 3
        assert scenario_mesh(2, "cpu") == [torch.device("cpu")] * 2
        with pytest.raises(ValueError, match=HOST_DEVICES_ENV):
            scenario_mesh(4, "cpu")
        with pytest.raises(ValueError, match="at least 1"):
            scenario_mesh(0, "cpu")
        monkeypatch.setenv(HOST_DEVICES_ENV, "zero")
        with pytest.raises(ValueError, match="positive integer"):
            scenario_mesh(device="cpu")

    def test_cuda_mesh_counts_the_cards(self):
        n = torch.cuda.device_count()
        if n == 0:
            with pytest.raises(ValueError, match="device_count"):
                scenario_mesh(1, "cuda")
        else:
            assert scenario_mesh(device="cuda") == [
                torch.device("cuda", i) for i in range(n)]
        assert "torch.cuda.device_count()" in device_count_hint("cuda")
        assert HOST_DEVICES_ENV in device_count_hint("cpu")

    def test_pad_and_partition(self):
        assert [pad_to_multiple(n, 4) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
        with pytest.raises(ValueError, match="multiple"):
            pad_to_multiple(3, 0)
        assert partition_bounds(5, 2) == [range(0, 3), range(3, 5)]
        assert partition_bounds(8, 4) == [range(2 * i, 2 * i + 2)
                                          for i in range(4)]

    def test_force_host_device_env_keeps_the_rest(self):
        env = force_host_device_env({"A": "1", HOST_DEVICES_ENV: "2"}, 4)
        assert env == {"A": "1", HOST_DEVICES_ENV: "4"}


# ---------------------------------------------------------------------------
# BatchState pad / unpad / host mirror, against the reference's
# ---------------------------------------------------------------------------

def _ref_configs(configs):
    return [ref_dsp.JobConfig(**dataclasses.asdict(c)) for c in configs]


class TestBatchStatePadding:
    CONFIGS = [JobConfig(workers=4), JobConfig(workers=9, memory_mb=2048)]

    def _states(self):
        port = BatchState.from_configs(self.CONFIGS)
        ref = ref_dsp.BatchState.from_configs(_ref_configs(self.CONFIGS))
        for st in (port, ref):
            st.lag_events[:] = [10.0, 20.0]
            st.downtime_left_s[:] = [0.0, 33.0]
            st.last_rate[:] = [40e3, 50e3]
        return port, ref

    def test_roundtrip_and_reference(self):
        port, ref = self._states()
        padded, ref_padded = port.pad(5), ref.pad(5)
        assert len(padded) == 5
        for f in BatchState.FIELDS:
            np.testing.assert_array_equal(getattr(padded, f),
                                          getattr(ref_padded, f), err_msg=f)
        back = padded.unpad(2)
        for f in BatchState.FIELDS:
            np.testing.assert_array_equal(getattr(back, f), getattr(port, f))

    def test_field_groups_are_the_references(self):
        assert BatchState.FIELDS == ref_dsp.BatchState.FIELDS
        for group in ("HOST_MIRROR_FIELDS", "DEVICE_FIELDS",
                      "CONFIG_FIELDS"):
            assert getattr(BatchState, group) == \
                getattr(ref_dsp.BatchState, group)
        groups = (BatchState.HOST_MIRROR_FIELDS + BatchState.DEVICE_FIELDS
                  + BatchState.CONFIG_FIELDS)
        assert sorted(groups) == sorted(BatchState.FIELDS)

    def test_host_mirror_matches_reference(self):
        from repro.dsp.simulator import BatchedNormals as RefNormals
        from repro_torch.dsp import BatchedNormals
        port, ref = self._states()
        rngs, ref_rngs = BatchedNormals([1, 2]), RefNormals([1, 2])
        for r in (rngs, ref_rngs):
            r.draw()
            r.draw(np.array([True, False]))
        mirror = port.to_host_mirror(rngs)
        want = ref.to_host_mirror(ref_rngs)
        assert mirror.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(mirror[k], want[k], err_msg=k)
        fresh = BatchState.from_configs(self.CONFIGS)
        fresh.from_host_mirror(mirror)
        for f in BatchState.HOST_MIRROR_FIELDS:
            np.testing.assert_array_equal(getattr(fresh, f),
                                          getattr(port, f))
        mirror["last_rate"][0] = -1.0          # a copy, not a view
        assert fresh.last_rate[0] == 40e3

    def test_pad_rows_are_fresh_cmax(self):
        padded = BatchState.from_configs([JobConfig(workers=4)]).pad(3)
        assert padded.config_of(1) == padded.config_of(2) == JobConfig()
        np.testing.assert_array_equal(padded.lag_events[1:], 0.0)
        np.testing.assert_array_equal(padded.downtime_left_s[1:], 0.0)

    def test_pad_same_size_is_identity(self):
        assert len(BatchState.from_configs([JobConfig()]).pad(1)) == 1

    def test_pad_shrink_rejected(self):
        with pytest.raises(ValueError, match="pad"):
            BatchState.from_configs([JobConfig()] * 3).pad(2)

    def test_unpad_grow_rejected(self):
        with pytest.raises(ValueError, match="slice"):
            BatchState.from_configs([JobConfig()]).unpad(2)

    def test_unpad_copies(self):
        state = BatchState.from_configs([JobConfig()] * 2)
        view = state.unpad(1)
        view.lag_events[0] = 123.0
        assert state.lag_events[0] == 0.0


# ---------------------------------------------------------------------------
# direct executor equivalence at 1, 2 and 4 host partitions
# ---------------------------------------------------------------------------

def _drive(executors, n_steps, fail_at=60, reconf_at=120):
    """Step every executor through the same rates, a failure and a
    reconfiguration; returns each one's per-step metrics."""
    rng = np.random.default_rng(42)
    big = JobConfig(workers=12)
    out = [[] for _ in executors]
    S = executors[0].n_scenarios()
    for i in range(n_steps):
        rates = rng.uniform(20_000, 70_000, S)
        for ex, rec in zip(executors, out):
            if i == fail_at:
                ex.inject_failure(1)
            if i == reconf_at:
                cfg = big if isinstance(ex.model, ClusterModel) \
                    else ref_dsp.JobConfig(**dataclasses.asdict(big))
                assert ex.reconfigure_one(2, cfg)
            rec.append(ex.step(rates))
    return out


CONFIGS = [JobConfig(), JobConfig(workers=6), JobConfig(workers=4)]


class TestShardedExecutorEquivalence:
    @pytest.mark.parametrize("cls", [ShardedSweepExecutor,
                                     FusedSweepExecutor])
    @pytest.mark.parametrize("parts", PARTITIONS)
    def test_step_failure_reconfigure_equivalence(self, host4, cls, parts):
        n_steps = 180
        kw = dict(dt=5.0, n_steps=n_steps, device="cpu")
        bat = BatchedSweepExecutor(MODEL, CONFIGS, [0, 1, 2], **kw)
        ex = cls(MODEL, CONFIGS, [0, 1, 2], devices=parts, **kw)
        assert ex.n_devices == parts and ex.n_rows % parts == 0
        assert ex.n_rows == pad_to_multiple(3, parts)
        mb, ms = _drive([bat, ex], n_steps)
        for a, b in zip(ms, mb):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-9,
                                           err_msg=k)
                # on the CPU the partitions change nothing at all
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(ex.caught_up(), bat.caught_up())
        np.testing.assert_array_equal(ex.workers(), bat.workers())
        np.testing.assert_array_equal(ex.reconf_count, bat.reconf_count)
        for k in bat.hist:
            np.testing.assert_array_equal(ex.hist[k], bat.hist[k],
                                          err_msg=k)

    @pytest.mark.parametrize("parts", PARTITIONS)
    def test_against_the_reference_executors(self, host4, parts):
        """The reference's sharded and batched executors, in-process on this
        process's one JAX device, as its own equivalence test runs them."""
        n_steps = 180
        ref_model = ref_dsp.ClusterModel()
        ref_cfgs = _ref_configs(CONFIGS)
        refs = [ref_dsp.BatchedSweepExecutor(ref_model, ref_cfgs, [0, 1, 2],
                                             dt=5.0, n_steps=n_steps),
                ref_dsp.ShardedSweepExecutor(ref_model, ref_cfgs, [0, 1, 2],
                                             dt=5.0, n_steps=n_steps)]
        port = ShardedSweepExecutor(MODEL, CONFIGS, [0, 1, 2], dt=5.0,
                                    n_steps=n_steps, device="cpu",
                                    devices=parts)
        m_port, *m_refs = _drive([port] + refs, n_steps)
        for m_ref in m_refs:
            for a, b in zip(m_port, m_ref):
                for k in b:
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-9,
                                               atol=1e-9, err_msg=k)
        for k in refs[1].hist:
            np.testing.assert_allclose(port.hist[k], refs[1].hist[k],
                                       rtol=1e-9, atol=1e-9, err_msg=k)

    def test_ragged_padding_matches_mesh(self, host4):
        sh = ShardedSweepExecutor(MODEL, [JobConfig()] * 5, list(range(5)),
                                  dt=5.0, n_steps=4, device="cpu")
        assert sh.n_devices == 4 and sh.n_rows == 8
        assert [len(r) for r in sh.partitions] == [2, 2, 2, 2]
        m = sh.step(np.full(5, 50_000.0))
        assert all(v.shape == (5,) for v in m.values())

    def test_padding_rows_draw_their_own_streams(self, host4):
        sh = ShardedSweepExecutor(MODEL, [JobConfig()] * 3, [0, 1, 2],
                                  dt=5.0, n_steps=4, device="cpu")
        want = np.random.default_rng(2 ** 33).standard_normal(4)
        got = [sh.rngs.draw()[3] for _ in range(4)]
        np.testing.assert_array_equal(got, want)

    def test_noop_reconfigure_not_counted(self):
        sh = ShardedSweepExecutor(MODEL, [JobConfig()], [0], dt=5.0,
                                  n_steps=4, device="cpu")
        assert not sh.reconfigure_one(0, JobConfig())
        assert sh.reconf_count[0] == 0

    def test_fused_interval_with_injection_mask_at_4_partitions(self, host4):
        configs = [JobConfig(workers=4), JobConfig(workers=8),
                   JobConfig(workers=6)]
        K = 24
        kw = dict(dt=5.0, n_steps=K + 4, device="cpu")
        bat = BatchedSweepExecutor(MODEL, configs, [0, 1, 2], **kw)
        fu = FusedSweepExecutor(MODEL, configs, [0, 1, 2], devices=4, **kw)
        rng = np.random.default_rng(7)
        rates = rng.uniform(20_000, 70_000, (K, 3))
        inject = np.zeros((K, 3), bool)
        inject[5, 1] = inject[17, 0] = inject[23, 2] = True
        ms = fu.step_interval(rates, inject)
        for k in range(K):
            mb = bat.step(rates[k])
            for key in mb:
                np.testing.assert_array_equal(ms[key][k], mb[key])
            for j in np.nonzero(inject[k])[0]:
                bat.inject_failure(int(j))
        r2 = rng.uniform(20_000, 70_000, (4, 3))
        m2 = fu.step_interval(r2)
        for k in range(4):
            mb = bat.step(r2[k])
            for key in mb:
                np.testing.assert_array_equal(m2[key][k], mb[key])
        # one fused_interval call per partition and interval, padded rows
        # included in the state gathered from the partitions
        assert fu.intervals_stepped == 2 and fu.n_devices == 4
        state = fu.device_state()
        assert state["lag"].shape == (4,)
        np.testing.assert_array_equal(state["lag"][:3].numpy(),
                                      bat.state.lag_events)

    def test_fused_device_state_round_trips_over_partitions(self, host4):
        fu = FusedSweepExecutor(MODEL, [JobConfig()] * 3, [0, 1, 2], dt=5.0,
                                n_steps=8, device="cpu", devices=2)
        fu.step_interval(np.full((4, 3), 9e4))
        state = fu.device_state()
        other = FusedSweepExecutor(MODEL, [JobConfig()] * 3, [0, 1, 2],
                                   dt=5.0, n_steps=8, device="cpu",
                                   devices=2)
        other.load_device_state(state)
        for k, v in other.device_state().items():
            assert torch.equal(v, state[k]), k
        np.testing.assert_array_equal(other.state.lag_events,
                                      fu.state.lag_events)


class TestShardedContract:
    @pytest.mark.parametrize("parts", PARTITIONS)
    def test_step_satisfies_contract(self, host4, parts):
        from repro_torch.analysis.contracts import COLLECTIVE_OPS, run_probe
        sh = ShardedSweepExecutor(MODEL, [JobConfig()] * 4, [0, 1, 2, 3],
                                  dt=5.0, n_steps=4, device="cpu",
                                  devices=parts)
        probe = sh.contract_probe("cpu")
        assert set(COLLECTIVE_OPS) <= set(probe.contract.forbidden_ops)
        assert len(probe.contract.in_place) == parts
        assert all(n.startswith("lag") for n in probe.contract.in_place)
        report = run_probe(probe)
        assert report.ok, report.summary()
        assert report.n_ops > 0           # a real run, not host_only

    def test_a_rebound_lag_is_caught(self, host4):
        from repro_torch.analysis.contracts import run_probe
        from repro_torch.dsp import executor as ex_mod
        sh = ShardedSweepExecutor(MODEL, [JobConfig()] * 2, [0, 1], dt=5.0,
                                  n_steps=4, device="cpu", devices=2)
        probe = sh.contract_probe("cpu")

        def rebinding_step(planes):
            out = []
            for p, (la, r, dpre, dpost, z1, z2) in enumerate(planes):
                new_lag, m = ex_mod.step_batch_arrays(
                    MODEL, sh._lag[p], la, r, *sh._device_configs()[p],
                    dpre, dpost, z1, z2, sh.dt)
                sh._lag[p] = new_lag           # rebound, not in place
                out.append(m["consumer_lag"])
            return out
        probe.fn = rebinding_step
        report = run_probe(probe)
        assert not report.ok
        assert {v.field for v in report.violations} == {"in_place"}


# ---------------------------------------------------------------------------
# whole sweeps: sharded / fused vs batched / scalar vs the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_sweeps():
    return {case: ref_dsp.run_sweep(_specs(case))
            for case in ("uniform", "ragged")}


class TestEngineDifferential:
    @pytest.mark.parametrize("case,parts", [
        ("uniform", 1), ("uniform", 2), ("ragged", 1), ("ragged", 2),
        ("ragged", 4)])
    def test_engines_match_batched_and_scalar(self, host4, reference_sweeps,
                                              case, parts):
        specs = port_specs(_specs(case))
        cpu = dict(device="cpu")
        batched = run_sweep(specs, config=EngineConfig(sim_backend="batched",
                                                       **cpu))
        scalar = run_sweep(specs, config=EngineConfig(sim_backend="scalar",
                                                      **cpu))
        assert _digest(batched) == _digest(scalar)
        engines = ["fused"] + (["sharded"] if parts >= 2 else [])
        for name in engines:
            eng = SweepEngine(specs, config=EngineConfig(
                sim_backend=name, devices=parts, **cpu))
            res = eng.run()
            assert res.engine == name
            assert eng.executor.n_devices == parts
            assert eng.executor.n_rows % parts == 0
            for a, b in zip(res.scenarios, batched.scenarios):
                assert a.name == b.name
                assert a.allclose(b, rtol=1e-9, atol=1e-9), \
                    f"{name}: {a.name}"
            _approx(_digest(res), _digest(batched), 1e-12)
            _approx(_digest(res), _digest(reference_sweeps[case]), 1e-12)

    def test_fused_defaults_to_every_host_partition(self, host4):
        specs = port_specs(_specs("uniform"))
        eng = SweepEngine(specs, config=EngineConfig(device="cpu"))
        eng.run()
        assert eng.executor.n_devices == 4


# ---------------------------------------------------------------------------
# EngineConfig device validation (case for case with the reference's)
# ---------------------------------------------------------------------------

class TestEngineConfigDevices:
    @pytest.mark.parametrize("bad", [0, -1, 2.5, True, "two"])
    def test_rejects_non_positive_int_devices(self, bad):
        with pytest.raises(ValueError, match="devices"):
            EngineConfig(devices=bad, device="cpu")

    def test_rejects_more_devices_than_visible(self, host4):
        with pytest.raises(ValueError, match=HOST_DEVICES_ENV):
            EngineConfig(devices=5, device="cpu")
        with pytest.raises(ValueError, match="device_count"):
            EngineConfig(devices=torch.cuda.device_count() + 1)

    def test_rejects_sharded_on_one_explicit_device(self, host4):
        with pytest.raises(ValueError, match="at least 2 devices"):
            EngineConfig(sim_backend="sharded", devices=1, device="cpu")

    def test_devices_accepted_up_to_visible(self, host4):
        assert EngineConfig(devices=4, device="cpu").devices == 4
        assert EngineConfig(sim_backend="sharded", device="cpu").devices \
            is None

    def test_single_device_sharded_rejected(self, monkeypatch):
        monkeypatch.setenv(HOST_DEVICES_ENV, "1")
        with pytest.raises(ValueError) as exc:
            EngineConfig(sim_backend="sharded", device="cpu")
        msg = str(exc.value)
        assert "at least 2 devices" in msg and HOST_DEVICES_ENV in msg
        # ... while the fused engine needs no second device
        assert EngineConfig(sim_backend="fused", device="cpu").sim_backend \
            == "fused"


# ---------------------------------------------------------------------------
# the banks over partitions
# ---------------------------------------------------------------------------

def _datasets(n_models, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_models):
        n = 5 + (i % 4) * 3
        x = rng.random((n, 3))
        y = np.sin(3 * x @ np.array([1.0, -0.5, 0.25])) \
            + 0.05 * rng.standard_normal(n)
        out.append((x, y))
    return out


class TestBanksOverPartitions:
    def test_gp_bank_fit_and_posterior(self, host4):
        torch.set_num_threads(1)
        data = _datasets(7)
        seeds = list(range(7))
        one = GPBank.fit(data, seeds=seeds, max_iter=20, device="cpu")
        three = GPBank.fit(data, seeds=seeds, max_iter=20, device="cpu",
                           devices=3)
        for f in ("theta", "chol", "alpha", "x", "mask"):
            np.testing.assert_array_equal(getattr(three, f),
                                          getattr(one, f), err_msg=f)
        xq = np.random.default_rng(1).random((16, 3))
        gps = one.members()
        a = batched_posterior(gps, xq, device="cpu")
        b = batched_posterior(gps, xq, device="cpu", devices=3)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)

    def test_forecast_bank_members(self, host4):
        kinds = ["arima", "holt", "arima", "seasonal", "arima", "holt",
                 "arima"]
        params = [dict(p=2 + (i % 3) * 3) if k == "arima" else {}
                  for i, k in enumerate(kinds)]
        banks = [ForecastBank(kinds, params=params, horizon=6, device="cpu",
                              devices=d) for d in (1, 4)]
        assert [b.n_devices for b in banks] == [1, 4]
        rng = np.random.default_rng(3)
        series = 50 + np.cumsum(rng.standard_normal((40, len(kinds))), 0)
        for t in range(40):
            for b in banks:
                for row in range(len(kinds)):
                    if (t + row) % 3:            # ragged staging
                        b.stage(row, float(series[t, row]))
            if t % 7 == 6:
                outs = [[b.forecast_row(r, 6) for r in range(len(kinds))]
                        for b in banks]
                for u, v in zip(*outs):
                    np.testing.assert_array_equal(u, v)
        banks[0].flush(), banks[1].flush()
        for row in range(len(kinds)):
            views = [b.view(row) for b in banks]
            assert views[0].n_observed == views[1].n_observed
            assert views[0].last() == views[1].last()
            assert views[0].residual_std() == views[1].residual_std()
        assert banks[1].arima_chunks == banks[0].arima_chunks > 0
        # the ARIMA family's 4 streams over 4 partitions: a flush makes one
        # arima_chunk call per partition
        assert [p.chunks_replayed for p in banks[1].family("arima").parts] \
            == [banks[1].arima_chunks] * 4
        for kind in ("arima", "holt"):
            for u, v in zip(banks[0].family(kind).state,
                            banks[1].family(kind).state):
                assert torch.equal(u, v), kind
        banks[1].reset_rows([0, 6])
        banks[0].reset_rows([0, 6])
        for u, v in zip(banks[0].family("arima").state,
                        banks[1].family("arima").state):
            assert torch.equal(u, v)

    def test_short_demeter_grid_devices_4_equals_devices_1(self, host4,
                                                           monkeypatch):
        """A 1 h Demeter grid that still fits GPs and updates forecasts:
        the fused engine, the forecast bank and the GP bank over 4 host
        partitions give the one-partition result bit for bit, and the GP
        fits really run per partition."""
        from repro_torch.kernels import ops
        torch.set_num_threads(1)
        specs = [
            ScenarioSpec(trace=make_trace("diurnal", duration_s=3600.0,
                                          dt_s=5.0),
                         controller="demeter", seed=0,
                         failures=PeriodicFailures(1200.0)),
            ScenarioSpec(trace=make_trace("flash", duration_s=3600.0,
                                          dt_s=5.0),
                         controller="demeter", seed=1, failures=NoFailures(),
                         forecaster="holt"),
        ]
        real, fits = ops.gp_lbfgs, []

        def counted(*args, **kwargs):
            fits.append(args[0].shape[0])
            return real(*args, **kwargs)

        monkeypatch.setattr(ops, "gp_lbfgs", counted)
        hp = DemeterHyperParams(profile_interval_s=600)
        runs, calls = {}, {}
        for d in (1, 4):
            fits.clear()
            eng = SweepEngine(specs, config=EngineConfig(device="cpu", hp=hp,
                                                         devices=d))
            runs[d] = (eng.run(), eng)
            calls[d] = list(fits)
        one, four = runs[1][0], runs[4][0]
        assert one.n_model_fits > 0 and one.n_forecast_updates > 0
        assert runs[4][1].executor.n_devices == 4
        assert runs[4][1].forecast_bank.n_devices == 4
        # the same members fitted, split over more calls
        assert sum(calls[4]) == sum(calls[1]) > 0
        assert len(calls[4]) > len(calls[1])
        assert _digest(four) == _digest(one)

    @pytest.mark.slow
    def test_demeter_grid_devices_4_equals_devices_1(self, host4):
        """A 1.5 h Demeter grid that fits GPs and forecasts: the fused
        engine, the forecast bank and the GP bank over 4 host partitions
        give the one-partition result, bit for bit on the CPU (~60 s here,
        hence ``slow``, as the reference marks its own Demeter leg)."""
        torch.set_num_threads(1)
        specs = [
            ScenarioSpec(trace=make_trace("diurnal", duration_s=5400.0,
                                          dt_s=5.0),
                         controller="demeter", seed=0, failures=NoFailures()),
            ScenarioSpec(trace=make_trace("flash", duration_s=5400.0,
                                          dt_s=5.0),
                         controller="demeter", seed=1, failures=NoFailures(),
                         forecaster="holt"),
            ScenarioSpec(trace=make_trace("regime", duration_s=5400.0,
                                          dt_s=5.0),
                         controller="reactive", seed=2,
                         failures=PeriodicFailures(600.0)),
        ]
        hp = DemeterHyperParams(profile_interval_s=600)
        runs = {}
        for d in (1, 4):
            eng = SweepEngine(specs, config=EngineConfig(device="cpu", hp=hp,
                                                         devices=d))
            runs[d] = (eng.run(), eng)
        one, four = runs[1][0], runs[4][0]
        assert one.n_model_fits > 0 and one.n_forecast_updates > 0
        assert runs[4][1].executor.n_devices == 4
        assert runs[4][1].forecast_bank.n_devices == 4
        assert _digest(four) == _digest(one)
