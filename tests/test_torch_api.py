"""The port's public API against the reference's (a port copy of
``tests/test_api.py`` under the port's names).

* the exported names of ``repro_torch.core`` and ``repro_torch.dsp``: the
  reference's ``__all__`` minus the names of slices not ported yet
  (``UNPORTED``), plus the port's own (``PORT_ONLY``); the key signatures
  beside the reference's;
* ``EngineConfig`` validation: one error surface at construction;
* the legacy string kwargs (``engine=``, ``fit_backend=``,
  ``forecast_backend=``, ``detector_backend=``) warn, with the warning at
  the same frame as the reference's, and give a ``SweepResult`` identical
  to the ``config=`` path; mixing the two raises;
* ``ScalarAdapter(DSPExecutor)`` and ``ScenarioView``; the registries.

The legacy kwargs resolve against ``EngineConfig()``, whose device is the
card; where a run needs one on the CPU, the ``on_cpu`` fixture moves the
resolved config to the CPU.
"""
import inspect
import warnings
from pathlib import Path

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.dsp as ref_dsp  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.demeter as demeter_mod  # noqa: E402
import repro_torch.dsp as dsp  # noqa: E402
import repro_torch.dsp.sweep as sweep_mod  # noqa: E402
from repro.dsp.sweep import SweepEngine as RefSweepEngine  # noqa: E402
from repro.dsp.workloads import make_trace as ref_make_trace  # noqa: E402
from repro_torch.core import (CONTROLLERS, EngineConfig,  # noqa: E402
                              Registry, ScalarAdapter, ScenarioView,
                              coerce_config)
from repro_torch.core.config_space import paper_flink_space  # noqa: E402
from repro_torch.core.demeter import (DemeterController,  # noqa: E402
                                      DemeterHyperParams)
from repro_torch.dsp import (BatchedSweepExecutor, ClusterModel,  # noqa: E402
                             DSPExecutor, FusedSweepExecutor, JobConfig,
                             NoFailures, ScalarSweepExecutor, ScenarioSpec,
                             ShardedSweepExecutor, SweepEngine, make_trace,
                             run_sweep, scenario_grid)

# ---------------------------------------------------------------------------
# API snapshot
# ---------------------------------------------------------------------------

#: names of the reference's API whose slices are not ported yet: none
UNPORTED = {"core": set(), "dsp": set()}
#: the port's own exports, beyond the reference's
PORT_ONLY = {
    "core": {"resolve_device", "FORECASTER_DEFAULTS", "ScalarDetectorSet",
             "BankedDetectorSet", "restart_inits", "bucket_pow2"},
    "dsp": {"BatchedNormals", "BufferedNormals", "step_batch_arrays",
            "make_baseline", "profile_one", "fused_interval_scan",
            "FAILURE_INTERVAL_S", "RECOVERY_CAP_S", "METRIC_WINDOW_S",
            "OPT_INTERVAL_S"},
}
#: EngineConfig fields: the reference's, all ported, and the port's own
#: (where tensors live)
UNPORTED_FIELDS = ()
PORT_FIELDS = ("device",)


class TestApiSnapshot:
    @pytest.mark.parametrize("pkg,ref", [("core", ref_core),
                                         ("dsp", ref_dsp)])
    def test_exports(self, pkg, ref):
        mod = core if pkg == "core" else dsp
        assert UNPORTED[pkg] <= set(ref.__all__)
        assert not PORT_ONLY[pkg] & set(ref.__all__)
        assert set(mod.__all__) == \
            (set(ref.__all__) - UNPORTED[pkg]) | PORT_ONLY[pkg]
        assert not [n for n in mod.__all__ if not hasattr(mod, n)]
        assert len(mod.__all__) == len(set(mod.__all__))

    def test_run_sweep_signature(self):
        params = inspect.signature(run_sweep).parameters
        ref = list(inspect.signature(ref_dsp.run_sweep).parameters)
        assert list(params) == ref + ["detector_backend"]
        assert ref == ["specs", "config", "engine", "model", "hp",
                       "decision_interval_s", "fit_backend",
                       "forecast_backend"]
        assert all(p.kind is inspect.Parameter.KEYWORD_ONLY
                   for n, p in params.items() if n != "specs")

    def test_engine_config_fields(self):
        params = list(inspect.signature(EngineConfig).parameters)
        ref = list(inspect.signature(ref_core.EngineConfig).parameters)
        assert params == [f for f in ref if f not in UNPORTED_FIELDS] \
            + list(PORT_FIELDS)

    @pytest.mark.parametrize("name", ["BatchedSweepExecutor",
                                      "FusedSweepExecutor",
                                      "ScalarSweepExecutor",
                                      "ShardedSweepExecutor"])
    def test_executors_take_devices(self, name):
        """Every engine takes the reference's ``devices=`` keyword (the
        sweep engine passes one constructor signature), as the base does."""
        ref = inspect.signature(ref_dsp.SweepExecutorBase).parameters
        port = inspect.signature(dsp.SweepExecutorBase).parameters
        assert ref["devices"].default is port["devices"].default is None
        assert ref["devices"].kind is port["devices"].kind \
            is inspect.Parameter.KEYWORD_ONLY
        for pkg in (ref_dsp, dsp):
            assert issubclass(getattr(pkg, name), pkg.SweepExecutorBase)
        assert EngineConfig(device="cpu", devices=1).devices == 1

    @pytest.mark.parametrize("fn,ref", [
        (core.GPBank.fit, ref_core.GPBank.fit),
        (core.batched_posterior, ref_core.batched_posterior),
        (core.ForecastBank, ref_core.ForecastBank),
        (core.ForecastBank.from_kinds, ref_core.ForecastBank.from_kinds)])
    def test_banks_take_devices(self, fn, ref):
        a = inspect.signature(fn).parameters["devices"]
        b = inspect.signature(ref).parameters["devices"]
        assert a.default is b.default is None and a.kind is b.kind

    def test_demeter_controller_signature(self):
        params = inspect.signature(DemeterController).parameters
        ref = inspect.signature(ref_core.DemeterController).parameters
        for name in ("space", "executor", "hp", "tsf", "fit_backend",
                     "forecaster", "forecast_backend", "config"):
            assert name in params and name in ref
        assert list(params) == [n for n in ref if n != "alloc"] + ["alloc"]

    @pytest.mark.parametrize("impl", [BatchedSweepExecutor,
                                      FusedSweepExecutor,
                                      ScalarSweepExecutor,
                                      ShardedSweepExecutor, ScalarAdapter])
    def test_batch_executor_protocol_members(self, impl):
        for method in ("n_scenarios", "cmax_config", "current_config",
                       "reconfigure", "observe", "observe_one", "profile",
                       "allocated_cost"):
            assert hasattr(core.BatchExecutor, method)
            assert callable(getattr(impl, method)), \
                f"{impl.__name__} is missing {method}"

    def test_dsp_executor_is_an_executor(self):
        execu = DSPExecutor(ClusterModel(), JobConfig(), seed=0)
        assert isinstance(execu, core.Executor)
        assert isinstance(ScalarAdapter(execu), core.BatchExecutor)
        assert dsp.CONTROLLER_NAMES == ref_dsp.CONTROLLER_NAMES


# ---------------------------------------------------------------------------
# EngineConfig validation: one error surface
# ---------------------------------------------------------------------------

class TestEngineConfig:
    def test_defaults_valid(self):
        cfg = EngineConfig()
        assert (cfg.sim_backend, cfg.fit_backend, cfg.forecast_backend,
                cfg.detector_backend, cfg.device) == \
            ("fused", "bank", "bank", "scalar", "cuda")
        for kw in (dict(detector_backend="bank"), dict(sim_backend="scalar")):
            assert EngineConfig(**kw).replace(**kw) == EngineConfig(**kw)

    @pytest.mark.parametrize("field,msg", [
        ("sim_backend", "unknown engine"),
        ("fit_backend", "unknown fit backend"),
        ("forecast_backend", "unknown forecast backend"),
        ("detector_backend", "unknown detector backend"),
    ])
    def test_rejects_unknown_backends_at_construction(self, field, msg):
        with pytest.raises(ValueError, match=msg):
            EngineConfig(**{field: "bogus"})

    def test_rejects_nonpositive_cadence(self):
        with pytest.raises(ValueError, match="decision_interval_s"):
            EngineConfig(decision_interval_s=0.0)

    def test_replace_revalidates(self):
        with pytest.raises(ValueError, match="unknown fit backend"):
            EngineConfig().replace(fit_backend="bogus")

    @pytest.mark.parametrize("legacy", [dict(fit_backend="bank"),
                                        dict(engine="scalar"),
                                        dict(detector_backend="bank")])
    def test_mixing_config_and_legacy_kwargs_rejected(self, legacy):
        spec = ScenarioSpec(trace=make_trace("diurnal", duration_s=60.0))
        with pytest.raises(ValueError, match="not both"):
            run_sweep([spec], config=EngineConfig(device="cpu"), **legacy)

    def test_plugin_forecaster_rejected_eagerly_on_bank_backend(self):
        from repro_torch.core import FORECASTERS, OnlineARIMA
        FORECASTERS.register("plugfc", OnlineARIMA)
        try:
            spec = ScenarioSpec(trace=make_trace("diurnal", duration_s=60.0),
                                controller="demeter", forecaster="plugfc")
            with pytest.raises(ValueError, match="forecast_backend='bank'"):
                SweepEngine([spec], config=EngineConfig(device="cpu"))
            SweepEngine([spec], config=EngineConfig(device="cpu",
                                                    forecast_backend="scalar"))
        finally:
            FORECASTERS.unregister("plugfc")

    def test_sweep_engine_validates_fit_backend_eagerly(self):
        spec = ScenarioSpec(trace=make_trace("diurnal", duration_s=60.0))
        with pytest.raises(ValueError, match="unknown fit backend"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            SweepEngine([spec], fit_backend="bogus")

    def test_run_sweep_rejects_unknown_engine_with_listing(self):
        spec = ScenarioSpec(trace=make_trace("diurnal", duration_s=60.0))
        with pytest.raises(ValueError, match=r"available: \('batched', "
                                             r"'fused', 'scalar', "
                                             r"'sharded'\)"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            run_sweep([spec], engine="gpu")


# ---------------------------------------------------------------------------
# deprecation shims
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu(monkeypatch):
    """The legacy kwargs resolve against ``EngineConfig()`` (the card); move
    the config they resolve to onto the CPU for a run here."""
    real = coerce_config

    def cpu_config(*args, **kwargs):
        return real(*args, **kwargs).replace(device="cpu")
    for mod in (sweep_mod, demeter_mod):
        monkeypatch.setattr(mod, "coerce_config", cpu_config)


VOLATILE = ("wall_s", "model_update_wall_s", "forecast_update_wall_s",
            "model_update_compile_wall_s", "forecast_update_compile_wall_s")


class TestLegacyKwargShims:
    @pytest.fixture(scope="class")
    def grid(self):
        traces = [make_trace(k, duration_s=900.0, dt_s=5.0)
                  for k in ("diurnal", "flash")]
        return scenario_grid(traces, ("static", "reactive"), (0,))

    def test_engine_kwarg_warns_and_matches_config(self, grid, on_cpu):
        with pytest.warns(DeprecationWarning, match="'engine' kwarg"):
            legacy = run_sweep(grid, engine="scalar")
        new = run_sweep(grid, config=EngineConfig(sim_backend="scalar",
                                                  device="cpu"))
        assert legacy.engine == new.engine == "scalar"
        for a, b in zip(legacy.scenarios, new.scenarios):
            assert a.allclose(b)

    def test_backend_kwargs_warn_and_match_config(self, grid, on_cpu):
        with pytest.warns(DeprecationWarning) as rec:
            legacy = run_sweep(grid, fit_backend="scalar",
                               forecast_backend="scalar",
                               detector_backend="bank")
        assert sorted(str(w.message).split("'")[1] for w in rec) == \
            ["detector_backend", "fit_backend", "forecast_backend"]
        new = run_sweep(grid, config=EngineConfig(
            fit_backend="scalar", forecast_backend="scalar",
            detector_backend="bank", device="cpu"))
        assert legacy.to_json()["scenarios"] == new.to_json()["scenarios"]

    @pytest.mark.parametrize("name", ["forecast_backend", "detector_backend"])
    def test_each_backend_kwarg_warns(self, grid, on_cpu, name):
        with pytest.warns(DeprecationWarning, match=f"'{name}' kwarg"):
            run_sweep(grid[:1], **{name: "bank"})

    def test_demeter_controller_legacy_kwargs_warn(self, on_cpu):
        execu = DSPExecutor(ClusterModel(), JobConfig(), seed=0)
        with pytest.warns(DeprecationWarning, match="'fit_backend' kwarg"):
            ctl = DemeterController(paper_flink_space(), execu,
                                    fit_backend="scalar")
        assert ctl.config.fit_backend == ctl.fit_backend == "scalar"
        assert ctl.bank.fit_backend == "scalar"
        with pytest.warns(DeprecationWarning, match="'forecast_backend'"):
            ctl = DemeterController(paper_flink_space(), execu,
                                    forecast_backend="scalar")
        assert ctl.forecast_backend == "scalar"
        with pytest.raises(ValueError, match="not both"):
            DemeterController(paper_flink_space(), execu,
                              config=EngineConfig(device="cpu"),
                              fit_backend="scalar")

    def test_config_path_emits_no_warnings(self, grid):
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            run_sweep(grid[:1], config=EngineConfig(device="cpu"))

    def test_old_kwargs_vs_config_identical_sweep_result(self, grid, on_cpu):
        with pytest.warns(DeprecationWarning):
            legacy = run_sweep(grid, engine="batched", fit_backend="bank",
                               forecast_backend="bank")
        new = run_sweep(grid, config=EngineConfig(sim_backend="batched",
                                                  device="cpu"))
        a, b = legacy.to_json(), new.to_json()
        for volatile in VOLATILE:
            a.pop(volatile), b.pop(volatile)
        assert a == b

    @pytest.mark.parametrize("call", ["engine", "run", "coerce"])
    def test_warning_points_where_the_reference_points(self, call):
        """The same frame as the reference's warning: the caller's line."""
        specs = {"port": [ScenarioSpec(trace=make_trace("diurnal",
                                                        duration_s=60.0))],
                 "ref": [ref_dsp.ScenarioSpec(
                     trace=ref_make_trace("diurnal", duration_s=60.0))]}
        calls = {
            "engine": lambda pkg: (SweepEngine if pkg == "port"
                                   else RefSweepEngine)(
                specs[pkg], fit_backend="bank"),
            "run": lambda pkg: (SweepEngine if pkg == "port"
                                else RefSweepEngine)(specs[pkg]).run(
                engine="nope"),
            "coerce": lambda pkg: (coerce_config if pkg == "port"
                                   else ref_core.coerce_config)(
                forecast_backend="bank"),
        }
        where = {}
        for pkg in ("port", "ref"):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always", DeprecationWarning)
                try:
                    calls[call](pkg)
                except ValueError:               # the unknown engine
                    pass
            (w,) = [r for r in rec if r.category is DeprecationWarning]
            where[pkg] = (Path(w.filename).name, w.lineno)
        assert where["port"] == where["ref"]
        assert where["port"][0] == Path(__file__).name


# ---------------------------------------------------------------------------
# ScalarAdapter / ScenarioView
# ---------------------------------------------------------------------------

def _fresh_executor(seed=0):
    return DSPExecutor(ClusterModel(), JobConfig(), seed=seed, dt=5.0)


class TestScalarAdapter:
    def test_single_executor_wraps_as_batch_of_one(self):
        ad = ScalarAdapter(_fresh_executor())
        assert ad.n_scenarios() == 1
        assert ad.cmax_config(0) == JobConfig().to_dict()
        with pytest.raises(ValueError, match="at least one executor"):
            ScalarAdapter([])

    def test_observe_stacks_rows(self):
        e0, e1 = _fresh_executor(0), _fresh_executor(1)
        ad = ScalarAdapter([e0, e1])
        for _ in range(12):
            e0.step(40_000.0), e1.step(60_000.0)
        batched = ad.observe()
        for i, e in enumerate((e0, e1)):
            scalar = e.observe()
            assert set(batched) == set(scalar)
            for k, v in scalar.items():
                assert batched[k][i] == pytest.approx(v, rel=1e-12)
        assert ad.observe_one(1) == e1.observe()

    def test_reconfigure_masked_rows_only(self):
        e0, e1 = _fresh_executor(0), _fresh_executor(1)
        ad = ScalarAdapter([e0, e1])
        small = dsp.baseline_config(4).to_dict()
        applied = ad.reconfigure(np.array([False, True]), [small, small])
        assert applied.tolist() == [False, True]
        assert e0.current_config() == JobConfig().to_dict()
        assert e1.current_config() == small

    def test_profile_matches_direct_call(self):
        cfgs = [dsp.baseline_config(4).to_dict(),
                dsp.baseline_config(8).to_dict()]
        direct = _fresh_executor(3).profile(cfgs, 40_000.0)
        ad = ScalarAdapter(_fresh_executor(3))
        via = ad.profile([(0, c, 40_000.0) for c in cfgs])
        assert len(direct) == len(via) == 2
        assert direct == via and all(d is not None for d in direct)

    def test_profile_noncontiguous_specs_get_distinct_seeds(self):
        cfg = dsp.baseline_config(4).to_dict()
        other = dsp.baseline_config(8).to_dict()
        direct = _fresh_executor(7).profile([cfg, cfg], 40_000.0)
        ad = ScalarAdapter([_fresh_executor(7), _fresh_executor(8)])
        via = ad.profile([(0, cfg, 40_000.0), (1, other, 40_000.0),
                          (0, cfg, 40_000.0)])
        assert via[0] is not None and via[2] is not None
        assert [via[0], via[2]] == direct

    def test_scenario_view_roundtrips_scalar_protocol(self):
        execu = _fresh_executor(0)
        view = ScenarioView(ScalarAdapter(execu), 0)
        for _ in range(12):
            execu.step(40_000.0)
        assert view.cmax_config() == execu.cmax_config()
        assert view.current_config() == execu.current_config()
        assert view.observe() == execu.observe()
        cfg = dsp.baseline_config(6).to_dict()
        assert view.allocated_cost(cfg) == execu.allocated_cost(cfg)
        view.reconfigure(cfg)
        assert execu.current_config() == cfg


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_duplicate_registration_rejected(self):
        r = Registry("thing")
        r.register("a", 1)
        with pytest.raises(ValueError, match="already registered"):
            r.register("a", 2)
        r.register("a", 2, override=True)
        assert r.get("a") == 2

    def test_canonical_error_shape(self):
        r = Registry("gizmo")
        r.register("x", object())
        with pytest.raises(ValueError,
                           match=r"unknown gizmo 'y'; available: \('x',\)"):
            r.get("y")

    def test_third_party_controller_runs_through_sweep(self):
        from repro_torch.dsp.baselines import StaticController
        from repro_torch.dsp.policies import BaselinePolicy

        @CONTROLLERS.register("frozen")
        class FrozenPolicy(BaselinePolicy):
            """A pluggable do-nothing controller (pinned start config)."""

            @classmethod
            def start_config_for(cls, spec, config):
                return dsp.baseline_config(3)

            def __init__(self, eng, idx, spec, config, tsf=None):
                self.ctl = StaticController(dsp.baseline_config(3))
                self.start_config = dsp.baseline_config(3)

        try:
            spec = ScenarioSpec(trace=make_trace("diurnal", duration_s=600.0,
                                                 dt_s=5.0),
                                controller="frozen", failures=NoFailures())
            res = run_sweep([spec], config=EngineConfig(device="cpu"))
            assert res.scenarios[0].workers.max() == 3
            assert res.scenarios[0].n_reconfigurations == 0
            ref = run_sweep([spec], config=EngineConfig(sim_backend="scalar",
                                                        device="cpu"))
            assert res.scenarios[0].allclose(ref.scenarios[0])
        finally:
            CONTROLLERS.unregister("frozen")

    def test_unknown_controller_error_lists_available(self):
        with pytest.raises(ValueError, match="unknown controller"):
            ScenarioSpec(trace=make_trace("diurnal", duration_s=60.0),
                         controller="nope")


# ---------------------------------------------------------------------------
# coerce_config unit behaviour
# ---------------------------------------------------------------------------

class TestCoerceConfig:
    def test_no_args_yields_defaults(self):
        assert coerce_config() == EngineConfig()

    def test_legacy_folds_in_with_warning(self):
        with pytest.warns(DeprecationWarning):
            cfg = coerce_config(engine="scalar", fit_backend="scalar",
                                detector_backend="bank")
        assert (cfg.sim_backend, cfg.fit_backend, cfg.detector_backend) == \
            ("scalar", "scalar", "bank")

    def test_hp_and_cadence_fold_in_silently(self):
        hp = DemeterHyperParams(forecast_horizon=7)
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            cfg = coerce_config(hp=hp, decision_interval_s=30.0)
        assert cfg.hp is hp
        assert cfg.decision_interval_s == 30.0
        assert cfg.resolved_hp().forecast_horizon == 7

    def test_config_and_legacy_kwarg_rejected(self):
        with pytest.raises(ValueError, match=r"\['forecast_backend'\], not "
                                             r"both"):
            coerce_config(EngineConfig(), forecast_backend="bank")
