"""The port's Demeter path against the reference's.

* the whole slice: the ``demeter`` case of ``tests/helpers/sharded_diff.py``
  (Demeter with ARIMA, Demeter with Holt, a reactive baseline) through the
  port's ``batched`` and ``fused`` engines on the CPU against the
  reference's ``run_sweep``: ``to_json()`` minus the volatile keys at
  1e-12, with ``n_forecast_updates`` and ``n_model_fits`` equal;
* ``DemeterController._pick_config`` / ``_select_profiles`` pick the same
  configurations as the reference's from the same segment store and the
  same GPs (fitted by the reference, carried across by interop);
* a port-only sweep that fits GPs (1.5 h, ``profile_interval_s=600``) under
  both fit backends. No reference sweep that fits GPs runs here: the
  reference's scalar fits take minutes on the CPU.
"""
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

from helpers.sharded_diff import VOLATILE, _approx, _specs  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.config_space import \
    paper_flink_space as ref_space  # noqa: E402
from repro.core.demeter import DemeterController as RefCtl  # noqa: E402
from repro.dsp import run_sweep as ref_run_sweep  # noqa: E402
from repro_torch.core import EngineConfig  # noqa: E402
from repro_torch.core.config_space import paper_flink_space  # noqa: E402
from repro_torch.core.demeter import (DemeterController,  # noqa: E402
                                      DemeterHyperParams)
from repro_torch.core.segments import LATENCY, RECOVERY, USAGE  # noqa: E402
from repro_torch.dsp import (PeriodicFailures, ScenarioSpec,  # noqa: E402
                             make_trace, run_sweep)
from repro_torch.interop import gp_from_arrays  # noqa: E402
from test_torch_sweep import port_specs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(result) -> dict:
    return {k: v for k, v in result.to_json().items() if k not in VOLATILE}


@pytest.fixture(scope="module")
def demeter_reference():
    return ref_run_sweep(_specs("demeter"))


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_demeter_case_matches_reference(engine, demeter_reference):
    want = demeter_reference
    res = run_sweep(port_specs(_specs("demeter")),
                    config=EngineConfig(sim_backend=engine, device="cpu"))
    _approx(_digest(res), _digest(want), 1e-12)
    assert res.n_forecast_updates == want.n_forecast_updates > 0
    assert res.n_model_fits == want.n_model_fits
    for a, b in zip(res.scenarios, want.scenarios):
        assert a.name == b.name
        assert a.allclose(b, rtol=1e-12, atol=1e-12), a.name


class _CostModel:
    """A scalar executor stand-in: allocated cost normalized to C_max
    (workers x cores, workers x memory), the same in both packages."""

    CMAX = {"workers": 24.0, "cpu_cores": 3.0, "memory_mb": 4096.0,
            "task_slots": 4.0, "checkpoint_interval_s": 10.0}

    def cmax_config(self):
        return dict(self.CMAX)

    def current_config(self):
        return dict(self.CMAX)

    def allocated_cost(self, c):
        cpu = c["workers"] * c["cpu_cores"] / (24.0 * 3.0)
        mem = c["workers"] * c["memory_mb"] / (24.0 * 4096.0)
        return 0.5 * cpu + 0.5 * mem


def _observations(space, seed):
    """Profiling-like observations over two neighbouring segments."""
    rng = np.random.default_rng(seed)
    configs = space.enumerate()
    cost = _CostModel().allocated_cost
    out = []
    for rate, n in ((34_000.0, 9), (46_000.0, 7)):
        for j in rng.choice(len(configs), n, replace=False):
            c = configs[j]
            a = cost(c)
            load = rate / (9000.0 * c["workers"] * c["cpu_cores"] ** 0.85)
            out.append((c, rate, {
                USAGE: a * (0.4 + 0.5 * min(load, 1.0))
                + rng.normal(0, 0.01),
                LATENCY: 0.6 + 2.0 * min(load, 1.5) ** 2
                + rng.normal(0, 0.02),
                RECOVERY: 60.0 + 150.0 * load + rng.normal(0, 5.0)}))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_controller_picks_same_configs_as_reference(seed):
    hp = DemeterHyperParams(profile_parallelism=3)
    ctl = DemeterController(paper_flink_space(), _CostModel(),
                            config=EngineConfig(device="cpu",
                                                forecast_backend="scalar",
                                                hp=hp))
    from repro.core.demeter import DemeterHyperParams as RefHp
    ref = RefCtl(ref_space(), _CostModel(),
                 config=RefEngineConfig(forecast_backend="scalar",
                                        hp=RefHp(profile_parallelism=3)))
    obs = _observations(ctl.space, seed)
    for c in (ctl, ref):
        for k, (cfg, rate, metrics) in enumerate(obs):
            c.store.record(cfg, c.space.encode(cfg), rate, metrics,
                           reverted=(k == 2))
        for lat in 0.55 + 0.05 * np.arange(12):
            c.lc.observe(lat)
    # fit every model once, in the reference; the port gets the same GPs
    assert ref.bank.refresh() > 0
    for key, (version, n, gp) in ref.bank._gps.items():
        ctl.bank._gps[key] = (version, n, None if gp is None else
                              gp_from_arrays(gp.x, gp.y_mean, gp.y_std,
                                             np.asarray(gp.theta),
                                             np.asarray(gp.chol),
                                             np.asarray(gp.alpha)))
    n_picks = n_profiles = 0
    for rate in (34_000.0, 46_000.0):
        seg, ref_seg = ctl.store.segment_for(rate), ref.store.segment_for(rate)
        got, want = ctl._pick_config(seg), ref._pick_config(ref_seg)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0]
            assert got[1] == pytest.approx(want[1], rel=1e-4)
            n_picks += 1
        picked = ctl._select_profiles(seg, rate, 3)
        assert picked == ref._select_profiles(ref_seg, rate, 3)
        n_profiles += len(picked)
    assert n_picks and n_profiles          # the comparison had content
    assert ctl.bank.n_fits == 0            # every model came from the cache


def test_port_sweep_fits_gps_with_both_fit_backends():
    trace = make_trace("diurnal", duration_s=1.5 * 3600.0)
    specs = [ScenarioSpec(trace=trace, controller="demeter", seed=0,
                          failures=PeriodicFailures(2700.0))]
    hp = DemeterHyperParams(profile_interval_s=600)
    runs = {fb: run_sweep(specs, config=EngineConfig(device="cpu",
                                                     fit_backend=fb, hp=hp))
            for fb in ("bank", "scalar")}
    bank, scalar = runs["bank"], runs["scalar"]
    assert bank.n_model_fits > 0 and scalar.n_model_fits > 0
    assert bank.n_forecast_updates == scalar.n_forecast_updates > 0
    assert bank.model_update_compile_wall_s == 0.0   # no kernel on the CPU
    for res in runs.values():
        (s,) = res.scenarios
        assert s.failures
        for f in ("rates", "latencies", "usage_cpu", "usage_mem_mb",
                  "workers", "consumer_lag"):
            a = getattr(s, f)
            assert a.shape == (res.n_steps,) and np.isfinite(a).all(), f
        assert s.profile_cpu_s > 0.0
