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
  both fit backends;
* where the two packages part on a 1.5 h grid with the bank GP fits: at the
  second pick that ranks GP posteriors, a near-tie under the float32 fits
  of one algorithm (the reference's scalar fits take minutes on the CPU and
  are not run).
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


# ---------------------------------------------------------------------------
# where the port parts from the reference: a near-tie under float32 GP fits
# ---------------------------------------------------------------------------

#: 1.5 h diurnal Demeter scenarios (ARIMA forecaster, a failure every 20
#: minutes, profiling every 10 minutes) with the default bank GP fits: the
#: seeds of the grid (on each, the first pick that ranks GP posteriors
#: agrees and the second parts), those whose reconfiguration counts part
#: too (the port makes one more), and those whose second pick parts at the
#: feasibility of candidates on the latency constraint's edge
PARTING_GRID, COUNTS_PART, FEASIBILITY_PARTS = (0, 1, 2, 3), (2, 3), (2,)


def _record_picks(monkeypatch, cls, log):
    """Wrap ``cls._pick_config`` so that each controller (in the order the
    sweep builds them: one a scenario) logs every pick with the usage and
    latency means of all candidates, the latency constraint, the feasible
    order and the rank taken."""
    post_init, pick = cls.__post_init__, cls._pick_config

    def init(self):
        post_init(self)
        log.append([])
        self._pick_log = log[-1]

    def logged(self, segment):
        out = pick(self, segment)
        entry = {"pick": out}
        if out is not None:
            mu = np.asarray(self._objective_posterior(segment)(
                self._candidates)[0])
            entry["mu"], entry["latency"] = mu[:, 0], mu[:, 1]
            entry["constraint"] = self.lc.constraint()
            entry["feasible"] = np.flatnonzero(mu[:, 1] < entry["constraint"])
            entry["k"] = min(int(np.floor(self.hp.safety_buffer
                                          * len(entry["feasible"]))),
                             len(entry["feasible"]) - 1)
        self._pick_log.append(entry)
        return out

    monkeypatch.setattr(cls, "__post_init__", init)
    monkeypatch.setattr(cls, "_pick_config", logged)


def test_reconfigurations_part_at_a_near_tie_of_the_gp_fits(monkeypatch):
    """On 1.5 h grids the port and the reference run the same GP fit
    (optax's L-BFGS with the zoom line search) in float32, and part where
    its rounding decides: the first pick that ranks GP posteriors agrees on
    every seed (usage posteriors within 7e-6 of each other over the 2 592
    candidates, latency within 5e-5), and the second parts on every seed,
    once the fits have more data and a flatter optimum. There each takes
    the configuration at the same rank of the same feasible set, and the
    two picks' predicted usages differ by less than the two packages'
    usage posteriors differ over the candidates (8e-5 to 2.0e-3); on
    FEASIBILITY_PARTS the feasible sets part instead, at candidates whose
    predicted latency lies nearer the constraint than the two packages'
    latency posteriors differ. The reference's own bank fits move by as
    much when its targets move by two float32 ulps (``BANK_VS_REFERENCE``
    in ``tests/test_torch_gp.py``). A near-tie, not a logic difference; on
    COUNTS_PART the port then makes one reconfiguration more. A change that
    makes the picks agree fails here: then drop the parting from ROADMAP
    section 3."""
    from repro.core.demeter import DemeterHyperParams as RefHp
    from repro.dsp import PeriodicFailures as RefFailures
    from repro.dsp import ScenarioSpec as RefSpec
    from repro.dsp import make_trace as ref_trace
    specs = [RefSpec(trace=ref_trace("diurnal", duration_s=5400.0, dt_s=5.0),
                     controller="demeter", seed=s,
                     failures=RefFailures(1200.0), forecaster="arima")
             for s in PARTING_GRID]
    logs = {"ref": [], "port": []}
    _record_picks(monkeypatch, RefCtl, logs["ref"])
    _record_picks(monkeypatch, DemeterController, logs["port"])
    ref = ref_run_sweep(specs, config=RefEngineConfig(
        sim_backend="fused", hp=RefHp(profile_interval_s=600)))
    got = run_sweep(port_specs(specs), config=EngineConfig(
        sim_backend="fused", device="cpu",
        hp=DemeterHyperParams(profile_interval_s=600)))
    counts_part, feasibility_parts = [], []
    for j, (a, b) in enumerate(zip(ref.scenarios, got.scenarios)):
        ra, pb = logs["ref"][j], logs["port"][j]
        i = next((i for i, (x, y) in enumerate(zip(ra, pb))
                  if (x["pick"] is None) != (y["pick"] is None)
                  or (x["pick"] is not None
                      and x["pick"][0] != y["pick"][0])), None)
        assert i is not None, f"{a.name}: the picks agree; the parting is gone"
        assert i == 1 and ra[0]["pick"] is not None, \
            f"{a.name}: pick {i} parts"
        if a.n_reconfigurations != b.n_reconfigurations:
            counts_part.append(PARTING_GRID[j])
        x, y = ra[i], pb[i]
        assert x["pick"] is not None and y["pick"] is not None
        assert x["constraint"] == pytest.approx(y["constraint"], rel=1e-9)
        spread = float(np.max(np.abs(x["mu"] - y["mu"])))
        lat_spread = float(np.max(np.abs(x["latency"] - y["latency"])))
        margin = abs(x["pick"][1] - y["pick"][1])
        flips = np.setxor1d(x["feasible"], y["feasible"])
        edge = float(np.max(np.abs(x["latency"][flips] - x["constraint"]),
                            initial=0.0))
        print(f"{a.name}: pick {i} parts: reference "
              f"{x['pick'][0]} ({x['pick'][1]}), port {y['pick'][0]} "
              f"({y['pick'][1]}); margin {margin}, usage posteriors "
              f"differ by up to {spread} over {len(x['mu'])} candidates, "
              f"latency by {lat_spread}; {len(flips)} candidates change "
              f"feasibility, within {edge} of the constraint; "
              f"reconfigurations {a.n_reconfigurations} vs "
              f"{b.n_reconfigurations}")
        if len(flips):
            feasibility_parts.append(PARTING_GRID[j])
            assert edge < lat_spread
        else:
            assert x["k"] == y["k"]
            assert margin < spread
        assert abs(a.n_reconfigurations - b.n_reconfigurations) <= 1
    assert tuple(counts_part) == COUNTS_PART
    assert tuple(feasibility_parts) == FEASIBILITY_PARTS
