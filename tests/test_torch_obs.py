"""The port's ``obs`` against the reference's (a port copy of
``tests/test_obs.py`` under the port's names, plus the differentials).

* trace, metrics, export and the instrumentation probe: the reference
  tests' analogues; the probe counts aten operations (a clean function
  passes, a leaky one fails on its op count) and passes on the port's own
  hot calls (an interval of the fused engine, a forecast-bank flush, a
  detector sample, an epoch's ingest reduce);
* the two file formats cross both ways: a bench and a trace written by the
  port load with the reference's ``load_bench``/``diff_bench`` and its
  ``scripts/obs_report.py``, and the reference's files with the port's;
* ``run_sweep`` on the CPU over the reference test's smoke specs (fused
  engine) and a small Demeter grid that fits GPs: obs off and on give the
  same ``to_json()`` bit for bit, and the span names, the counter names
  and the event counters' values equal the reference's (the reference's
  ``recompiles.*`` jit-cache counters have the port's ``kernel_loads.*``
  as counterparts; ``sweep.device_config_rebuilds`` is counted by the
  port's fused engine, the reference's sharded engine only);
* the reference test's overhead bound (best of 5, 2% plus 2 ms) on the
  port's fused engine on the CPU.
"""
import json
import subprocess
import sys
import time
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
import torch  # noqa: E402

from helpers.sharded_diff import VOLATILE  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.demeter import DemeterHyperParams as RefHp  # noqa: E402
from repro.dsp import run_sweep as ref_run_sweep  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import DetectorBank, EngineConfig, ForecastBank  # noqa: E402,E501
from repro_torch.core.demeter import DemeterHyperParams  # noqa: E402
from repro_torch.dsp import (ClusterModel, FusedSweepExecutor,  # noqa: E402
                             JobConfig, run_sweep)
from repro_torch.fleet.ingest import IngestBuffer  # noqa: E402
from test_torch_sweep import port_specs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
OBS_REPORT = REPO / "scripts" / "obs_report.py"

#: counters that count events: equal to the reference's on the same specs
EVENT_COUNTERS = ("sweep.ticks", "sweep.intervals", "sweep.scenario_ticks",
                  "sweep.policy_triggers", "sweep.reconfigurations",
                  "sweep.forecast_flushes", "sweep.forecast_updates",
                  "sweep.gp_fits", "sweep.profile_runs")
#: the reference's sharded engine counts device-config rebuilds; in the
#: port the fused engine is the one that rebuilds them
PORT_ONLY_COUNTERS = {"sweep.device_config_rebuilds"}


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' obs off and cleared."""
    for o in (obs, ref_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# trace.py
# ---------------------------------------------------------------------------

class TestTrace:
    def test_disabled_span_is_shared_singleton(self):
        a = obs.span("x", k=1)
        b = obs.span("y")
        assert a is b, "disabled span() must return one shared no-op"
        with a:
            pass
        assert not obs.tracer().events

    def test_disabled_metrics_do_not_record(self):
        obs.inc("c", 5)
        obs.set_gauge("g", 1.0)
        obs.observe("h", 0.5, buckets=(1.0,))
        obs.track_kernel_loads("k", 3)
        snap = obs.snapshot()
        assert snap == {"counters": {}, "gauges": {}, "histograms": {}}

    def test_span_nesting_depths(self):
        obs.enable(clear=True)
        with obs.span("outer"):
            with obs.span("inner"):
                with obs.span("leaf", tag=3):
                    pass
            with obs.span("inner2"):
                pass
        obs.disable()
        recs = {r.name: r for r in obs.tracer().events}
        assert recs["outer"].depth == 0
        assert recs["inner"].depth == 1
        assert recs["leaf"].depth == 2
        assert recs["inner2"].depth == 1
        assert recs["leaf"].attrs == {"tag": 3}
        assert recs["outer"].dur_ns >= recs["inner"].dur_ns

    def test_timestamps_monotonic_ns(self):
        obs.enable(clear=True)
        with obs.span("a"):
            time.sleep(0.001)
        with obs.span("b"):
            pass
        obs.disable()
        a, b = obs.tracer().events
        assert a.dur_ns >= 1_000_000          # slept >= 1 ms
        assert b.ts_ns >= a.ts_ns + a.dur_ns  # b started after a ended

    def test_enabled_scope_restores(self):
        assert not obs.enabled()
        with obs.enabled_scope():
            assert obs.enabled()
        assert not obs.enabled()
        obs.enable()
        with obs.trace.force_disabled():
            assert not obs.enabled()
        assert obs.enabled()
        with obs.force_enabled():
            assert obs.enabled()

    def test_max_events_drops_are_counted(self):
        tr = obs.trace.Tracer(max_events=2)
        for i in range(5):
            with tr.span(f"s{i}", {}):
                pass
        assert len(tr.events) == 2
        assert tr.dropped == 3

    def test_torch_profiler_bridge(self):
        """``enable(torch_profiler=True)`` wraps each span in a
        ``record_function`` range that a ``torch.profiler`` capture
        records; without it the capture has no such range."""
        from torch.profiler import ProfilerActivity, profile
        seen = {}
        for bridge in (True, False):
            obs.enable(clear=True, torch_profiler=bridge)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with obs.span("fleet.epoch"):
                    torch.ones(4).sum()
            obs.disable()
            seen[bridge] = {e.key for e in prof.key_averages()}
        assert "fleet.epoch" in seen[True]
        assert "fleet.epoch" not in seen[False]
        assert not obs.trace._TORCH_PROFILER


# ---------------------------------------------------------------------------
# metrics.py
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_histogram(self):
        obs.enable(clear=True)
        obs.inc("sweep.ticks")
        obs.inc("sweep.ticks", 4)
        obs.set_gauge("g", 2.5)
        for v in (0.5, 1.5, 99.0):
            obs.observe("h", v, buckets=(1.0, 10.0))
        obs.disable()
        snap = obs.snapshot()
        assert snap["counters"]["sweep.ticks"] == 5
        assert snap["gauges"]["g"] == 2.5
        h = snap["histograms"]["h"]
        assert h["counts"] == [1, 1, 1]       # <=1, <=10, overflow
        assert h["total"] == 3
        assert h["sum"] == pytest.approx(101.0)

    def test_track_kernel_loads_counts_growth_only(self):
        obs.enable(clear=True)
        obs.track_kernel_loads("f", 1)
        obs.track_kernel_loads("f", 1)        # no growth
        obs.track_kernel_loads("f", 3)        # +2
        obs.disable()
        snap = obs.snapshot()
        assert snap["counters"] == {"kernel_loads.f": 3}
        assert snap["gauges"] == {"kernel_libs.f": 3}

    def test_kernel_libs_loaded_reads_the_build_record(self, monkeypatch):
        from repro_torch.kernels import build
        monkeypatch.setattr(build, "load_wall_s", {"rls_update": 0.5})
        assert obs.kernel_libs_loaded(("rls_update",)) == 1
        assert obs.kernel_libs_loaded(("fused_tick", "rls_update")) == 1
        assert obs.kernel_libs_loaded(("fused_tick",)) == 0

    def test_track_launches_is_a_gauge(self):
        from repro_torch.kernels import rls_update as k1
        n = k1.arima_chunk.launches
        obs.enable(clear=True)
        obs.track_launches(k1.arima_chunk)
        obs.disable()
        snap = obs.snapshot()
        assert snap["gauges"] == {"launches.arima_chunk": n}
        assert snap["counters"] == {}

    def test_timed_phase_accumulates(self):
        obs.enable(clear=True)
        with obs.timed_phase("simulate", "spanname"):
            time.sleep(0.001)
        obs.disable()
        snap = obs.snapshot()
        assert snap["counters"]["phase.simulate_wall_s"] >= 0.001
        assert obs.tracer().events[0].name == "spanname"

    def test_timed_phase_disabled_is_singleton(self):
        a = obs.timed_phase("simulate", "x")
        b = obs.timed_phase("fit", "y")
        assert a is b

    def test_api_is_the_reference_minus_jit(self):
        """The port's ``__all__`` is the reference's with the jit-cache
        names swapped for the kernel-library ones."""
        jit = {"track_jit_cache", "jit_cache_size"}
        port = {"track_kernel_loads", "kernel_libs_loaded", "track_launches"}
        assert jit <= set(ref_obs.__all__)
        assert set(obs.__all__) == (set(ref_obs.__all__) - jit) | port
        assert obs.metrics.PHASES == ref_obs.metrics.PHASES


# ---------------------------------------------------------------------------
# export.py, and the formats across the two packages
# ---------------------------------------------------------------------------

def _bench_doc(pkg, sps: float):
    leg = pkg.make_leg(engine="fused", devices=1, seed=0, mode="smoke",
                       scenarios=4, scenario_steps_per_s=sps)
    return {"schema": pkg.BENCH_SCHEMA, "benches": {"b": {"legs": [leg]}}}


class TestExport:
    def test_chrome_trace_round_trip(self, tmp_path):
        obs.enable(clear=True)
        with obs.span("sweep.run", engine="fused"):
            with obs.span("engine.step"):
                pass
        obs.inc("sweep.ticks", 7)
        obs.disable()
        path = tmp_path / "trace.json"
        obs.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        assert doc["otherData"]["schema"] == obs.TRACE_SCHEMA
        events = doc["traceEvents"]
        assert [e["name"] for e in events] == ["engine.step", "sweep.run"]
        for e in events:
            assert e["ph"] == "X"
            assert e["dur"] >= 0 and e["ts"] >= 0    # micros
        assert events[1]["args"]["engine"] == "fused"
        assert events[0]["args"]["depth"] == 1
        assert events[0]["cat"] == "engine"
        assert doc["otherData"]["metrics"]["counters"]["sweep.ticks"] == 7

    def test_merge_bench_and_schema(self, tmp_path):
        path = str(tmp_path / "bench.json")
        leg = obs.make_leg(engine="fused", devices=2, seed=0, mode="smoke",
                           scenarios=4, scenario_steps_per_s=1000.0)
        obs.merge_bench(path, "sweep_scaling", [leg], params={"dt": 5.0})
        obs.merge_bench(path, "other", [obs.make_leg(
            engine="batched", devices=1, seed=1)])
        doc = obs.load_bench(path)
        assert doc["schema"] == obs.BENCH_SCHEMA
        assert set(doc["benches"]) == {"sweep_scaling", "other"}
        assert doc["benches"]["sweep_scaling"]["params"] == {"dt": 5.0}

    def test_load_bench_rejects_wrong_schema(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text('{"schema": "other/9", "benches": {}}')
        with pytest.raises(ValueError, match="unsupported bench schema"):
            obs.load_bench(str(p))

    @pytest.mark.parametrize("new,n_reg,status", [
        (700.0, 1, "REGRESSION"), (900.0, 0, "ok"), (1300.0, 0, "improved")])
    def test_diff_statuses(self, new, n_reg, status):
        rows, n = obs.diff_bench(_bench_doc(obs, 1000.0),
                                 _bench_doc(obs, new))
        assert (n, rows[0]["status"]) == (n_reg, status)
        assert obs.format_diff(rows, 0.2) == \
            ref_obs.format_diff(rows, 0.2)

    def test_diff_new_leg_is_not_regression(self):
        rows, n = obs.diff_bench({"schema": obs.BENCH_SCHEMA, "benches": {}},
                                 _bench_doc(obs, 1.0))
        assert n == 0
        assert rows[0]["status"] == "new"

    def test_schemas_are_the_reference_s(self):
        assert obs.TRACE_SCHEMA == ref_obs.TRACE_SCHEMA == "repro.trace/1"
        assert obs.BENCH_SCHEMA == ref_obs.BENCH_SCHEMA == "repro.bench/1"
        assert obs.leg_key("b", {"engine": "e", "seed": 1}) == \
            ref_obs.leg_key("b", {"engine": "e", "seed": 1})

    @pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                               ("reference", "port")])
    def test_bench_crosses_packages(self, writer, reader, tmp_path):
        w, r = {"port": (obs, ref_obs),
                "reference": (ref_obs, obs)}[writer]
        old, new = str(tmp_path / "old.json"), str(tmp_path / "new.json")
        for path, sps in ((old, 1000.0), (new, 700.0)):
            w.merge_bench(path, "fleet_soak", [w.make_leg(
                engine="torch-fleet-sim", devices=1, seed=0, mode="soak",
                scenarios=8, scenario_steps_per_s=sps)],
                params={"churn_every": 3})
        a, b = r.load_bench(old), r.load_bench(new)
        assert a["benches"]["fleet_soak"]["params"] == {"churn_every": 3}
        rows, n = r.diff_bench(a, b)
        assert n == 1 and rows[0]["status"] == "REGRESSION"
        assert (rows, n) == w.diff_bench(a, b)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_trace_crosses_packages(self, writer, tmp_path):
        """A trace from either package is the same document shape, and the
        reference's ``obs_report.py`` summarizes the port's."""
        w = obs if writer == "port" else ref_obs
        w.enable(clear=True)
        with w.span("sweep.run", engine="fused"):
            with w.span("engine.fused.interval", K=12):
                pass
        w.inc("sweep.intervals")
        w.disable()
        path = tmp_path / "trace.json"
        w.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
        assert doc["otherData"]["schema"] == ref_obs.TRACE_SCHEMA
        assert [e["name"] for e in doc["traceEvents"]] == \
            ["engine.fused.interval", "sweep.run"]
        proc = subprocess.run([sys.executable, str(OBS_REPORT), str(path)],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "engine.fused.interval" in proc.stdout

    def test_obs_report_diffs_port_benches(self, tmp_path):
        old, new = tmp_path / "old.json", tmp_path / "new.json"
        old.write_text(json.dumps(_bench_doc(obs, 1000.0)))
        new.write_text(json.dumps(_bench_doc(obs, 700.0)))
        proc = subprocess.run(
            [sys.executable, str(OBS_REPORT), "--diff", str(old), str(new)],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "REGRESSION" in proc.stdout


# ---------------------------------------------------------------------------
# probe.py: the aten-op probe catches leaks and passes the port's hot calls
# ---------------------------------------------------------------------------

def _fused_executor(S: int = 4):
    return FusedSweepExecutor(ClusterModel(), [JobConfig()] * S,
                              seeds=range(S), dt=5.0, n_steps=16 * 8,
                              device="cpu")


class TestInstrumentationProbe:
    def test_clean_function_passes(self):
        def f(x):
            with obs.span("f"):
                with obs.timed_phase("simulate", "g"):
                    obs.inc("n")
                    return torch.sin(x) + 1.0

        report = obs.instrumentation_probe("test:clean", f, (torch.ones(4),))
        assert report.ok, report.violations
        assert report.baseline == report.with_obs == 2
        assert report.ops == {"aten.sin.default": 1, "aten.add.Tensor": 1}

    @pytest.mark.parametrize("leak", ["reduction", "item", "copy"])
    def test_leaky_instrumentation_fails(self, leak):
        """An obs call site that adds an operation when obs is on (an extra
        reduction for a metric, an ``.item()``, a copy back) fails."""
        def f(x):
            y = torch.sin(x)
            if obs.enabled():
                if leak == "reduction":
                    obs.inc("sum", y + torch.cos(x) * 2.0)
                elif leak == "item":
                    obs.set_gauge("max", y.max().item())
                else:
                    obs.set_gauge("y", y.to("cpu", copy=True))
            return y

        report = obs.instrumentation_probe("test:leaky", f, (torch.ones(4),))
        assert not report.ok
        assert report.with_obs > report.baseline
        want = {"reduction": "aten.cos", "item": "aten._local_scalar_dense",
                "copy": "aten._to_copy"}[leak]
        assert any(v.startswith(want) for v in report.violations), \
            report.violations

    def test_synchronize_counts_as_a_violation(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

        def f(x):
            if obs.enabled():
                torch.cuda.synchronize()
            return x + 1

        report = obs.instrumentation_probe("test:sync", f, (torch.ones(2),))
        assert not report.ok
        assert report.violations == ["torch.cuda.synchronize: 0 -> 1"]

    def test_fused_interval(self):
        ex = _fused_executor()
        ex.step_interval(np.full((12, 4), 1000.0))    # build the configs
        report = obs.instrumentation_probe(
            "fused:step_interval", ex.step_interval,
            (np.full((12, 4), 1000.0),))
        assert report.ok, report.violations
        assert report.baseline > 0

    def test_forecast_bank_flush(self):
        bank = ForecastBank(["arima"] * 6 + ["holt"] * 2, device="cpu")
        rng = np.random.default_rng(0)

        def stage_and_flush():
            for _ in range(12):
                for r in range(8):
                    bank.stage(r, float(1000.0 + rng.normal(0, 10)))
            bank.flush()

        stage_and_flush()
        report = obs.instrumentation_probe("forecast:flush", stage_and_flush)
        assert report.ok, report.violations
        assert report.baseline > 0

    def test_detector_and_ingest(self):
        det = DetectorBank(8, device="cpu")
        buf = IngestBuffer(8, device="cpu")
        vals = np.linspace(1.0, 2.0, 8)
        t = [0.0]

        def epoch():
            t[0] += 60.0
            for r in range(8):
                buf.offer(r, t[0] - 30.0, {"rate": vals[r], "latency": 1.0})
            buf.drain(t[0])
            det.observe(vals)

        epoch()
        report = obs.instrumentation_probe("fleet:epoch", epoch)
        assert report.ok, report.violations


# ---------------------------------------------------------------------------
# sweep integration: results unperturbed, names and event counts as the
# reference's, overhead bounded
# ---------------------------------------------------------------------------

def _smoke_specs():
    from repro.dsp import PeriodicFailures, ScenarioSpec, make_trace
    return [ScenarioSpec(trace=make_trace("diurnal", duration_s=300.0,
                                          dt_s=5.0),
                         controller="reactive", seed=s,
                         failures=PeriodicFailures(120.0))
            for s in range(3)]


def _demeter_specs():
    """Two Demeter scenarios (ARIMA and Holt), 1 h, a failure every 20
    minutes, profiling every 10 minutes: GP fits, acquisitions and
    profiling clones, with every decision equal in both packages."""
    from repro.dsp import PeriodicFailures, ScenarioSpec, make_trace
    return [ScenarioSpec(trace=make_trace(k, duration_s=3600.0, dt_s=5.0),
                         controller="demeter", seed=s,
                         failures=PeriodicFailures(1200.0), forecaster=f)
            for k, s, f in (("diurnal", 0, "arima"), ("flash", 1, "holt"))]


CASES = {"smoke": (_smoke_specs, {}),
         "demeter": (_demeter_specs, {"profile_interval_s": 600})}


def _strip(result) -> dict:
    return {k: v for k, v in result.to_json().items() if k not in VOLATILE}


def _observed(pkg, run):
    pkg.enable(clear=True)
    pkg.reset()
    try:
        res = run()
    finally:
        pkg.disable()
    return res, {r.name for r in pkg.tracer().events}, pkg.snapshot()


@pytest.fixture(scope="module")
def sweeps():
    out = {}
    for case, (specs_fn, hp) in CASES.items():
        ref_cfg = RefEngineConfig(sim_backend="fused",
                                  hp=RefHp(**hp) if hp else None)
        cfg = EngineConfig(sim_backend="fused", device="cpu",
                           hp=DemeterHyperParams(**hp) if hp else None)
        _, ref_names, ref_snap = _observed(
            ref_obs, lambda: ref_run_sweep(specs_fn(), config=ref_cfg))
        off = run_sweep(port_specs(specs_fn()), config=cfg)
        on, names, snap = _observed(
            obs, lambda: run_sweep(port_specs(specs_fn()), config=cfg))
        out[case] = dict(off=off, on=on, names=names, snap=snap,
                         ref_names=ref_names, ref_snap=ref_snap)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
class TestSweepIntegration:
    def test_obs_off_and_on_bit_identical(self, case, sweeps):
        s = sweeps[case]
        assert _strip(s["on"]) == _strip(s["off"])
        assert "sweep.run" in s["names"]
        assert "engine.fused.interval" in s["names"]
        counters = s["snap"]["counters"]
        assert counters["sweep.ticks"] == s["off"].n_steps
        assert counters["sweep.intervals"] >= 1

    def test_span_names_equal_reference(self, case, sweeps):
        s = sweeps[case]
        assert s["names"] == s["ref_names"]
        if case == "demeter":
            assert {"gp_bank.fit", "demeter.acquire", "engine.profile",
                    "forecast.flush_and_roll"} <= s["names"]

    def test_counter_names_equal_reference(self, case, sweeps):
        s = sweeps[case]
        ref = {n for n in s["ref_snap"]["counters"]
               if not n.startswith("recompiles.")}
        port = {n for n in s["snap"]["counters"]
                if not n.startswith("kernel_loads.")}
        assert port - PORT_ONLY_COUNTERS == ref
        assert PORT_ONLY_COUNTERS <= port
        # no kernel library loads on the CPU; the gauges hold the counts
        assert not any(n.startswith("kernel_loads.")
                       for n in s["snap"]["counters"])
        assert s["snap"]["gauges"]["launches.fused_interval"] >= 0

    def test_event_counters_equal_reference(self, case, sweeps):
        s = sweeps[case]
        ref, port = s["ref_snap"]["counters"], s["snap"]["counters"]
        got = {k: port.get(k) for k in EVENT_COUNTERS}
        assert got == {k: ref.get(k) for k in EVENT_COUNTERS}
        if case == "demeter":
            assert got["sweep.gp_fits"] > 0 and got["sweep.profile_runs"] > 0
            assert got["sweep.forecast_updates"] > 0


def test_overhead_bound_on_fused_engine():
    """Instrumentation overhead on the fused hot loop stays under 2% (plus
    an absolute slack for timer noise on shared machines)."""
    def run_once(ex):
        t0 = time.perf_counter()
        ex.step_interval(np.full((16, 4), 1000.0))
        return time.perf_counter() - t0

    run_once(_fused_executor())
    best_off, best_on = np.inf, np.inf
    for _ in range(5):
        best_off = min(best_off, run_once(_fused_executor()))
        ex = _fused_executor()
        obs.enable(clear=True)
        try:
            best_on = min(best_on, run_once(ex))
        finally:
            obs.disable()
    assert best_on <= best_off * 1.02 + 2e-3, \
        f"obs overhead too high: {best_off:.6f}s -> {best_on:.6f}s"
