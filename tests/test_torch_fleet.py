"""The port's fleet service against the reference's (a port copy of
``tests/test_fleet.py`` under the port's names, plus the differentials).

* ``IngestBuffer``: the reference tests' units, and both buffers fed the
  same seeded offers (late, out of order, overflowing, partial drains):
  equal counts and counters, means within one float32 ulp;
* bank slot recycling (``reset_rows`` on both banks), the
  ``FleetController`` units with the reference test's ``_FakeExec``, and
  ``SoakConfig`` validation;
* ``run_soak`` on the CPU against the reference's: the 64-job x 6-epoch
  soak and two soaks with profiling on (16 x 30, and 64 x 30, which
  reaches profiling epochs and GP fits) give the reference's decision
  digest and ``stats()``, and every count of the result, walls apart;
* the serving layer's bounded-state checks against the port's
  ``serving/``.
"""
import collections

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

from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.fleet.ingest import IngestBuffer as RefIngestBuffer  # noqa: E402
from repro.fleet.loadgen import SoakConfig as RefSoakConfig  # noqa: E402
from repro.fleet.loadgen import run_soak as ref_run_soak  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import EngineConfig  # noqa: E402
from repro_torch.core.config_space import paper_flink_space  # noqa: E402
from repro_torch.core.forecast_bank import (DetectorBank,  # noqa: E402
                                            ForecastBank)
from repro_torch.core.registry import FLEET_BACKENDS  # noqa: E402
from repro_torch.fleet.ingest import (INGEST_KEYS, IngestBuffer,  # noqa: E402
                                      epoch_reduce)
from repro_torch.fleet.loadgen import SoakConfig, run_soak  # noqa: E402
from repro_torch.fleet.service import (COLD_UTIL_REVERT,  # noqa: E402
                                       FleetConfig, FleetController)

CPU = EngineConfig(device="cpu")
#: run_soak's fields that are walls or rates over walls
WALL_KEYS = ("wall_s", "decisions_per_s", "ingest_samples_per_s",
             "scenario_steps_per_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ingestion
# ---------------------------------------------------------------------------


class TestIngestBuffer:
    def test_offer_drain_means(self):
        buf = IngestBuffer(4, device="cpu")
        buf.offer(0, 10.0, {"rate": 100.0, "latency": 2.0, "usage": 0.5})
        buf.offer(0, 20.0, {"rate": 300.0, "latency": 4.0, "usage": 0.7})
        buf.offer(2, 15.0, {"rate": 50.0})      # latency/usage absent -> NaN
        means, counts = buf.drain(60.0)
        k = {name: i for i, name in enumerate(INGEST_KEYS)}
        assert means[0, k["rate"]] == pytest.approx(200.0)
        assert means[0, k["latency"]] == pytest.approx(3.0)
        assert counts[0, k["rate"]] == 2
        assert means[2, k["rate"]] == pytest.approx(50.0)
        assert np.isnan(means[2, k["latency"]])
        assert counts[2, k["latency"]] == 0
        assert np.isnan(means[1]).all() and counts[1].sum() == 0
        assert buf.accepted == 3 and buf.drained == 3

    def test_late_samples_dropped_behind_watermark(self):
        buf = IngestBuffer(2, lateness_s=30.0, device="cpu")
        buf.offer(0, 10.0, {"rate": 1.0})
        buf.drain(60.0)                          # watermark -> 30.0
        assert not buf.offer(0, 25.0, {"rate": 9.0})
        assert buf.dropped_late == 1
        assert buf.offer(0, 45.0, {"rate": 5.0})
        means, _ = buf.drain(120.0)
        assert means[0, 0] == pytest.approx(5.0)

    def test_out_of_order_counted_not_dropped(self):
        buf = IngestBuffer(1, device="cpu")
        buf.offer(0, 20.0, {"rate": 2.0})
        buf.offer(0, 10.0, {"rate": 4.0})
        assert buf.out_of_order == 1
        means, counts = buf.drain(60.0)
        assert counts[0, 0] == 2 and means[0, 0] == pytest.approx(3.0)

    def test_overflow_sheds_oldest(self):
        buf = IngestBuffer(1, queue_cap=3, device="cpu")
        for i in range(5):
            buf.offer(0, float(i), {"rate": float(i)})
        assert buf.dropped_overflow == 2
        assert buf.queue_depth(0) == 3
        means, _ = buf.drain(60.0)
        assert means[0, 0] == pytest.approx(np.mean([2.0, 3.0, 4.0]))

    def test_partial_drain_keeps_future_samples(self):
        buf = IngestBuffer(1, device="cpu")
        buf.offer(0, 30.0, {"rate": 1.0})
        buf.offer(0, 90.0, {"rate": 7.0})
        means, counts = buf.drain(60.0)
        assert counts[0, 0] == 1 and means[0, 0] == pytest.approx(1.0)
        means, counts = buf.drain(120.0)
        assert counts[0, 0] == 1 and means[0, 0] == pytest.approx(7.0)

    def test_clear_row_resets_queue_and_watermark(self):
        buf = IngestBuffer(2, device="cpu")
        buf.offer(1, 10.0, {"rate": 1.0})
        buf.drain(60.0)
        buf.clear_row(1)
        assert buf.queue_depth(1) == 0
        assert buf.offer(1, 0.5, {"rate": 2.0})

    def test_bad_sizes_raise(self):
        with pytest.raises(ValueError, match="capacity >= 1"):
            IngestBuffer(0, device="cpu")
        with pytest.raises(ValueError, match="queue_cap must be >= 1"):
            IngestBuffer(2, queue_cap=0, device="cpu")

    def test_reduce_pads_to_powers_of_two_and_sums_in_order(self,
                                                            monkeypatch):
        """The sample axis is padded to a power of two (minimum 4), and the
        sum adds one sample at a time in index order."""
        import repro_torch.fleet.ingest as ingest_mod
        buf = IngestBuffer(1, device="cpu")
        seen = []

        def spy(vals):
            seen.append(vals.shape[1])
            return epoch_reduce(vals)

        monkeypatch.setattr(ingest_mod, "epoch_reduce", spy)
        for n in (1, 3, 4, 5, 9):
            for j in range(n):
                buf.offer(0, 1.0 + j, {"rate": 1.0})
            buf.drain(float(n + 1))
            buf.clear_row(0)
        assert seen == [4, 4, 4, 8, 16]
        vals = torch.tensor([[[1e8], [1.0], [-1e8], [1.0]]],
                            dtype=torch.float32)
        # ((1e8 + 1) - 1e8) + 1 in float32 is 1, not the exact 2
        assert epoch_reduce(vals)[0, 0].item() == 0.25

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_reference_on_seeded_offers(self, seed):
        """Both buffers fed the same offers: equal counts and counters, and
        means within one float32 ulp of the reference's."""
        rng = np.random.default_rng(seed)
        R = 24
        port = IngestBuffer(R, queue_cap=16, lateness_s=90.0, device="cpu")
        ref = RefIngestBuffer(R, queue_cap=16, lateness_s=90.0)
        for epoch in range(1, 7):
            t_end = 60.0 * epoch
            n = int(rng.integers(0, 12 * R))
            rows = rng.integers(0, R, n)
            ts = t_end - rng.uniform(-30.0, 200.0, n)   # late and future
            for r, t in zip(rows, ts):
                m = {k: float(rng.lognormal(3.0, 2.0))
                     for k in INGEST_KEYS if rng.random() > 0.15}
                assert port.offer(int(r), float(t), m) == \
                    ref.offer(int(r), float(t), m)
            if epoch == 4:
                for b in (port, ref):
                    b.clear_row(3)
            (pm, pc), (rm, rc) = port.drain(t_end), ref.drain(t_end)
            np.testing.assert_array_equal(pc, np.asarray(rc))
            np.testing.assert_array_equal(np.isnan(pm), np.isnan(rm))
            ok = ~np.isnan(pm)
            ulp = np.spacing(np.abs(rm[ok]).astype(np.float32))
            assert np.all(np.abs(pm[ok] - rm[ok]) <= ulp)
            assert pm.dtype == np.float64
        for name in ("accepted", "dropped_late", "dropped_overflow",
                     "out_of_order", "drained"):
            assert getattr(port, name) == getattr(ref, name), name
        assert port.max_queue_depth() == ref.max_queue_depth()
        np.testing.assert_array_equal(port.watermark, ref.watermark)
        assert port.dropped_late and port.dropped_overflow \
            and port.out_of_order

    def test_entry_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IngestBuffer(2)


# ---------------------------------------------------------------------------
# bank slot recycling
# ---------------------------------------------------------------------------


class TestBankResets:
    def test_forecast_bank_reset_rows(self):
        fb = ForecastBank.from_kinds(["arima"] * 4, horizon=4, device="cpu")
        for step in range(6):
            for r in range(4):
                fb.stage(r, 100.0 + 10.0 * r + step)
            fb.flush()
        assert all(v.n_observed == 6 for v in fb.views())
        assert fb.reset_rows([1, 3]) == 2
        views = fb.views()
        assert views[1].n_observed == 0 and views[3].n_observed == 0
        assert views[0].n_observed == 6 and views[2].n_observed == 6
        fb.stage(1, 42.0)
        fb.flush()
        assert fb.views()[1].n_observed == 1
        assert fb.reset_rows([]) == 0

    def test_detector_bank_reset_rows(self):
        det = DetectorBank(3, min_warmup=4, device="cpu")
        for _ in range(30):
            det.observe(np.array([10.0, 10.0, 10.0]))
        det.reset_rows([0])
        flags = det.observe(np.array([500.0, 500.0, 500.0]))
        assert not flags[0] and flags[1] and flags[2]

    def test_reset_rows_spans(self):
        fb = ForecastBank.from_kinds(["arima"] * 2, device="cpu")
        obs.enable(clear=True)
        obs.reset()
        try:
            fb.reset_rows([1])
        finally:
            obs.disable()
        (rec,) = obs.tracer().events
        assert (rec.name, rec.attrs) == ("forecast.reset_rows",
                                         {"streams": 1})
        assert obs.snapshot()["counters"]["phase.forecast_wall_s"] >= 0
        obs.reset()


# ---------------------------------------------------------------------------
# the service loop
# ---------------------------------------------------------------------------


class _FakeExec:
    """Minimal scalar Executor for service-policy tests."""

    def __init__(self):
        self.cfg = {"workers": 2}
        self.reconfigures = []

    def cmax_config(self):
        return {"workers": 8}

    def current_config(self):
        return dict(self.cfg)

    def reconfigure(self, config):
        self.cfg = dict(config)
        self.reconfigures.append(dict(config))

    def observe(self):
        return {}

    def profile(self, configs, rate):
        return []

    def allocated_cost(self, config):
        return config["workers"] / 8.0


def _small_fleet(**kw) -> FleetController:
    kw.setdefault("capacity", 4)
    kw.setdefault("cold_start_min_obs", 2)
    return FleetController(config=CPU, fleet=FleetConfig(**kw))


class TestFleetService:
    def test_register_deregister_slot_reuse(self):
        fleet = _small_fleet()
        space = paper_flink_space()
        assert fleet.register_job("a", _FakeExec(), space) == 0
        assert fleet.register_job("b", _FakeExec(), space) == 1
        assert fleet.register_job("c", _FakeExec(), space) == 2
        fleet.deregister_job("b")
        assert fleet.register_job("d", _FakeExec(), space) == 1
        assert fleet.n_jobs == 3
        with pytest.raises(ValueError, match="already registered"):
            fleet.register_job("a", _FakeExec(), space)
        with pytest.raises(ValueError, match="unknown job"):
            fleet.deregister_job("nope")

    def test_capacity_exhaustion(self):
        fleet = _small_fleet(capacity=1)
        fleet.register_job("a", _FakeExec(), paper_flink_space())
        with pytest.raises(RuntimeError, match="at capacity"):
            fleet.register_job("b", _FakeExec(), paper_flink_space())

    def test_cold_jobs_hold_then_revert_on_overload(self):
        fleet = _small_fleet(cold_start_min_obs=99)
        ex = _FakeExec()
        fleet.register_job("a", ex, paper_flink_space())
        fleet.report_telemetry("a", 30.0,
                               {"rate": 100.0, "latency": 1.0, "usage": 0.4})
        fleet.run_epoch()
        assert ex.reconfigures == []
        fleet.report_telemetry(
            "a", 90.0, {"rate": 100.0, "latency": 1.0,
                        "usage": COLD_UTIL_REVERT + 0.05})
        fleet.run_epoch()
        assert ex.reconfigures == [{"workers": 8}]
        last = fleet.job("a").last_decision
        assert last["reason"] == "cold-revert" and last["policy"] == "cold"
        fleet.report_telemetry("a", 150.0, {"rate": 100.0, "usage": 0.99})
        fleet.run_epoch()
        assert len(ex.reconfigures) == 1

    def test_warm_up_after_min_obs(self):
        fleet = _small_fleet(cold_start_min_obs=2)
        ex, space = FLEET_BACKENDS.get("sim")(seed=0)
        fleet.register_job("a", ex, space)
        for epoch in range(2):
            fleet.report_telemetry(
                "a", 30.0 + 60.0 * epoch,
                {"rate": 800.0 + epoch, "latency": 1.5, "usage": 0.5})
            fleet.run_epoch()
        job = fleet.job("a")
        assert job.policy == "demeter" and job.ctl is not None
        assert job.epochs_observed == 2
        assert fleet.stats()["warmups"] == 1
        assert job.ctl.tsf.n_observed == 2
        # the warm controller works on the fleet's device
        assert job.ctl.config.device == "cpu"

    def test_shared_alloc_cache(self):
        fleet = _small_fleet(cold_start_min_obs=1)
        factory = FLEET_BACKENDS.get("sim")
        ex1, space = factory(seed=0)
        ex2, _ = factory(seed=1)
        fleet.register_job("a", ex1, space)
        fleet.register_job("b", ex2, space)
        for job_id in ("a", "b"):
            fleet.report_telemetry(job_id, 30.0, {"rate": 500.0,
                                                  "latency": 1.0})
        fleet.run_epoch()
        a, b = fleet.job("a"), fleet.job("b")
        assert a.ctl is not None and b.ctl is not None
        assert len(fleet._alloc_cache) >= 1
        np.testing.assert_array_equal(
            a.ctl._alloc, [ex1.allocated_cost(c) for c in space.enumerate()])

    def test_epoch_summary_and_stats_shape(self):
        fleet = _small_fleet()
        fleet.register_job("a", _FakeExec(), paper_flink_space())
        summary = fleet.run_epoch()
        assert summary["epoch"] == 1 and summary["jobs"] == 1
        stats = fleet.stats()
        assert stats["epoch"] == 1 and stats["capacity"] == 4
        assert set(stats["ingest"]) == {
            "accepted", "drained", "dropped_late", "dropped_overflow",
            "out_of_order", "max_queue_depth"}
        assert len(stats["decision_digest"]) == 64

    def test_decision_log_ring_bounded_digest_total(self):
        fleet = _small_fleet(decision_log_cap=8, cold_start_min_obs=99)
        ex = _FakeExec()
        fleet.register_job("a", ex, paper_flink_space())
        for epoch in range(20):
            ex.cfg = {"workers": 2}
            fleet.report_telemetry("a", 30.0 + 60.0 * epoch,
                                   {"rate": 1.0, "usage": 0.95})
            fleet.run_epoch()
        assert fleet.n_decisions == 20
        assert len(fleet.decision_log) == 8

    def test_digest_reflects_decision_content(self):
        digests = []
        for overload_epoch in (1, 2):
            fleet = _small_fleet(cold_start_min_obs=99)
            fleet.register_job("a", _FakeExec(), paper_flink_space())
            for epoch in range(3):
                usage = 0.99 if epoch == overload_epoch else 0.3
                fleet.report_telemetry("a", 30.0 + 60.0 * epoch,
                                       {"rate": 10.0, "usage": usage})
                fleet.run_epoch()
            assert fleet.n_decisions == 1
            digests.append(fleet.decision_digest())
        assert digests[0] != digests[1]

    def test_epoch_spans_and_counters(self):
        fleet = _small_fleet(cold_start_min_obs=99)
        fleet.register_job("a", _FakeExec(), paper_flink_space())
        fleet.report_telemetry("a", 30.0, {"rate": 1.0, "usage": 0.95})
        obs.enable(clear=True)
        obs.reset()
        try:
            fleet.run_epoch()
        finally:
            obs.disable()
        names = [r.name for r in obs.tracer().events]
        assert names == ["fleet.ingest.drain", "forecast.flush",
                         "detector.observe", "fleet.epoch"]
        c = obs.snapshot()["counters"]
        assert (c["fleet.epochs"], c["fleet.decisions"],
                c["fleet.ingest_samples"], c["sweep.detector_samples"],
                c["sweep.forecast_flushes"]) == (1, 1, 1, 1, 1)
        assert c["phase.fleet_wall_s"] > 0
        obs.reset()

    @pytest.mark.parametrize("kw", [{"capacity": 0}, {"epoch_s": 0.0},
                                    {"opt_every": 0}, {"profile_every": 0}])
    def test_fleet_config_validation(self, kw):
        with pytest.raises(ValueError):
            FleetConfig(**kw)

    def test_soak_config_validation(self):
        with pytest.raises(ValueError):
            SoakConfig(n_jobs=0)
        with pytest.raises(ValueError):
            SoakConfig(epochs=0)
        with pytest.raises(ValueError):
            SoakConfig(late_frac=1.5)
        with pytest.raises(ValueError):
            SoakConfig(lost_frac=-0.1)


# ---------------------------------------------------------------------------
# the soak against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_jobs,epochs,profiling", [
    (64, 6, False), (16, 30, True), (64, 30, True)])
def test_soak_matches_reference(n_jobs, epochs, profiling):
    ref = ref_run_soak(RefSoakConfig(n_jobs=n_jobs, epochs=epochs, seed=7,
                                     profiling=profiling),
                       RefEngineConfig())
    got = run_soak(SoakConfig(n_jobs=n_jobs, epochs=epochs, seed=7,
                              profiling=profiling), CPU)
    assert got["decision_digest"] == ref["decision_digest"]
    assert got["stats"] == ref["stats"]
    assert {k: v for k, v in got.items() if k not in WALL_KEYS} == \
        {k: v for k, v in ref.items() if k not in WALL_KEYS}
    assert got["decisions"] > 0 and got["churned"] > 0
    assert got["failures"] > 0 and got["lost"] > 0 and got["held_late"] > 0


def test_soak_is_deterministic_and_counts_its_epochs():
    cfg = SoakConfig(n_jobs=96, epochs=6, seed=3)
    r1, r2 = run_soak(cfg, CPU), run_soak(cfg, CPU)
    assert r1["decision_digest"] == r2["decision_digest"]
    stats = r1["stats"]
    assert stats["ingest"]["dropped_late"] == r1["lost"]
    assert stats["epoch"] == cfg.epochs
    assert stats["now_s"] == pytest.approx(cfg.epochs * 60.0)
    assert stats["ingest"]["max_queue_depth"] <= FleetConfig().queue_cap
    assert stats["warm"] > cfg.n_jobs * 0.9


def test_soak_runs_k1_at_one_tick_an_epoch(monkeypatch):
    """The soak's K1 shapes, which ``chip_smoke.py`` checks and times on
    the card (``FLEET_CHUNK``, ``DETECTOR_CHUNKS``): each epoch one flush
    of the forecast bank, a stream a job at the ARIMA forecaster's default
    order (k = 9) and one tick, and one detector sample on the slab padded
    to a power of two (k = 5)."""
    from repro_torch.kernels import ops
    calls = []
    chunk = ops.arima_chunk

    def record(w, *args):
        calls.append((tuple(w.shape), tuple(args[-1].shape)))
        return chunk(w, *args)

    monkeypatch.setattr(ops, "arima_chunk", record)
    cfg = SoakConfig(n_jobs=96, epochs=4, seed=0)
    run_soak(cfg, CPU)
    flush, sample = ((96, 9), (1, 96)), ((128, 5), (1, 128))
    assert collections.Counter(calls) == {flush: cfg.epochs,
                                          sample: cfg.epochs}


# ---------------------------------------------------------------------------
# serving-layer bounded-state checks
# ---------------------------------------------------------------------------


class TestServingBoundedState:
    def test_engine_metrics_rings_are_bounded(self):
        from repro_torch.serving.engine import (LATENCY_RING, STEP_TIME_RING,
                                                EngineMetrics)
        m = EngineMetrics()
        for i in range(LATENCY_RING * 2):
            m.latencies.append(float(i))
            m.step_times.append(float(i))
        assert len(m.latencies) == LATENCY_RING
        assert len(m.step_times) == STEP_TIME_RING
        assert m.latencies[0] == float(LATENCY_RING)
        assert np.isfinite(m.p95_latency())

    def test_serving_executor_window_is_bounded(self):
        from repro_torch.serving.autoscale import (ClusterModelParams,
                                                   ReplicaProfile,
                                                   ServingCluster,
                                                   ServingExecutor)
        cluster = ServingCluster(ReplicaProfile(0.02, 0.05, 8),
                                 ClusterModelParams(), seed=0)
        ex = ServingExecutor(cluster)
        for _ in range(300):
            ex.step(50.0)
        assert isinstance(ex._window, collections.deque)
        assert len(ex._window) == 120
        assert set(ex.observe()) == {"rate", "latency", "usage"}

    def test_cluster_step_uses_one_config_snapshot(self):
        from repro_torch.serving.autoscale import (ClusterModelParams,
                                                   ReplicaProfile,
                                                   ServingCluster)
        seen = []

        class Spy(ServingCluster):
            def capacity_rps(self, cfg=None):
                seen.append(cfg)
                return super().capacity_rps(cfg)

        cluster = Spy(ReplicaProfile(0.02, 0.05, 8), ClusterModelParams(),
                      seed=0)
        cluster.step(50.0, 5.0)
        assert len(seen) == 1
        assert seen[0] is not None
        assert seen[0] == cluster.config and seen[0] is not cluster.config
