"""The port's §2.3 detector bank against the reference's.

The same seeded NumPy streams go through the port's ``DetectorBank`` (CPU),
the reference's ``DetectorBank`` and the scalar ``MetricDetector``:

* through outages to zero, NaN gaps and streams inactive half the time:
  equal flags on every sample. The state is held at 1e-12 of each stream's
  scale one sample at a time: the reference's state is carried across by
  ``repro_torch.interop.detector_bank_from_arrays`` every 25 samples and
  both banks take the next sample from it. Over a whole run the two
  states part by more than that (the RLS covariance of a stream that
  coasts through an outage amplifies reduction-order rounding: up to 6%
  of P's scale after 400 samples), while the flags stay equal;
* ``RecoveryTracker(detector_backend="bank")`` episodes equal to the
  scalar backend's and to the reference's bank tracker;
* ``reset_rows`` restores the just-constructed state; a reference bank's
  mid-run state carried across gives the same next 50 flags;
* bad shapes and backends raise, and a CPU bank's ARIMA step goes through
  the plain ``arima_chunk_ref`` once per sample;
* a profiling clone with the bank detector equals the scalar one and the
  reference's bank clone.
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

from repro.core.anomaly import RecoveryTracker as RefTracker  # noqa: E402
from repro.core.forecast_bank import DetectorBank as RefBank  # noqa: E402
from repro.dsp.executor import profile_one as ref_profile_one  # noqa: E402
from repro.dsp.simulator import ClusterModel as RefModel  # noqa: E402
from repro.dsp.simulator import JobConfig as RefJob  # noqa: E402
from repro_torch.core import (DetectorBank, MetricDetector,  # noqa: E402
                              RecoveryTracker)
from repro_torch.core import forecast_bank  # noqa: E402
from repro_torch.dsp import ClusterModel, JobConfig, profile_one  # noqa: E402
from repro_torch.interop import detector_bank_from_arrays  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rls_update as cuda_rls  # noqa: E402

#: the one-sample state bar, relative to each stream's largest magnitude
STATE_BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def detector_streams(n: int, T: int, seed: int, kind: str):
    """(values (T, n), active (T, n)): throughput-like streams in events/s
    (1e3-8e4, a periodic swing, 1% noise) with ``kind``'s trouble:
    ``"outage"`` drops every other stream to zero three times, ``"gaps"``
    puts 5% NaN into every other stream, ``"inactive"`` switches every
    other stream off for 20 samples in 40."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    base = rng.uniform(1e3, 8e4, n)[None, :]
    period = rng.uniform(30.0, 200.0, n)[None, :]
    v = base * (1 + 0.1 * np.sin(2 * np.pi * t / period)) \
        * (1 + 0.01 * rng.normal(0, 1, (T, n)))
    act = np.ones((T, n), bool)
    if kind == "outage":
        for j in range(0, n, 2):
            for s in rng.integers(40, T - 50, 3):
                v[s:s + rng.integers(5, 30), j] = 0.0
    elif kind == "gaps":
        gaps = rng.random((T, n)) < 0.05
        gaps[:, 1::2] = False
        v[gaps] = np.nan
    elif kind == "inactive":
        act[(t[:, 0] // 20) % 2 == 1, ::2] = False
    return v, act


def rel_by_stream(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference relative to each stream's largest magnitude."""
    g = np.asarray(got, float).reshape(len(want), -1)
    w = np.asarray(want, float).reshape(len(want), -1)
    scale = np.maximum(np.abs(w).max(axis=1), 1e-300)
    return float((np.abs(g - w).max(axis=1) / scale).max())


def ref_arrays(ref: RefBank) -> dict:
    out = {k: np.asarray(v) for k, v in ref._state._asdict().items()}
    out["ring"], out["rn"] = np.asarray(ref._ring), np.asarray(ref._rn)
    return out


def state_rel(bank: DetectorBank, ref: RefBank) -> dict:
    mine = {k: v.numpy() for k, v in bank._state._asdict().items()}
    mine["ring"], mine["rn"] = bank._ring.numpy(), bank._rn.numpy()
    return {k: rel_by_stream(mine[k], v) for k, v in ref_arrays(ref).items()}


@pytest.mark.parametrize("kind", ["outage", "gaps", "inactive"])
def test_bank_flags_and_state_match_reference_and_scalar(kind):
    n, T = 12, 300
    vals, act = detector_streams(n, T, seed=len(kind), kind=kind)
    bank, ref = DetectorBank(n, device="cpu"), RefBank(n)
    probe = DetectorBank(n, device="cpu")
    scalars = [MetricDetector(f"m{j}") for j in range(n)]
    n_flags, worst = 0, {}
    for i in range(T):
        shared = i % 25 == 24                # one sample from a shared state
        if shared:
            detector_bank_from_arrays(probe, ref_arrays(ref))
        flags = bank.observe(vals[i], act[i])
        want = ref.observe(vals[i], act[i])
        np.testing.assert_array_equal(flags, want)
        if shared:
            np.testing.assert_array_equal(probe.observe(vals[i], act[i]),
                                          want)
            for k, r in state_rel(probe, ref).items():
                worst[k] = max(worst.get(k, 0.0), r)
        for j in range(n):
            scalar = scalars[j].observe(vals[i, j]) if act[i, j] else False
            assert bool(flags[j]) == scalar, (i, j)
        n_flags += int(flags.sum())
    assert n_flags > 0 or kind != "outage"
    assert max(worst.values()) <= STATE_BAR, worst
    assert bank.n_samples == T and bank.wall_s > 0.0
    if kind == "inactive":
        counts = bank._state.count.numpy()
        assert (counts[:n:2] == act[:, ::2].sum(0)).all()
        assert (counts[1:n:2] == T).all()


def test_recovery_tracker_bank_episodes_equal_scalar_and_reference():
    rng = np.random.default_rng(7)
    thr = np.concatenate([5e4 + rng.normal(0, 200, 60), np.zeros(20),
                          5e4 + rng.normal(0, 200, 40)])
    lag = np.concatenate([1e3 + rng.normal(0, 50, 60),
                          5e4 * np.arange(1, 21),
                          1e3 + rng.normal(0, 50, 40)])
    trackers = [RecoveryTracker(device="cpu"),
                RecoveryTracker(detector_backend="bank", device="cpu"),
                RefTracker(detector_backend="bank")]
    for i, (a, b) in enumerate(zip(thr, lag)):
        m = {"throughput": a, "consumer_lag": b}
        seen = {tr.observe(5.0 * (i + 1), m) for tr in trackers}
        assert len(seen) == 1, i
    assert trackers[0].episodes == trackers[1].episodes \
        == trackers[2].episodes
    assert trackers[0].last_recovery_s == trackers[1].last_recovery_s
    assert trackers[1].last_recovery_s is not None
    assert trackers[1].detectors == {}       # the bank has no scalar members
    assert trackers[1]._impl.bank.n_samples == len(thr)


def test_reset_rows_restores_the_constructed_state():
    n, T = 5, 120
    vals, act = detector_streams(n, T, seed=3, kind="outage")
    bank, fresh = DetectorBank(n, device="cpu"), DetectorBank(n, device="cpu")
    ref = RefBank(n)
    for i in range(T):
        bank.observe(vals[i], act[i])
        ref.observe(vals[i], act[i])
    bank.reset_rows([3, 1])
    ref.reset_rows([3, 1])
    bank.reset_rows([])
    for name, got, init in zip(bank._state._fields, bank._state,
                               fresh._state):
        assert torch.equal(got[[1, 3]], init[[1, 3]]), name
        assert not torch.equal(got[0], init[0]) or name == "err_n"
    assert torch.equal(bank._ring[[1, 3]], fresh._ring[[1, 3]])
    assert torch.equal(bank._rn[[1, 3]], fresh._rn[[1, 3]])
    # after the reset, the reset rows behave like fresh detectors
    for i in range(T):
        flags = bank.observe(vals[i], act[i])
        np.testing.assert_array_equal(flags, ref.observe(vals[i], act[i]))
        assert (flags[[1, 3]] == fresh.observe(vals[i], act[i])[[1, 3]]).all()


def test_state_carried_across_gives_the_same_next_flags():
    n, T = 9, 200
    vals, act = detector_streams(n, T, seed=11, kind="outage")
    ref = RefBank(n)
    for i in range(150):
        ref.observe(vals[i], act[i])
    bank = DetectorBank(n, device="cpu")
    detector_bank_from_arrays(bank, ref_arrays(ref))
    assert max(state_rel(bank, ref).values()) == 0.0
    n_flags = 0
    for i in range(150, T):
        flags = bank.observe(vals[i], act[i])
        np.testing.assert_array_equal(flags, ref.observe(vals[i], act[i]))
        n_flags += int(flags.sum())
    assert n_flags > 0
    with pytest.raises(ValueError, match="expected arrays"):
        detector_bank_from_arrays(bank, {"ring": ref_arrays(ref)["ring"]})
    wrong = ref_arrays(RefBank(17))           # 32 rows, not 16
    with pytest.raises(ValueError, match="expected"):
        detector_bank_from_arrays(bank, wrong)


def test_bad_shapes_devices_and_backends_raise():
    with pytest.raises(ValueError, match="expected 2 values"):
        DetectorBank(2, device="cpu").observe(np.zeros(3))
    with pytest.raises(ValueError, match="at least one stream"):
        DetectorBank(0, device="cpu")
    with pytest.raises(ValueError, match="unknown detector backend"):
        RecoveryTracker(detector_backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        DetectorBank(2, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectorBank(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RecoveryTracker(detector_backend="bank")
    bank = DetectorBank(3, device="cpu")
    assert (bank.b, bank._ring.shape, bank._state.w.shape) == \
        (4, (4, 512), (4, 5))


def test_cpu_bank_steps_through_the_plain_chunk(monkeypatch):
    calls = []
    plain = ops.arima_chunk_ref

    def counting(*args):
        calls.append(tuple(args[-1].shape))
        return plain(*args)

    def refuse(*args):
        raise AssertionError("a CPU bank reached the CUDA wrapper")
    monkeypatch.setattr(ops, "arima_chunk_ref", counting)
    monkeypatch.setattr(cuda_rls, "arima_chunk", refuse)
    vals, act = detector_streams(3, 30, seed=2, kind="gaps")
    bank = DetectorBank(3, device="cpu")
    for i in range(30):
        bank.observe(vals[i], act[i])
    assert calls == [(1, 4)] * 30           # one (T = 1, B = 4) chunk a sample


def test_mad_threshold_is_the_scalar_median_rule():
    rng = np.random.default_rng(0)
    ring = rng.exponential(3.0, (6, 16))
    rn = np.array([0, 3, 11, 12, 16, 40])
    thr = forecast_bank._mad_threshold(torch.from_numpy(ring),
                                       torch.from_numpy(rn), 5.0, 12)
    for j in range(6):
        c = min(rn[j], 16)
        if c < 12:
            assert thr[j] == np.inf
            continue
        e = ring[j, :c]
        mad = np.median(np.abs(e - np.median(e))) * 1.4826
        assert float(thr[j]) == np.median(e) + 5.0 * max(mad, 1e-9)


@pytest.mark.parametrize("workers,rate", [(24, 60_000.0), (4, 30_000.0)])
def test_profiling_clone_with_the_bank_detector(workers, rate):
    cfg = dict(workers=workers, cpu_cores=2, memory_mb=2048, task_slots=2,
               checkpoint_interval_s=30.0)
    seed = 5 * 1009 + int(rate)
    bank = profile_one(ClusterModel(), JobConfig(), JobConfig(**cfg), rate,
                       5.0, seed=seed, detector_backend="bank", device="cpu")
    scalar = profile_one(ClusterModel(), JobConfig(), JobConfig(**cfg), rate,
                         5.0, seed=seed, device="cpu")
    want = ref_profile_one(RefModel(), RefJob(), RefJob(**cfg), rate, 5.0,
                           seed=seed, detector_backend="bank")
    assert bank == scalar == want
