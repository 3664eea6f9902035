"""The port's forecasting slice against the reference's.

The same seeded NumPy inputs go through the reference and the port:

* the K1 plain version (``rls_rank1_update_ref``) against the reference's
  Pallas kernel in interpret mode, float64 at 1e-12 and float32 at 1e-5;
* the ARIMA chunk (``arima_chunk_ref`` and the residual ring around it)
  against the reference's ``_arima_chunk`` at 1e-12 of each array's scale,
  with NaN ticks, padding ticks and a diverging stream;
* each forecaster family of the port's ``ForecastBank`` (CPU) against the
  port's scalar zoo and against the reference's bank at rtol 1e-9, with
  NaN gaps, a queue-cap flush, ``reset_rows`` and state carried across by
  ``repro_torch.interop``;
* the scalar zoo, the §2.3 detectors and one profiling run (``SimJob``
  clone + ``RecoveryTracker``) equal to the reference's.
"""
import contextlib

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import anomaly as ref_anomaly  # noqa: E402
from repro.core import forecast as ref_forecast  # noqa: E402
from repro.core import forecast_bank as ref_bank  # noqa: E402
from repro.core.forecast_bank import ForecastBank as RefBank  # noqa: E402
from repro.dsp.executor import profile_one as ref_profile_one  # noqa: E402
from repro.dsp.simulator import ClusterModel as RefModel  # noqa: E402
from repro.dsp.simulator import JobConfig as RefJob  # noqa: E402
from repro.kernels.rls_update import rls_rank1_update  # noqa: E402
from repro_torch.core import anomaly, forecast  # noqa: E402
from repro_torch.core import forecast_bank as port_bank  # noqa: E402
from repro_torch.core.forecast_bank import (_QUEUE_CAP,  # noqa: E402
                                            ForecastBank, make_forecaster)
from repro_torch.dsp import ClusterModel, JobConfig, profile_one  # noqa: E402
from repro_torch.interop import forecast_family_from_arrays  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rls_update as cuda_rls  # noqa: E402
from repro_torch.kernels.ref import (arima_chunk_ref,  # noqa: E402
                                     rls_rank1_update_ref)

#: forecaster kinds with non-default parameters that exercise the padded
#: layouts (p below p_max, d = 2, seasonal rings below their bucket)
FAMILIES = {
    "arima": [dict(p=8, d=1), dict(p=3, d=2), dict(p=6, d=0)],
    "holt": [dict(alpha=0.5, beta=0.1), dict(alpha=0.3, beta=0.2, season=7)],
    "seasonal": [dict(season=12), dict(season=5)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(rng, n, gaps=True):
    """A noisy periodic workload in thousands of events/s, with a drift and
    (optionally) NaN gaps. The scale matters for the ARIMA family: on raw
    rates (~4e4) its float64 RLS is ill-conditioned enough that the
    reference's own bank misses rtol 1e-9 against its scalar oracle, so
    the rtol-1e-9 comparisons use the scale of the reference's tests."""
    t = np.arange(n)
    v = 40.0 + 8.0 * np.sin(2 * np.pi * t / 37.0) + 0.015 * t \
        + rng.normal(0, 0.5, n)
    if gaps:
        v[rng.random(n) < 0.05] = np.nan
    return v


def _streams(kinds_params, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([_stream(rng, n) for _ in kinds_params], axis=1)


def _flat(kind):
    return [(kind, kw) for kw in FAMILIES[kind]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rls_plain_version_matches_reference_kernel(dtype):
    rng = np.random.default_rng(0)
    B, k = 13, 9                       # the reference's own case
    a = rng.normal(0, 1, (B, k, k))
    P = (a @ a.transpose(0, 2, 1) + np.eye(k)).astype(dtype)
    phi = rng.normal(0, 1, (B, k)).astype(dtype)
    lam = np.full(B, 0.995, dtype)
    ctx = jax.experimental.enable_x64() if dtype == np.float64 \
        else contextlib.nullcontext()
    with ctx:
        g_ref, p_ref = rls_rank1_update(jnp.asarray(P), jnp.asarray(phi),
                                        jnp.asarray(lam), interpret=True)
        g_ref, p_ref = np.asarray(g_ref), np.asarray(p_ref)
    g, p = rls_rank1_update_ref(torch.from_numpy(P), torch.from_numpy(phi),
                                torch.from_numpy(lam))
    assert g.dtype == p.dtype == torch.from_numpy(P).dtype
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_bank_matches_scalar_zoo_and_reference_bank(kind):
    rows = _flat(kind)
    vals = _streams(rows, 300, seed=len(kind))
    bank = ForecastBank([k for k, _ in rows], params=[kw for _, kw in rows],
                        horizon=10, device="cpu")
    ref = RefBank([k for k, _ in rows], params=[kw for _, kw in rows],
                  horizon=10)
    scalars = [forecast.make_scalar_forecaster(k, **kw) for k, kw in rows]
    views, ref_views = bank.views(), ref.views()
    for t in range(vals.shape[0]):
        for r in range(len(rows)):
            for f in (views[r], ref_views[r], scalars[r]):
                f.update(vals[t, r])
        if t % 23 == 22 or t == vals.shape[0] - 1:       # a read epoch
            for r in range(len(rows)):
                got = views[r].forecast(10)
                np.testing.assert_allclose(got, scalars[r].forecast(10),
                                           rtol=1e-9, atol=1e-9)
                np.testing.assert_allclose(got, ref_views[r].forecast(10),
                                           rtol=1e-9, atol=1e-9)
                for h, b in ((10, 5), (7, 3)):
                    want = forecast.binned_forecast(scalars[r], h, b)
                    assert forecast.binned_forecast(views[r], h, b) == \
                        pytest.approx(want, rel=1e-9)
    for r in range(len(rows)):
        assert views[r].n_observed == scalars[r].n_observed
        assert views[r].last() == scalars[r].last()
        np.testing.assert_allclose(views[r].residual_std(),
                                   scalars[r].residual_std(), rtol=1e-9)
    assert bank.n_updates == ref.n_updates > 0


def test_queue_cap_flush_and_chunk_ticks():
    rows = _flat("arima")
    n = _QUEUE_CAP + 40                # one forced flush, then one read
    vals = _streams(rows, n, seed=3)
    bank = ForecastBank([k for k, _ in rows], params=[kw for _, kw in rows],
                        device="cpu")
    scalars = [forecast.make_scalar_forecaster(k, **kw) for k, kw in rows]
    views = bank.views()
    for t in range(n):
        for r, (v, s) in enumerate(zip(views, scalars)):
            v.update(vals[t, r])
            s.update(vals[t, r])
    assert bank.n_updates == _QUEUE_CAP * len(rows)      # the forced flush
    assert bank.arima_ticks == _QUEUE_CAP
    assert bank.arima_chunks == 1
    for v, s in zip(views, scalars):
        np.testing.assert_allclose(v.forecast(10), s.forecast(10),
                                   rtol=1e-9, atol=1e-9)
    assert bank.n_updates == n * len(rows)
    assert bank.arima_ticks == _QUEUE_CAP + 40           # 40 = 10 x 4
    assert bank.arima_chunks == 2                        # one call each


def _arima_case(k, d, seed, B=11):
    """Seeded ARIMA family state at its prior and two chunks of ticks.

    Orders p from 1 to k - 1, all at depth d; NaN gaps, and the first
    chunk ends in two all-NaN padding ticks. The last stream spikes to
    1e308 on its next-to-last tick: on the last one its regressor
    overflows the step, and the divergence guard resets it to its prior."""
    rng = np.random.default_rng(seed)
    p_max, d_max = k - 1, max(d, 1)
    p = rng.integers(1, p_max + 1, B)
    p[0] = p_max
    lam = rng.uniform(0.97, 1.0, B)
    ridge = rng.uniform(1.0, 20.0, B)
    state = dict(w=np.zeros((B, k)), P=ridge[:, None, None] * np.eye(k),
                 lags=np.zeros((B, p_max)), tails=np.zeros((B, d_max)),
                 count=np.zeros(B, np.int64), last=np.zeros(B),
                 err=np.zeros((B, forecast.ERR_WINDOW)),
                 err_n=np.zeros(B, np.int64))
    params = dict(p=p.astype(np.int64), d=np.full(B, d, np.int64), lam=lam,
                  ridge=ridge)
    vals = np.stack([_stream(rng, 20) for _ in range(B)], axis=1)
    vals[-2:, -1] = (1e308, 40.0)
    chunks = [vals[:12].copy(), vals[12:].copy()]
    chunks[0][-2:] = np.nan
    return state, params, chunks


@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("k", [5, 9, 17])
def test_arima_chunk_matches_reference_chunk(k, d):
    """Two chunks through the port's ``_arima_chunk`` (``ops.arima_chunk``,
    on the CPU its plain version, then the residual ring) and the
    reference's (``use_pallas=False``): the counts equal, the diverging
    stream reset, and every other state array within 1e-12 of its scale
    (each stream's largest finite magnitude in it). At d = 0 the bar is
    5e-11: an AR on the levels (about 40 here) has lags and a bias that
    are nearly collinear, so a sum taken in another order moves w by up to
    1.0e-11 of its scale after 20 ticks; the reference's own compiled and
    eager runs (which sum in different orders too) differ by up to 7.4e-12
    of it there, and by 7e-15 at d >= 1."""
    state, params, chunks = _arima_case(k, d, seed=100 * k + d)
    with jax.experimental.enable_x64():
        jstate = ref_bank._ArimaState(**{n: jnp.asarray(v)
                                         for n, v in state.items()})
        jparams = ref_bank._ArimaParams(**{n: jnp.asarray(v)
                                           for n, v in params.items()})
        want = []
        for vals in chunks:
            jstate = ref_bank._arima_chunk(jstate, jparams, jnp.asarray(vals),
                                           use_pallas=False)
            want.append([np.asarray(x) for x in jstate])
    tstate = port_bank._ArimaState(**{n: torch.from_numpy(v.copy())
                                      for n, v in state.items()})
    tparams = port_bank._ArimaParams(**{n: torch.from_numpy(v.copy())
                                        for n, v in params.items()})
    const = port_bank._arima_const(tparams, k, state["tails"].shape[1])
    rel = 5e-11 if d == 0 else 1e-12
    for vals, ref_arrays in zip(chunks, want):
        tstate = port_bank._arima_chunk(tstate, tparams, const,
                                        torch.from_numpy(vals))
        for name, g, r in zip(tstate._fields, tstate, ref_arrays):
            g = g.numpy()
            if g.dtype == np.int64:
                np.testing.assert_array_equal(g, r, err_msg=name)
                continue
            for b, (gb, rb) in enumerate(zip(g, r)):
                scale = np.max(np.abs(rb[np.isfinite(rb)]), initial=0.0)
                np.testing.assert_allclose(gb, rb, rtol=0.0,
                                           atol=rel * scale,
                                           err_msg=f"{name}, stream {b}")
    # the diverging stream fired and was reset to its prior
    assert tstate.err_n[-1] > 0
    np.testing.assert_array_equal(tstate.w[-1].numpy(), 0.0)
    np.testing.assert_array_equal(
        tstate.P[-1].numpy(), params["ridge"][-1] * np.eye(k))


def _chunk_tensors(k, d, device="cpu"):
    state, params, chunks = _arima_case(k, d, seed=7)
    t = {n: torch.from_numpy(v.copy()).to(device)
         for n, v in {**state, **params}.items() if n not in ("err", "err_n")}
    cap = t["ridge"] * (t["p"] + 1).to(torch.float64) * forecast.P_TRACE_CAP
    args = [t[n] for n in ("w", "P", "lags", "tails", "count", "last", "p",
                           "d", "lam", "ridge")]
    return args + [cap, torch.from_numpy(chunks[0]).to(device)]


def test_ops_routes_cpu_chunks_to_the_plain_version():
    got_args, want_args = _chunk_tensors(9, 1), _chunk_tensors(9, 1)
    got = ops.arima_chunk(*got_args)
    want = arima_chunk_ref(*want_args)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    for g, r in zip(got_args[:6], want_args[:6]):     # state, in place
        assert torch.equal(g, r)
    assert got[1].dtype == torch.bool and got[0].shape == (12, 11)


def test_chunk_dispatch_refuses_other_devices_and_cpu_in_the_wrapper():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.arima_chunk(*_chunk_tensors(5, 2, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_rls.arima_chunk(*_chunk_tensors(5, 2))


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_reset_rows_matches_reference(kind):
    rows = _flat(kind)
    vals = _streams(rows, 120, seed=11)
    bank = ForecastBank([k for k, _ in rows], params=[kw for _, kw in rows],
                        device="cpu")
    ref = RefBank([k for k, _ in rows], params=[kw for _, kw in rows])
    for b in (bank, ref):
        for t in range(80):
            for r in range(len(rows)):
                b.stage(r, vals[t, r])
        b.flush()
        b.stage(0, vals[80, 0])          # a staged tick the reset drops
        assert b.reset_rows([0]) == 1
        for t in range(80, 120):
            for r in range(len(rows)):
                b.stage(r, vals[t, r])
    fresh = forecast.make_scalar_forecaster(kind, **rows[0][1])
    for t in range(80, 120):
        fresh.update(vals[t, 0])
    np.testing.assert_allclose(bank.forecast_row(0, 10), fresh.forecast(10),
                               rtol=1e-9, atol=1e-9)
    for r in range(len(rows)):
        np.testing.assert_allclose(bank.forecast_row(r, 10),
                                   ref.forecast_row(r, 10),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_state_carried_across_continues_alike(kind):
    rows = _flat(kind)
    vals = _streams(rows, 160, seed=5)
    ref = RefBank([k for k, _ in rows], params=[kw for _, kw in rows])
    for t in range(100):
        for r in range(len(rows)):
            ref.stage(r, vals[t, r])
    ref.flush()
    fam = ref._fams[kind]
    state = {k: np.asarray(v) for k, v in fam.state._asdict().items()}
    params = {k: np.asarray(v) for k, v in fam.params._asdict().items()}
    bank = ForecastBank([k for k, _ in rows], params=[kw for _, kw in rows],
                        device="cpu")
    forecast_family_from_arrays(bank, kind, state, params)
    for r in range(len(rows)):
        np.testing.assert_allclose(bank.forecast_row(r, 10),
                                   ref.forecast_row(r, 10),
                                   rtol=1e-9, atol=1e-9)
    for t in range(100, 160):
        for r in range(len(rows)):
            bank.stage(r, vals[t, r])
            ref.stage(r, vals[t, r])
    for r in range(len(rows)):
        np.testing.assert_allclose(bank.forecast_row(r, 12),
                                   ref.forecast_row(r, 12),
                                   rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="expects arrays"):
        forecast_family_from_arrays(bank, kind, {"w": state.get("w")}, params)


def test_make_forecaster_backends_and_defaults():
    bank_view = make_forecaster("holt", backend="bank", device="cpu")
    scalar = make_forecaster("holt", backend="scalar")
    assert isinstance(scalar, forecast.HoltWinters)
    for v in np.linspace(1.0, 20.0, 30):
        bank_view.update(v)
        scalar.update(v)
    np.testing.assert_allclose(bank_view.forecast(5), scalar.forecast(5),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="unknown forecast backend"):
        make_forecaster("holt", backend="torch", device="cpu")
    with pytest.raises(ValueError, match="unknown forecaster kind"):
        ForecastBank(["prophet"], device="cpu")


@pytest.mark.parametrize("kind", ["arima", "holt", "seasonal"])
def test_scalar_zoo_equals_reference(kind):
    vals = _streams([0], 200, seed=9)[:, 0]
    mine = forecast.make_scalar_forecaster(kind)
    theirs = ref_forecast.make_scalar_forecaster(kind)
    for v in vals:
        mine.update(v)
        theirs.update(v)
    np.testing.assert_array_equal(mine.forecast(10), theirs.forecast(10))
    assert mine.residual_std() == theirs.residual_std()


def test_detectors_equal_reference():
    rng = np.random.default_rng(2)
    thr = 3e4 + rng.normal(0, 300.0, 240)
    lag = np.abs(rng.normal(0, 50.0, 240))
    thr[100:130] = 0.0                     # an outage
    lag[100:160] = np.linspace(1e5, 0.0, 60)
    mine = anomaly.RecoveryTracker()
    theirs = ref_anomaly.RecoveryTracker()
    for i in range(240):
        m = {"throughput": thr[i], "consumer_lag": lag[i]}
        assert mine.observe(5.0 * i, m) == theirs.observe(5.0 * i, m)
    assert mine.episodes == theirs.episodes and mine.episodes
    assert mine.last_recovery_s == theirs.last_recovery_s
    with pytest.raises(ValueError, match="unknown detector backend"):
        anomaly.RecoveryTracker(detector_backend="gpu")


@pytest.mark.parametrize("workers,rate", [(24, 60_000.0), (4, 30_000.0),
                                          (12, 90_000.0)])
def test_profiling_run_equals_reference(workers, rate):
    cfg = dict(workers=workers, cpu_cores=2, memory_mb=2048, task_slots=2,
               checkpoint_interval_s=30.0)
    seed = 3 * 1009 + 1 + int(rate)
    cost, ref_cost = [], []
    got = profile_one(ClusterModel(), JobConfig(), JobConfig(**cfg), rate,
                      5.0, seed=seed, account=lambda m: cost.append(m))
    want = ref_profile_one(RefModel(), RefJob(), RefJob(**cfg), rate, 5.0,
                           seed=seed, account=lambda m: ref_cost.append(m))
    assert got == want
    assert cost == ref_cost
