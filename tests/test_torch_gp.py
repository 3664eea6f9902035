"""The port's GP/MOBO slice against the reference's.

The same seeded NumPy inputs go through the reference and the port (both
on the CPU here):

* the float32 GP objective and its gradient at the same theta, padded and
  unpadded, and the non-finite objective of a kernel matrix that is not
  positive definite (with the fit's fallback theta);
* ``GPBank.fit`` against the port's scalar ``GP.fit`` and the reference's
  ``GPBank.fit`` at the reference's own bars (``tests/test_gp_bank.py``:
  posterior within 5% of scale, members round-trip);
* ``batched_posterior`` and RGPE weights/posteriors from GPs carried across
  by ``repro_torch.interop``.

The acquisition half (EHVI, Pareto masks, profiling-batch selection) is in
``tests/test_torch_acquisition.py``.
"""
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

from repro.core import gp as ref_gp  # noqa: E402
from repro.core import gp_bank as ref_gp_bank  # noqa: E402
from repro.core import rgpe as ref_rgpe  # noqa: E402
from repro_torch.core import rgpe  # noqa: E402
from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS  # noqa: E402
from repro_torch.core.gp import (GP, fallback_theta,  # noqa: E402
                                 neg_mll_and_grad, restart_inits)
from repro_torch.core.gp_bank import (GPBank, _fit_packed,  # noqa: E402
                                      batched_posterior)
from repro_torch.interop import gp_from_arrays  # noqa: E402

CPU = "cpu"
#: the reference's objectives, jitted once (eager JAX is slow on the CPU)
_REF_PLAIN = jax.jit(ref_gp._neg_mll_grad)
_REF_MASKED = jax.jit(jax.value_and_grad(ref_gp_bank._masked_neg_mll))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_segments(rng, n_segments=6, dim=5):
    """Synthetic per-segment datasets shaped like controller training data
    (the reference's ``tests/test_gp_bank.py`` generator)."""
    datasets, seeds = [], []
    for i in range(n_segments):
        n = int(rng.integers(5, 20))
        x = rng.uniform(0, 1, (n, dim))
        level = 1.0 + 0.3 * i
        y = (level * (1.2 - x[:, 0]) + 0.4 * x[:, 1] ** 2
             + rng.normal(0, 0.05, n))
        datasets.append((x, y))
        seeds.append(i * 131)
    return datasets, seeds


def _carry(g) -> GP:
    """A reference GP as the port's, through interop."""
    return gp_from_arrays(g.x, g.y_mean, g.y_std, np.asarray(g.theta),
                          np.asarray(g.chol), np.asarray(g.alpha))


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(7)
    datasets, seeds = _random_segments(rng, n_segments=4)
    scalars = [GP.fit(x, y, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seed=s) for (x, y), s in zip(datasets, seeds)]
    bank = GPBank.fit(datasets, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seeds=seeds, device=CPU)
    ref_bank = ref_gp_bank.GPBank.fit(datasets, restarts=FIT_RESTARTS,
                                      max_iter=FIT_MAX_ITER, seeds=seeds)
    return datasets, scalars, bank, ref_bank


@pytest.mark.parametrize("padded", [False, True])
def test_objective_and_gradient_match_reference(padded):
    rng = np.random.default_rng(1)
    n, d = 11, 5
    x = rng.uniform(0, 1, (n, d))
    y = rng.normal(0, 1, n)
    mask = np.ones(n)
    if padded:
        x = np.concatenate([x, np.zeros((5, d))])
        y = np.concatenate([y, np.zeros(5)])
        mask = np.concatenate([mask, np.zeros(5)])
    for t0 in restart_inits(d, 3, seed=4):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)[None]  # noqa
        v, g = neg_mll_and_grad(f32(t0), f32(x), f32(y), f32(mask))
        args = [jnp.asarray(a, jnp.float32) for a in (t0, x, y, mask)]
        if padded:
            rv, rg = _REF_MASKED(*args)
        else:
            rv, rg = _REF_PLAIN(*args[:3])
        assert v.dtype == g.dtype == torch.float32
        np.testing.assert_allclose(float(v[0]), float(rv), rtol=1e-5)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(rg), rtol=1e-3,
                                   atol=1e-4)


def test_non_positive_definite_kernel_is_non_finite_and_falls_back():
    x = np.repeat(np.random.default_rng(0).uniform(0, 1, (3, 2)), 3, axis=0)
    y = np.linspace(-1.0, 1.0, 9)
    theta = np.array([1.0, 1.0, 30.0, -30.0])        # huge signal, no noise
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    v, g = neg_mll_and_grad(f32(theta)[None], f32(x)[None], f32(y)[None],
                            torch.ones(1, 9))
    assert torch.isnan(v).all() and torch.isnan(g).all()
    rv = ref_gp._neg_mll(jnp.asarray(theta, jnp.float32),
                         jnp.asarray(x, jnp.float32),
                         jnp.asarray(y, jnp.float32))
    assert not np.isfinite(float(rv))           # the reference agrees
    # every restart starts there: no step is accepted, the fit falls back
    theta_fit, val, chol, _ = _fit_packed(
        f32(x)[None], f32(y)[None], torch.ones(1, 9),
        f32(np.stack([theta, theta]))[None], max_iter=5)
    assert not np.isfinite(float(val[0]))
    np.testing.assert_allclose(theta_fit[0].numpy(), fallback_theta(2),
                               rtol=1e-6)
    assert torch.isfinite(chol).all()


def test_bank_posterior_agrees_with_scalar_oracle_and_reference(fitted):
    datasets, scalars, bank, ref_bank = fitted
    xq = np.random.default_rng(0).uniform(0, 1, (128, 5))
    mu_b, var_b = bank.posterior(xq)
    mu_r, var_r = ref_bank.posterior(xq)
    for i, ((_, y), gp) in enumerate(zip(datasets, scalars)):
        mu, var = gp.posterior(xq)
        scale = np.std(y) or 1.0
        for m2, v2 in ((mu_b[i], var_b[i]), (mu_r[i], var_r[i])):
            assert np.max(np.abs(mu - m2)) / scale < 0.05
            assert np.max(np.abs(var - v2)) / scale ** 2 < 0.05
        assert np.max(np.abs(mu_b[i] - mu_r[i])) / scale < 0.05
        assert np.max(np.abs(var_b[i] - var_r[i])) / scale ** 2 < 0.05
    assert bank.theta.dtype == np.float32 and bank.chol.dtype == np.float32


def test_members_roundtrip_as_scalar_gps(fitted):
    _, _, bank, _ = fitted
    xq = np.random.default_rng(1).uniform(0, 1, (16, 5))
    mu_b, var_b = bank.posterior(xq)
    for i in range(bank.n_members):
        g = bank.member(i)
        mu, var = g.posterior(xq)
        np.testing.assert_allclose(mu, mu_b[i], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(var, var_b[i], rtol=1e-3, atol=1e-5)
        assert np.isfinite(g.loo_samples(8, np.random.default_rng(0))).all()


def test_batched_posterior_of_carried_gps_matches_reference(fitted):
    _, _, _, ref_bank = fitted
    ref_gps = ref_bank.members()
    gps = [_carry(g) for g in ref_gps]
    xq = np.random.default_rng(2).uniform(0, 1, (64, 5))
    mu_b, var_b = batched_posterior(gps, xq, device=CPU)
    mu_r, var_r = ref_gp_bank.batched_posterior(ref_gps, xq)
    np.testing.assert_allclose(mu_b, mu_r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var_b, var_r, rtol=1e-3, atol=1e-5)
    for i, (g, rg) in enumerate(zip(gps[:2], ref_gps[:2])):
        mu, var = g.posterior(xq)
        rmu, rvar = rg.posterior(xq)
        assert mu.dtype == np.asarray(rmu).dtype
        np.testing.assert_allclose(mu, rmu, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(var, rvar, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(mu, mu_b[i], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.train_targets, rg.train_targets,
                                   rtol=1e-4, atol=1e-4)


def test_rgpe_weights_and_posterior_from_carried_gps(fitted):
    datasets, _, _, ref_bank = fitted
    ref_gps = ref_bank.members()
    gps = [_carry(g) for g in ref_gps]
    tx, ty = datasets[0]
    ens = rgpe.build_rgpe(gps[0], tx, ty, gps[1:], seed=11, device=CPU)
    ref_ens = ref_rgpe.build_rgpe(ref_gps[0], tx, ty, ref_gps[1:], seed=11)
    np.testing.assert_allclose(ens.weights, ref_ens.weights, atol=1e-12)
    assert ens.n_members >= 2
    xq = np.random.default_rng(3).uniform(0, 1, (96, 5))
    mu, var = ens.posterior(xq)
    rmu, rvar = ref_ens.posterior(xq)
    np.testing.assert_allclose(mu, rmu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var, rvar, rtol=1e-3, atol=1e-5)
    # the cold-start corners
    assert rgpe.build_rgpe(None, tx, ty, [], device=CPU) is None
    solo = rgpe.build_rgpe(gps[0], tx, ty, [], device=CPU)
    np.testing.assert_array_equal(solo.weights, [1.0])
