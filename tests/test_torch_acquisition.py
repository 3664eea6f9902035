"""The port's acquisition slice against the reference's.

The same seeded NumPy inputs go through the reference and the port (both
on the CPU here), at the reference's own bars (``tests/test_gp_bank.py``):

* the batched float32 EHVI against the float64 NumPy oracle and the
  reference's batched EHVI at rtol 1e-3;
* the Pareto mask against the reference's, on points with ties (the
  port's sorts are stable, as the reference's are);
* the same profiling batch selected from the port's scalar fits (NumPy
  EHVI), the port's ``GPBank`` (torch EHVI) and the reference's ``GPBank``
  (its jitted EHVI).
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

from repro.core import acquisition as ref_acq  # noqa: E402
from repro.core import gp_bank as ref_gp_bank  # noqa: E402
from repro_torch.core import acquisition as acq  # noqa: E402
from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS  # noqa: E402
from repro_torch.core.gp import GP  # noqa: E402
from repro_torch.core.gp_bank import GPBank  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many tiny tensor operations, which run
    fastest on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ehvi_batch_matches_numpy_oracle_and_reference():
    rng = np.random.default_rng(4)
    B, n = 6, 32
    mu = rng.uniform(0, 5, (B, n, 2))
    var = rng.uniform(0.01, 1.0, (B, n, 2))
    fronts = [rng.uniform(0, 4, (int(rng.integers(0, 10)), 2))
              for _ in range(B)]
    fronts[1] = np.zeros((0, 2))                      # an empty front
    refs = np.full((B, 2), 5.0)
    out = acq.ehvi_2d_batch(mu, var, fronts, refs, device=CPU)
    ref_out = ref_acq.ehvi_2d_batch(mu, var, fronts, refs)
    for i in range(B):
        want = acq.ehvi_2d(mu[i], var[i], fronts[i], (5.0, 5.0))
        np.testing.assert_allclose(want, ref_acq.ehvi_2d(
            mu[i], var[i], fronts[i], (5.0, 5.0)))
        np.testing.assert_allclose(out[i], want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(out, ref_out, rtol=1e-3, atol=1e-5)


def test_pareto_mask_matches_reference_with_ties():
    rng = np.random.default_rng(5)
    for _ in range(25):
        k = int(rng.integers(1, 16))
        # values on a coarse grid: duplicate points and tied objectives
        pts = rng.integers(0, 4, (k, 2)).astype(float)
        valid = rng.random(k) < 0.8
        mask = acq.pareto_front_mask_2d(pts[None], valid[None], device=CPU)[0]
        ref_mask = np.asarray(ref_acq.pareto_front_mask_2d(pts[None],
                                                           valid[None]))[0]
        np.testing.assert_array_equal(mask, ref_mask)
        got = np.sort(pts[mask], axis=0)
        want = np.sort(acq.pareto_front_2d(pts[valid]), axis=0)
        np.testing.assert_allclose(got, want.reshape(got.shape))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_profiling_batch_selected(seed):
    rng = np.random.default_rng(seed)
    n = 15
    x = rng.uniform(0, 1, (n, 4))
    usage = 1.5 - x[:, 0] + 0.2 * x[:, 1] + rng.normal(0, 0.03, n)
    lat = 0.5 + x[:, 0] ** 2 + rng.normal(0, 0.03, n)

    def posterior(gu, gl):
        def post(xq):
            mu_u, var_u = gu.posterior(xq)
            mu_l, var_l = gl.posterior(xq)
            return np.stack([mu_u, mu_l], 1), np.stack([var_u, var_l], 1)
        return post

    su = GP.fit(x, usage, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                seed=3)
    sl = GP.fit(x, lat, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER, seed=4)
    data = [(x, usage), (x, lat)]
    bank = GPBank.fit(data, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                      seeds=[3, 4], device=CPU)
    ref_bank = ref_gp_bank.GPBank.fit(data, restarts=FIT_RESTARTS,
                                      max_iter=FIT_MAX_ITER, seeds=[3, 4])
    cand = rng.uniform(0, 1, (96, 4))
    front = np.stack([usage, lat], 1)
    ref = (float(usage.max()) * 1.2, float(lat.max()) * 1.2)
    picked_scalar = acq.select_profiling_batch(
        cand, posterior(su, sl), None, front, ref, q=3, backend="numpy")
    picked_bank = acq.select_profiling_batch(
        cand, posterior(bank.member(0), bank.member(1)), None, front, ref,
        q=3, backend="torch", device=CPU)
    picked_ref = ref_acq.select_profiling_batch(
        cand, posterior(ref_bank.member(0), ref_bank.member(1)), None,
        front, ref, q=3, backend="jax")
    assert picked_scalar == picked_bank == picked_ref
    with pytest.raises(ValueError, match="unknown EHVI backend"):
        acq.select_profiling_batch(cand, posterior(su, sl), None, front, ref,
                                   q=1, backend="jax")
