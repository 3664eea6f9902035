"""The port's GP/MOBO slice against the reference's.

The same seeded NumPy inputs go through the reference and the port (both
on the CPU here):

* the float32 GP objective and its gradient at the same theta, padded and
  unpadded, and the non-finite objective of a kernel matrix that is not
  positive definite (with the fit's fallback theta);
* ``lbfgs_batched`` against ``optax.lbfgs()`` run as the reference runs it
  (``repro.core.gp_bank._lbfgs_minimize``'s loop) on objectives with a
  known minimum: equal iteration counts and iterates, including a first
  step that overshoots so that the zoom line search must bracket;
* ``GPBank.fit`` against the port's scalar ``GP.fit`` at the reference's
  own bar (``tests/test_gp_bank.py``: posterior within 5% of scale; two
  optimizers, scipy's L-BFGS-B and optax's L-BFGS) and against the
  reference's ``GPBank.fit`` at ``BANK_VS_REFERENCE`` (the same algorithm;
  float32 rounding, amplified by the flat optimum, is what parts them), and
  members round-trip; on ``chip_smoke.py``'s 96 datasets the reference's
  bank misses the scalar bar exactly on ``chip_smoke.OTHER_OPTIMA``, the
  members its phase 5 excepts;
* ``batched_posterior`` and RGPE weights/posteriors from GPs carried across
  by ``repro_torch.interop``;
* at the fit kernel's tiled sizes (n_max 8, 16, 32, 64, masked rows in
  each): its arithmetic in plain torch (``kernels.ref.
  gp_objective_sweep_ref``, K^-1 by a symmetric sweep) against the
  reference's objective and gradient, and the port's ``_fit_packed``
  against the reference's.

The acquisition half (EHVI, Pareto masks, profiling-batch selection) is in
``tests/test_torch_acquisition.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import optax.tree_utils as otu  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import gp as ref_gp  # noqa: E402
from repro.core import gp_bank as ref_gp_bank  # noqa: E402
from repro.core import rgpe as ref_rgpe  # noqa: E402
from repro_torch.core import rgpe  # noqa: E402
from repro_torch.core.demeter import FIT_MAX_ITER, FIT_RESTARTS  # noqa: E402
from repro_torch.core.gp import (GP, fallback_theta,  # noqa: E402
                                 neg_mll_and_grad, restart_inits)
from repro_torch.core.gp_bank import (GRAD_TOL, GPBank,  # noqa: E402
                                      _fit_packed, batched_posterior,
                                      lbfgs_batched)
from repro_torch.interop import gp_from_arrays  # noqa: E402

CPU = "cpu"
#: the bank's posterior (mean, and variance over scale squared) against the
#: reference bank's, over the scale of the targets: ten times tighter than
#: the 5% the test held while the port ran another line search. Same
#: algorithm; on these datasets they part by at most 5.6e-4 (mean) and
#: 1.0e-4 (variance), on the 96 of ``chip_smoke.gp_datasets`` by 2.9e-3,
#: where the reference's own fits move by up to 4.9e-4 and 1.4e-4 when the
#: standardized targets move by 2e-7 (two float32 ulps) of noise.
BANK_VS_REFERENCE = 5e-3
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


def _optax_lbfgs(fun, t0, max_iter):
    """The reference's loop (``repro.core.gp_bank._lbfgs_minimize``) one
    iteration at a time: every iterate, and the final count."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(fun)

    @jax.jit
    def body(t, state):
        value, grad = value_and_grad(t, state=state)
        updates, state = opt.update(grad, state, t, value=value, grad=grad,
                                    value_fn=fun)
        return optax.apply_updates(t, updates), state

    t = jnp.asarray(t0, jnp.float32)
    state, iterates = opt.init(t), [np.asarray(t)]
    while True:
        count = int(otu.tree_get(state, "count"))
        norm = float(otu.tree_norm(otu.tree_get(state, "grad")))
        if not (count == 0 or (count < max_iter and norm > GRAD_TOL)):
            return np.stack(iterates), count
        t, state = body(t, state)
        iterates.append(np.asarray(t))


def _torch_objective(f):
    def fun(theta, rows):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            v = f(th)
            (g,) = torch.autograd.grad(v.sum(), th)
        return v.detach(), g
    return fun


#: (name, reference objective of one row, the port's of a batch, starts,
#: iterates held over all iterations or the first few): a diagonal
#: quadratic; a quadratic whose first step (unit length, as optax scales
#: it) overshoots the minimum, so that the zoom search brackets and
#: interpolates; a quartic valley; and Rosenbrock's function, whose float32
#: iterates part at the rounding level after a few iterations (its counts
#: and minimum still agree)
LBFGS_CASES = (
    ("quadratic", lambda x: jnp.sum(jnp.arange(1.0, 5.0) * x ** 2),
     lambda x: (torch.arange(1.0, 5.0) * x ** 2).sum(1),
     [[1.0, -2.0, 3.0, 0.5], [10.0, 0.0, 0.0, 1.0], [0.1, 0.1, 0.1, 0.1]],
     None),
    ("overshoot", lambda x: 5.0 * (x[0] ** 2 + 2.0 * x[1] ** 2),
     lambda x: 5.0 * (x[:, 0] ** 2 + 2.0 * x[:, 1] ** 2),
     [[0.3, 0.1], [-0.2, 0.25]], None),
    ("quartic", lambda x: jnp.sum(50.0 * x ** 2) + jnp.sum(x ** 4),
     lambda x: (50.0 * x ** 2).sum(1) + (x ** 4).sum(1),
     [[3.0, -1.0], [0.1, 0.2]], None),
    ("rosenbrock",
     lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2),
     lambda x: (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                + (1.0 - x[:, :-1]) ** 2).sum(1),
     [[-1.2, 1.0, 0.5], [2.0, 2.0, 2.0], [0.0, 0.0, 0.0]], 3),
)


@pytest.mark.parametrize("case", LBFGS_CASES, ids=[c[0] for c in LBFGS_CASES])
def test_lbfgs_batched_follows_optax_lbfgs(case):
    _, ref_f, port_f, starts, held = case
    t0 = np.asarray(starts, np.float32)
    fun = _torch_objective(port_f)
    theta, counts = lbfgs_batched(fun, torch.as_tensor(t0), max_iter=60)
    # the iterate after k iterations is the end of a run of max_iter=k
    iterates = np.stack([t0] + [
        lbfgs_batched(fun, torch.as_tensor(t0), max_iter=k)[0].numpy()
        for k in range(1, (held or int(counts.max())) + 1)])
    brackets = 0
    for i, start in enumerate(t0):
        want, count = _optax_lbfgs(ref_f, start, 60)
        assert int(counts[i]) == count
        got = iterates[:count + 1, i]
        n = len(want) if held is None else held + 1
        np.testing.assert_allclose(got[:n], want[:n], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(theta[i].numpy(), want[-1], atol=1e-3)
        # the minimum itself: zero, or Rosenbrock's ones
        np.testing.assert_allclose(
            want[-1], np.ones_like(start) if held else 0.0, atol=1e-3)
        # the first step's length is min(1, 1/|g|) |g| <= 1, and in the
        # overshoot case the search had to shorten it
        step = np.linalg.norm(want[1] - want[0])
        brackets += step < 1.0 - 1e-6 and float(ref_f(want[1])) \
            < float(ref_f(want[0]))
    if case[0] == "overshoot":
        assert brackets == len(t0)


def test_fit_kernel_takes_cuda_tensors_only():
    """On the CPU the bank fits with the plain version; the fit kernel's
    wrapper refuses CPU tensors (and bad shapes) before any build."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gp_fit import gp_lbfgs
    from repro_torch.kernels.ref import gp_lbfgs_ref
    x, y, t0 = torch.zeros(2, 8, 3), torch.zeros(2, 8), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        gp_lbfgs(x, y, torch.ones(2, 8), t0, restarts=2, max_iter=5)
    with pytest.raises(ValueError, match="t0 must be"):
        gp_lbfgs(x, y, torch.ones(2, 8), t0[:3], restarts=2, max_iter=5)
    # the dispatch sends CPU tensors to the plain version, and refuses
    # any device but the CPU and CUDA
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0, 1, (2, 8, 3)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(0, 1, (2, 8)), dtype=torch.float32)
    t0 = torch.as_tensor(np.concatenate([restart_inits(3, 2, s)
                                         for s in (0, 1)]),
                         dtype=torch.float32)
    got = ops.gp_lbfgs(x, y, torch.ones(2, 8), t0, restarts=2, max_iter=5)
    want = gp_lbfgs_ref(x, y, torch.ones(2, 8), t0, 2, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.gp_lbfgs(x.to("meta"), y, torch.ones(2, 8), t0, restarts=2,
                     max_iter=5)


#: the tiled body's padded sizes (``csrc/gp_fit.cu::gp_lbfgs_body``)
TILED_SIZES = (8, 16, 32, 64)


def _tiled_problem(n: int, members: int = 4, seed: int = 0):
    """Seeded controller-shaped problems padded to ``n`` points: the even
    members keep their first two thirds (masked rows past the last real
    one), member 1 loses one row a quarter in (a masked row inside the
    sweep); standardized targets, zero on the masked rows."""
    rng = np.random.default_rng(seed + n)
    d = 5
    x = rng.uniform(0, 1, (members, n, d))
    y = (1.2 - x[..., 0]) + 0.4 * x[..., 1] ** 2 \
        + rng.normal(0, 0.05, (members, n))
    mask = np.ones((members, n))
    mask[::2, (2 * n) // 3:] = 0.0
    mask[1, n // 4] = 0.0
    mean = (y * mask).sum(1, keepdims=True) / mask.sum(1, keepdims=True)
    std = np.sqrt(((y - mean) ** 2 * mask).sum(1, keepdims=True)
                  / mask.sum(1, keepdims=True))
    return x, (y - mean) / std * mask, mask


@pytest.mark.parametrize("n", TILED_SIZES)
def test_tiled_objective_matches_reference(n):
    """The fit kernel's tiled arithmetic in plain torch
    (``kernels.ref.gp_objective_sweep_ref``: K^-1 and the log-determinant
    by one symmetric sweep, the masked rows past the last real one already
    swept, the gradient's traces in closed form) against the reference's
    masked objective and its autograd gradient, at the reference test's
    bars; against a float64 evaluation it errs no more than the port's
    float32 Cholesky route does (within 2x, plus 1e-6 of scale). A row
    whose kernel matrix is not positive definite (a signal of e^89, past
    float32's range) is NaN in value and gradient, as in the reference."""
    from repro_torch.kernels.ref import gp_objective_sweep_ref
    x, y, mask = _tiled_problem(n)
    d = x.shape[2]
    t0 = np.concatenate([restart_inits(d, 2, s) for s in (1, 2)])
    t0[3, d] = 89.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    v, g = gp_objective_sweep_ref(f32(t0), f32(x), f32(y), f32(mask))
    v64, g64 = neg_mll_and_grad(*(torch.as_tensor(a, dtype=torch.float64)
                                  for a in (t0, x, y, mask)))
    vc, gc = neg_mll_and_grad(f32(t0), f32(x), f32(y), f32(mask))
    for i in range(len(t0)):
        rv, rg = _REF_MASKED(*(jnp.asarray(a[i], jnp.float32)
                               for a in (t0, x, y, mask)))
        if i == 3:
            assert not np.isfinite(float(rv))
            assert torch.isnan(v[i]) and torch.isnan(g[i]).all()
            continue
        np.testing.assert_allclose(float(v[i]), float(rv), rtol=1e-5)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(rg), rtol=1e-3,
                                   atol=1e-4)
        scale = float(g64[i].abs().max())
        for err, bar in (
                (abs(float(v[i]) - float(v64[i])),
                 abs(float(vc[i]) - float(v64[i]))),
                (float((g[i].double() - g64[i]).abs().max()),
                 float((gc[i].double() - g64[i]).abs().max()))):
            assert err <= 2.0 * bar + 1e-6 * max(scale, abs(float(v64[i])))


@pytest.mark.parametrize("n", TILED_SIZES)
def test_fit_packed_matches_reference_at_tiled_sizes(n):
    """The port's ``_fit_packed`` on the CPU (the plain version of the fit
    kernel) against the reference's at each padded size of the tiled body,
    from the same starts, masked members included: each member's best
    objective within 1e-3 relative and its theta within 1e-2 of theta's
    scale (every member's best restart is unique here; float32 rounding,
    amplified by the flat optimum, parts the iterates by up to 8e-3 at
    n = 64)."""
    x, y, mask = _tiled_problem(n, members=3)
    d, R = x.shape[2], FIT_RESTARTS
    t0s = np.stack([restart_inits(d, R, 7 * i) for i in range(len(x))])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    theta, val, _, _ = _fit_packed(f32(x), f32(y), f32(mask), f32(t0s),
                                   max_iter=20)
    r_theta, r_val, _, _ = ref_gp_bank._fit_packed(
        *(jnp.asarray(a, jnp.float32) for a in (x, y, mask, t0s)),
        max_iter=20)
    r_val, r_theta = np.asarray(r_val), np.asarray(r_theta)
    assert np.isfinite(r_val).all()
    rel = np.abs(val.numpy() - r_val) / np.maximum(np.abs(r_val), 1.0)
    assert rel.max() < 1e-3, rel
    err = np.abs(theta.numpy() - r_theta).max() / np.abs(r_theta).max()
    assert err < 1e-2, err


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
        assert np.max(np.abs(mu_b[i] - mu_r[i])) / scale < BANK_VS_REFERENCE
        assert np.max(np.abs(var_b[i] - var_r[i])) / scale ** 2 \
            < BANK_VS_REFERENCE
    assert bank.theta.dtype == np.float32 and bank.chol.dtype == np.float32


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports nothing until a phase
    runs)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_bank_misses_the_scalar_bar_only_on_other_optima():
    """``chip_smoke.py``'s phase 5 holds the bank on the card to the scalar
    fit at 5% of scale but on ``OTHER_OPTIMA``. On exactly those members of
    its 96 datasets the reference's own bank misses that bar, with a higher
    objective than the scalar fit's: optax's L-BFGS and scipy's L-BFGS-B
    stop at different optima of the same objective from the same
    starts."""
    smoke = _chip_smoke()
    datasets, seeds = smoke.gp_datasets(96, 12)
    ref_bank = ref_gp_bank.GPBank.fit(datasets, restarts=FIT_RESTARTS,
                                      max_iter=FIT_MAX_ITER, seeds=seeds)
    xq = np.random.default_rng(0).uniform(0, 1, (128, 5))
    mu_r, var_r = ref_bank.posterior(xq)
    missed = set()
    for i, ((x, y), seed) in enumerate(zip(datasets, seeds)):
        gp = GP.fit(x, y, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER,
                    seed=seed)
        mu, var = gp.posterior(xq)
        scale = np.std(y) or 1.0
        if np.max(np.abs(mu - mu_r[i])) / scale < 0.05 \
                and np.max(np.abs(var - var_r[i])) / scale ** 2 < 0.05:
            continue
        missed.add(i)
        ys = jnp.asarray((y - y.mean()) / (y.std() or 1.0), jnp.float32)
        f_bank, f_scalar = (float(_REF_PLAIN(jnp.asarray(t, jnp.float32),
                                             jnp.asarray(x, jnp.float32),
                                             ys)[0])
                            for t in (ref_bank.theta[i], gp.theta))
        assert f_bank > f_scalar, (i, f_bank, f_scalar)
    assert missed == smoke.OTHER_OPTIMA


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
