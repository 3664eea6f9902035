"""Batched GP fitting and prediction for the whole modeling stack.

:class:`GPBank` packs many exact GPs — one per (segment, objective) and, in
a sweep, per scenario — into stacked, zero-padded float32 tensors on one
device and fits **all** their hyper-parameters together: every (member,
restart) pair is one row of a batched L-BFGS, the reference's optimizer
(``optax.lbfgs()``: memory 10 with the zoom line search, run until
``max_iter`` iterations or a gradient norm of ``GRAD_TOL``), so a whole
model update is one batched optimization instead of a scipy loop per
model. On the card the batch is one launch of the fit kernel
(``csrc/gp_fit.cu``), a CTA per row; on the CPU its plain version,
:func:`lbfgs_batched`.

The batched path and the scalar oracle (:meth:`repro_torch.core.gp.GP.fit`)
optimize the *same* masked marginal-likelihood objective from the *same*
restart initializations under the same budget (restarts, iterations,
gradient-norm tolerance), so a bank member agrees with the scalar fit
within float32 optimizer tolerance.

Padding layout: every member is padded to a power-of-two training size.
Padded rows carry ``mask == 0``; the kernel matrix is forced block-diagonal
(identity on the padded block), so the Cholesky factor, ``alpha`` and the
marginal likelihood of the real block are untouched by padding and a member
can be sliced back out as a plain :class:`~repro_torch.core.gp.GP`. The
batched Cholesky and triangular solves are ``torch.linalg`` calls, as the
reference leaves them to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from .executor import resolve_device
from .gp import (GP, _cholesky, _kernel_matrix, _matern52,
                 _unpack, fallback_theta, neg_mll_and_grad, restart_inits)

#: Default optimizer budget; mirrors ModelBank's scalar-path settings.
DEFAULT_RESTARTS = 2
DEFAULT_MAX_ITER = 60
#: Gradient-norm tolerance of the batched L-BFGS (the reference's).
GRAD_TOL = 1e-5
#: L-BFGS memory (``optax.lbfgs``'s default).
LBFGS_MEMORY = 10
#: The zoom line search as ``optax.lbfgs()`` builds it
#: (``scale_by_zoom_linesearch(max_linesearch_steps=20,
#: initial_guess_strategy="one")`` at its default tolerances): trials per
#: search, the sufficient-decrease and curvature constants, the approximate
#: Wolfe tolerance, the interval length below which zoom settles for a
#: step of sufficient decrease, and the bracketing growth factor.
LS_MAX_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0

_F32 = torch.float32


def bucket_pow2(n: int, minimum: int = 8) -> int:
    """Next power of two >= n (the padding of training sizes, and of the
    forecast bank's lag and season widths)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------
# batched L-BFGS over independent problems: optax.lbfgs() row by row
# --------------------------------------------------------------------------
def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _decrease_error(step, value, slope, value0, slope0):
    """The sufficient-decrease violation (0 where met, inf where NaN):
    Armijo's, or Hager and Zhang's approximate Wolfe condition near a
    minimum, whichever is smaller."""
    armijo = value - value0 - SLOPE_RTOL * step * slope0
    approx = torch.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope0,
                           value - value0 - APPROX_DEC_RTOL * value0.abs())
    err = torch.clamp(torch.minimum(approx, armijo), min=0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope0):
    """The strong-Wolfe curvature violation (0 where met, inf where NaN)."""
    err = torch.clamp(slope.abs() - CURV_RTOL * slope0.abs(), min=0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (then it is not used)."""
    db, dc = b - a, c - a
    p = db * dc
    denom = p * p * (db - dc)
    v0, v1 = fb - fa - fpa * db, fc - fa - fpa * dc
    big_a = (dc * dc * v0 + -(db * db) * v1) / denom
    big_b = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / (db * db)))


def lbfgs_batched(fun: Callable[[torch.Tensor, Optional[torch.Tensor]],
                                Tuple[torch.Tensor, torch.Tensor]],
                  t0: torch.Tensor, *, max_iter: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize N independent problems at once, each row as the
    reference's loop runs ``optax.lbfgs()``; returns the (N, D) minima and
    each row's iteration count (N,).

    ``fun(theta, rows)`` returns ``(values (k,), grads (k, D))`` of the
    problems ``rows`` (an index tensor; ``None`` for all N) at ``theta``
    (k, D). Per row, as ``optax.scale_by_lbfgs(memory_size=10,
    scale_init_precond=True)``: every curvature pair is stored, with weight
    ``1/(s.y)`` (0 where ``s.y == 0``); the initial inverse Hessian is
    ``gamma I`` with gamma ``s.y / y.y`` of the newest pair (1 where
    ``y.y == 0``), and ``min(1, 1/|g|)`` at the first iteration; the
    two-loop recursion runs over all ten slots. The step comes from
    ``scale_by_zoom_linesearch`` (strong Wolfe: :func:`_decrease_error`,
    :func:`_curvature_error`): the first trial at step 1, then doubling
    until an interval is bracketed, then zoom by cubic, quadratic or
    bisection; after ``LS_MAX_STEPS`` trials, or once the interval is
    shorter than ``STEPSIZE_PRECISION`` with a step of sufficient decrease
    in hand, the search takes the best such step, else keeps its last
    trial. The value and gradient at the new point are the search's;
    where that value is not finite they are recomputed at the point, as
    ``optax.value_and_grad_from_state`` does. A row runs at least one
    iteration, then while its count is below ``max_iter`` and the search's
    gradient norm exceeds ``GRAD_TOL``; a failed search does not stop it.

    This is the plain version of the fit kernel (``csrc/gp_fit.cu``, which
    runs every row's whole loop on the card in one launch); the bank uses
    it on the CPU. Each line-search trial is one value-and-gradient pass
    over the rows still searching. The host reads one small status vector
    per trial, which names the rows still searching and, once none is, the
    rows that go on to the next iteration (and those whose value is
    recomputed): one read per iteration when every search ends at its first
    trial, and one more for each further trial that some row's bracketing
    or zoom needs (near the optimum most searches take all 20).
    """
    N, D = t0.shape
    dev, dt = t0.device, t0.dtype
    M = LBFGS_MEMORY
    zeros = lambda: torch.zeros(N, dtype=dt, device=dev)   # noqa: E731
    theta = t0.clone()
    S = torch.zeros((M, N, D), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    W = torch.zeros((M, N), dtype=dt, device=dev)
    prev_theta, prev_g = torch.zeros_like(theta), torch.zeros_like(theta)
    # the value and gradient the last search left at theta (optax's stored
    # ones: inf and zeros before the first iteration)
    f = torch.full((N,), torch.inf, dtype=dt, device=dev)
    g = torch.zeros_like(theta)
    counts = torch.zeros(N, dtype=torch.int64, device=dev)
    rows = recompute = torch.arange(N, device=dev)
    it = 0
    while rows.numel():
        act = torch.zeros(N, dtype=torch.bool, device=dev)
        act[rows] = True
        if recompute.numel():
            v, gr = fun(theta[recompute],
                        None if recompute.numel() == N else recompute)
            f, g = f.index_copy(0, recompute, v), g.index_copy(0, recompute,
                                                               gr)
        # -- scale_by_lbfgs: store the newest pair, then precondition -----
        cur, prev = it % M, (it - 1) % M
        if it > 0:
            ds, dy = theta - prev_theta, g - prev_g
            sy, yy = _dot(dy, ds), _dot(dy, dy)
            S[prev] = torch.where(act[:, None], ds, S[prev])
            Y[prev] = torch.where(act[:, None], dy, Y[prev])
            W[prev] = torch.where(act, torch.where(sy == 0.0, 0.0, 1.0 / sy),
                                  W[prev])
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        else:
            gamma = torch.clamp(1.0 / g.norm(dim=1), max=1.0)
        prev_theta = torch.where(act[:, None], theta, prev_theta)
        prev_g = torch.where(act[:, None], g, prev_g)
        order = [(cur + i) % M for i in range(M)]
        q, alphas = g, {}
        for j in reversed(order):                       # newest first
            alphas[j] = W[j] * _dot(S[j], q)
            q = q - alphas[j][:, None] * Y[j]
        q = gamma[:, None] * q
        for j in order:                                 # oldest first
            q = q + (alphas[j] - W[j] * _dot(Y[j], q))[:, None] * S[j]
        d = -q
        # -- scale_by_zoom_linesearch -------------------------------------
        slope0 = _dot(d, g)
        step, val, grd, slope = zeros(), f, g, slope0
        dec = torch.full((N,), torch.inf, dtype=dt, device=dev)
        found = torch.zeros(N, dtype=torch.bool, device=dev)
        low = high = ref = zeros()
        v_low = v_high = v_ref = f
        s_low = s_high = slope0
        safe, safe_v, safe_g = zeros(), f, g
        pend, prows = act, rows
        for trial in range(LS_MAX_STEPS):
            last = trial + 1 >= LS_MAX_STEPS
            # the trial step: bracketing's (1, then doubling) or, on the
            # rows with an interval (none at the first trial), zoom's
            # interpolation inside it
            new = (torch.ones_like(step) if trial == 0
                   else INCREASE_FACTOR * step)
            if trial:
                delta = (high - low).abs()
                left = torch.minimum(high, low)
                right = torch.maximum(high, low)
                mc = _cubicmin(low, v_low, s_low, high, v_high, ref, v_ref)
                use_c = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
                mq = _quadmin(low, v_low, s_low, high, v_high)
                use_q = ~use_c & (mq > left + 0.1 * delta) \
                    & (mq < right - 0.1 * delta)
                mid = torch.where(use_q, mq, torch.where(use_c, mc, ref))
                mid = torch.where(~use_c & ~use_q, (low + high) / 2.0, mid)
                new = torch.where(found, mid, new)
            nv, ng = fun(theta[prows] + new[prows, None] * d[prows],
                         None if prows.numel() == N else prows)
            n_v = torch.full_like(f, torch.nan).index_copy(0, prows, nv)
            n_g = torch.zeros_like(g).index_copy(0, prows, ng)
            n_s = _dot(n_g, d)
            n_dec = _decrease_error(new, n_v, n_s, f, slope0)
            ok = torch.maximum(n_dec, _curvature_error(n_s, slope0)) <= 0.0
            sufficient = n_dec <= 0.0
            # bracketing (Nocedal and Wright, algorithm 3.5)
            hi_new = (n_dec > 0.0) | ((n_v >= val) & (trial > 0))
            lo_new = (n_s >= 0.0) & ~hi_new
            nxt_low = torch.where(lo_new, new, step)
            nxt_vlow = torch.where(lo_new, n_v, val)
            nxt_slow = torch.where(lo_new, n_s, slope)
            nxt_high = torch.where(lo_new, step, new)
            nxt_vhigh = torch.where(lo_new, val, n_v)
            nxt_shigh = torch.where(lo_new, slope, n_s)
            nxt_ref, nxt_vref = nxt_low, nxt_vlow
            take_safe = sufficient
            fail = torch.full_like(ok, last) & ~ok
            if trial:
                # zoom (algorithm 3.6) on the rows with an interval
                z_safe = sufficient & (n_v < safe_v)
                hi_mid = (n_dec > 0.0) | (n_v >= v_low)
                hi_low = (n_s * (high - low) >= 0.0) & ~hi_mid
                moved = hi_mid | hi_low
                z_fail = (torch.full_like(ok, last)
                          | ((delta <= STEPSIZE_PRECISION)
                             & (torch.where(z_safe, new, safe) > 0.0))) & ~ok
                pick = lambda z, b: torch.where(found, z, b)  # noqa: E731
                nxt_high = pick(torch.where(
                    hi_low, low, torch.where(hi_mid, new, high)), nxt_high)
                nxt_vhigh = pick(torch.where(
                    hi_low, v_low, torch.where(hi_mid, n_v, v_high)),
                    nxt_vhigh)
                nxt_shigh = pick(torch.where(
                    hi_low, s_low, torch.where(hi_mid, n_s, s_high)),
                    nxt_shigh)
                nxt_low = pick(torch.where(hi_mid, low, new), nxt_low)
                nxt_vlow = pick(torch.where(hi_mid, v_low, n_v), nxt_vlow)
                nxt_slow = pick(torch.where(hi_mid, s_low, n_s), nxt_slow)
                nxt_ref = pick(torch.where(moved, high, low), nxt_ref)
                nxt_vref = pick(torch.where(moved, v_high, v_low), nxt_vref)
                take_safe = pick(z_safe, take_safe)
                fail = pick(z_fail, fail)
            found = torch.where(pend, found | hi_new | lo_new | ok, found)
            low = torch.where(pend, nxt_low, low)
            v_low = torch.where(pend, nxt_vlow, v_low)
            s_low = torch.where(pend, nxt_slow, s_low)
            high = torch.where(pend, nxt_high, high)
            v_high = torch.where(pend, nxt_vhigh, v_high)
            s_high = torch.where(pend, nxt_shigh, s_high)
            ref = torch.where(pend, nxt_ref, ref)
            v_ref = torch.where(pend, nxt_vref, v_ref)
            ts = pend & take_safe
            safe = torch.where(ts, new, safe)
            safe_v = torch.where(ts, n_v, safe_v)
            safe_g = torch.where(ts[:, None], n_g, safe_g)
            step = torch.where(pend, new, step)
            val = torch.where(pend, n_v, val)
            grd = torch.where(pend[:, None], n_g, grd)
            slope = torch.where(pend, n_s, slope)
            dec = torch.where(pend, n_dec, dec)
            # a failed search takes its best step of sufficient decrease,
            # if it has one or its last trial left the domain
            back = pend & fail & ((safe > 0.0) | torch.isinf(dec))
            step = torch.where(back, safe, step)
            val = torch.where(back, safe_v, val)
            grd = torch.where(back[:, None], safe_g, grd)
            pend = pend & ~ok & ~fail
            # this trial's one host read: 1 still searching; else 2 goes
            # on to the next iteration, 3 the same with its value
            # recomputed, 0 stops
            go = act & (counts + 1 < max_iter) & (grd.norm(dim=1) > GRAD_TOL)
            status = torch.where(pend, 1, torch.where(
                go, torch.where(torch.isfinite(val), 2, 3), 0)
            ).to(torch.int8).cpu()
            prows = torch.nonzero(status == 1)[:, 0].to(dev)
            if not prows.numel():
                break
        # -- the step, with the search's value and gradient there ---------
        theta = torch.where(act[:, None], theta + step[:, None] * d, theta)
        f = torch.where(act, val, f)
        g = torch.where(act[:, None], grd, g)
        counts = counts + act.to(counts.dtype)
        it += 1
        rows = torch.nonzero(status >= 2)[:, 0].to(dev)
        recompute = torch.nonzero(status == 3)[:, 0].to(dev)
    return theta, counts


def _fit_packed(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                t0s: torch.Tensor, max_iter: int):
    """Fit B padded GPs, each from R restarts, in one batched optimization
    (:func:`repro_torch.kernels.ops.gp_lbfgs`): on a CUDA device one launch
    of the fit kernel, the whole of optax's L-BFGS for every row on the
    card; on the CPU its plain version, :func:`lbfgs_batched` over
    :func:`~repro_torch.core.gp.neg_mll_and_grad`.
    Then, as the reference's ``_fit_packed``: each member's best restart
    (the lowest finite objective), or the fallback theta where every
    restart's objective is not finite.

    x: (B, n, d), y: (B, n) standardized, mask: (B, n), t0s: (B, R, d+2),
    float32 on one device. Returns the best theta (B, d+2), its objective
    value (B,), and the Cholesky/alpha pair of the kernel at the optimum.
    """
    B, R, D = t0s.shape
    dim = x.shape[2]
    xr = x.repeat_interleave(R, dim=0)
    yr = y.repeat_interleave(R, dim=0)
    mr = mask.repeat_interleave(R, dim=0)

    ts, _ = ops.gp_lbfgs(x, y, mask, t0s.reshape(B * R, D), restarts=R,
                         max_iter=max_iter)
    vs, _ = neg_mll_and_grad(ts, xr, yr, mr)
    vs = torch.where(torch.isfinite(vs), vs, torch.inf).reshape(B, R)
    j = torch.argmin(vs, dim=1)
    best = vs.gather(1, j[:, None])[:, 0]
    ts = ts.reshape(B, R, D).gather(1, j[:, None, None].expand(B, 1, D))[:, 0]
    fallback = torch.as_tensor(fallback_theta(dim), dtype=x.dtype,
                               device=x.device)
    theta = torch.where(torch.isfinite(best)[:, None], ts, fallback)
    chol, _ = _cholesky(_kernel_matrix(theta, x, mask))
    alpha = torch.cholesky_solve(y[:, :, None], chol)[:, :, 0]
    return theta, best, chol, alpha


def _posterior_packed(x: torch.Tensor, mask: torch.Tensor,
                      theta: torch.Tensor, chol: torch.Tensor,
                      alpha: torch.Tensor, xq: torch.Tensor):
    """Standardized posterior of B padded GPs at a shared (m, d) query grid:
    two (B, m) tensors."""
    B, _, dim = x.shape
    ls, signal, _ = _unpack(theta, dim)
    ks = _matern52(xq.expand(B, -1, -1), x, ls, signal) * mask[:, None, :]
    mean = (ks @ alpha[:, :, None])[:, :, 0]
    v = torch.linalg.solve_triangular(chol, ks.transpose(1, 2), upper=False)
    var = torch.clamp(signal[:, None] - (v * v).sum(1), min=1e-10)
    return mean, var


@dataclass
class GPBank:
    """A batch of fitted exact GPs sharing one packed representation.

    Construct via :meth:`GPBank.fit`. All members share the input dimension
    ``d``; training-set sizes may differ (padded internally). The arrays
    are host copies; :meth:`posterior` runs on ``device``.
    """

    x: np.ndarray        # (B, n_max, d) padded unit-cube inputs
    mask: np.ndarray     # (B, n_max) 1.0 on real rows
    theta: np.ndarray    # (B, d + 2) log hyper-parameters, float32
    chol: np.ndarray     # (B, n_max, n_max) Cholesky of masked K + noise I
    alpha: np.ndarray    # (B, n_max) K^-1 y (standardized)
    y_mean: np.ndarray   # (B,)
    y_std: np.ndarray    # (B,)
    device: str = "cuda"

    # -- fitting -----------------------------------------------------------
    @staticmethod
    def fit(datasets: Sequence[Tuple[np.ndarray, np.ndarray]], *,
            restarts: int = DEFAULT_RESTARTS,
            seeds: Optional[Sequence[int]] = None,
            max_iter: int = DEFAULT_MAX_ITER,
            device: str = "cuda") -> "GPBank":
        """Fit one GP per ``(x, y)`` dataset in one batched optimization on
        ``device`` (``"cuda"`` by default; raises where there is no card).

        ``seeds`` controls each member's restart initializations and matches
        :meth:`GP.fit`'s draws, so member ``i`` optimizes from the same
        starting points as ``GP.fit(x_i, y_i, seed=seeds[i])``.
        """
        dev = resolve_device(device)
        if not datasets:
            raise ValueError("GPBank.fit needs at least one dataset")
        if seeds is None:
            seeds = [0] * len(datasets)
        if len(seeds) != len(datasets):
            raise ValueError("seeds must align with datasets")
        dims = {np.asarray(x).reshape(len(y), -1).shape[1]
                for x, y in datasets}
        if len(dims) != 1:
            raise ValueError(f"all datasets must share one input dim, "
                             f"got {sorted(dims)}")
        dim = dims.pop()
        b = len(datasets)
        n_max = bucket_pow2(max(len(y) for _, y in datasets))

        xs = np.zeros((b, n_max, dim))
        ys = np.zeros((b, n_max))
        mask = np.zeros((b, n_max))
        y_mean = np.zeros(b)
        y_std = np.ones(b)
        t0s = np.zeros((b, max(restarts, 1), dim + 2))
        for i, (x, y) in enumerate(datasets):
            x = np.asarray(x, np.float64).reshape(len(y), -1)
            y = np.asarray(y, np.float64).ravel()
            n = len(y)
            y_mean[i] = y.mean()
            y_std[i] = y.std() or 1.0
            xs[i, :n] = x
            ys[i, :n] = (y - y_mean[i]) / y_std[i]
            mask[i, :n] = 1.0
            t0s[i] = restart_inits(dim, restarts, seeds[i])

        pack = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa
        with obs.timed_phase("fit", "gp_bank.fit",
                             members=b, b=b, n_max=n_max):
            packed = [pack(a) for a in (xs, ys, mask, t0s)]
            theta, _val, chol, alpha = _fit_packed(*packed, max_iter=max_iter)
        if obs.enabled():
            obs.inc("sweep.gp_fits", b)
            obs.inc("transfer.h2d_bytes", sum(t.nbytes for t in packed))
        return GPBank(x=xs, mask=mask, theta=theta.cpu().numpy(),
                      chol=chol.cpu().numpy(), alpha=alpha.cpu().numpy(),
                      y_mean=y_mean, y_std=y_std, device=str(dev))

    # -- queries -----------------------------------------------------------
    @property
    def n_members(self) -> int:
        return len(self.theta)

    def counts(self) -> np.ndarray:
        return self.mask.sum(axis=1).astype(int)

    def posterior(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """All members' posterior mean/variance (original units) at a shared
        (m, d) query grid: two (B, m) arrays from one batched pass."""
        dev = resolve_device(self.device)
        xq = np.asarray(xq, np.float64).reshape(-1, self.x.shape[-1])
        pack = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa
        with obs.span("gp_bank.posterior", members=self.n_members,
                      m=xq.shape[0]):
            mean_s, var_s = _posterior_packed(
                pack(self.x), pack(self.mask), pack(self.theta),
                pack(self.chol), pack(self.alpha), pack(xq)[None])
        mean = mean_s.cpu().numpy() * self.y_std[:, None] \
            + self.y_mean[:, None]
        var = var_s.cpu().numpy() * (self.y_std ** 2)[:, None]
        return mean, var

    def member(self, i: int) -> GP:
        """Slice member ``i`` back out as a scalar :class:`GP`.

        Padding keeps the real block of the Cholesky factor exact, so this
        is a cheap view — no refactorization."""
        n = int(self.mask[i].sum())
        return GP(x=self.x[i, :n].copy(),
                  y_mean=float(self.y_mean[i]), y_std=float(self.y_std[i]),
                  theta=self.theta[i].copy(),
                  chol=self.chol[i, :n, :n].copy(),
                  alpha=self.alpha[i, :n].copy())

    def members(self) -> List[GP]:
        return [self.member(i) for i in range(self.n_members)]


def batched_posterior(gps: Sequence[GP], xq: np.ndarray,
                      device: str = "cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Posterior mean/variance of fitted GPs at a shared grid, in one
    batched float32 pass on ``device`` (``"cuda"`` by default; raises where
    there is no card).

    Packs already-fitted scalar GPs (whatever path produced them) into
    padded tensors. Returns two (len(gps), m) arrays. This is the RGPE and
    controller fast path: every ensemble member in one pass instead of a
    Python loop.
    """
    dev = resolve_device(device)
    if not gps:
        raise ValueError("batched_posterior needs at least one GP")
    dim = gps[0].x.shape[1]
    xq = np.asarray(xq, np.float64).reshape(-1, dim)
    b = len(gps)
    n_max = bucket_pow2(max(len(g.alpha) for g in gps))
    xs = np.zeros((b, n_max, dim))
    mask = np.zeros((b, n_max))
    theta = np.zeros((b, dim + 2))
    chol = np.tile(np.eye(n_max), (b, 1, 1))
    alpha = np.zeros((b, n_max))
    for i, g in enumerate(gps):
        n = len(g.alpha)
        xs[i, :n] = g.x
        mask[i, :n] = 1.0
        theta[i] = g.theta
        chol[i, :n, :n] = g.chol
        chol[i, n:, :n] = 0.0
        alpha[i, :n] = g.alpha
    pack = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa: E731
    with obs.span("gp_bank.batched_posterior", members=len(gps),
                  m=xq.shape[0]):
        mean_s, var_s = _posterior_packed(
            pack(xs), pack(mask), pack(theta), pack(chol), pack(alpha),
            pack(xq)[None])
    y_std = np.asarray([g.y_std for g in gps])
    y_mean = np.asarray([g.y_mean for g in gps])
    mean = mean_s.cpu().numpy() * y_std[:, None] + y_mean[:, None]
    var = var_s.cpu().numpy() * (y_std ** 2)[:, None]
    return mean, var
