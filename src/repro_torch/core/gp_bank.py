"""Batched GP fitting and prediction for the whole modeling stack.

:class:`GPBank` packs many exact GPs — one per (segment, objective) and, in
a sweep, per scenario — into stacked, zero-padded float32 tensors on one
device and fits **all** their hyper-parameters together: every (member,
restart) pair is one row of a batched L-BFGS (:func:`lbfgs_batched`), so a
whole model update is one batched optimization instead of a scipy loop per
model.

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

from .executor import resolve_device
from .gp import (GP, _cholesky, _kernel_matrix, _matern52, _neg_mll,
                 _unpack, fallback_theta, neg_mll_and_grad, restart_inits)

#: Default optimizer budget; mirrors ModelBank's scalar-path settings.
DEFAULT_RESTARTS = 2
DEFAULT_MAX_ITER = 60
#: Gradient-norm tolerance of the batched L-BFGS (the reference's).
GRAD_TOL = 1e-5
#: L-BFGS memory (optax's default), Armijo constant, halvings tried in the
#: line search's second pass, and how often the host reads the done mask.
LBFGS_MEMORY = 10
ARMIJO_C1 = 1e-4
LADDER = 8
CHECK_EVERY = 5

_F32 = torch.float32


def bucket_pow2(n: int, minimum: int = 8) -> int:
    """Next power of two >= n (the padding of training sizes, and of the
    forecast bank's lag and season widths)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------
# batched L-BFGS over independent problems
# --------------------------------------------------------------------------
def lbfgs_batched(fun: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                  t0: torch.Tensor, *, max_iter: int) -> torch.Tensor:
    """Minimize N independent problems at once; returns the (N, D) minima.

    ``fun(theta)`` returns ``(values (N,), grads (N, D))``;
    ``fun(theta, grad=False)`` returns the values alone. Each row is an
    ordinary L-BFGS run (two-loop recursion over its last ``LBFGS_MEMORY``
    curvature pairs) with its own "done" mask: a row stops moving once its
    gradient norm is <= ``GRAD_TOL``, after ``max_iter`` iterations (at least
    one, as the reference's loop), or when its line search finds no acceptable
    step. A trial step with a non-finite value (a kernel matrix that is not
    positive definite) is never accepted.

    The line search is a backtracking Armijo search in batched passes: the
    full step for every row; then, for the rows it failed, the ``LADDER``
    halvings t/2 .. t/2^LADDER evaluated together (values only), taking the
    longest acceptable one; then that step's gradient. A pass costs the same
    launches whatever the batch, so an iteration costs at most three
    objective passes, and the host reads the masks once per iteration (and
    the done mask every ``CHECK_EVERY`` iterations).
    """
    theta = t0.clone()
    N, D = theta.shape
    dev, dt = theta.device, theta.dtype
    f, g = fun(theta)
    S = torch.zeros((LBFGS_MEMORY, N, D), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((LBFGS_MEMORY, N), dtype=dt, device=dev)
    gamma = torch.ones(N, dtype=dt, device=dev)
    has_hist = torch.zeros(N, dtype=torch.bool, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    halvings = 0.5 ** torch.arange(1, LADDER + 1, dtype=dt, device=dev)
    for it in range(max_iter):
        active = ~done
        # two-loop recursion, newest pair first (empty slots have rho = 0)
        q = g.clone()
        alphas = []
        slots = [(it - 1 - i) % LBFGS_MEMORY
                 for i in range(min(it, LBFGS_MEMORY))]
        for s in slots:
            a = rho[s] * (S[s] * q).sum(1)
            q = q - a[:, None] * Y[s]
            alphas.append(a)
        r = gamma[:, None] * q
        for s, a in zip(reversed(slots), reversed(alphas)):
            b = rho[s] * (Y[s] * r).sum(1)
            r = r + S[s] * (a - b)[:, None]
        d = -r
        gd = (g * d).sum(1)
        # no curvature pairs yet, or not a descent direction: steepest
        # descent with a first step of length at most 1
        steep = ~has_hist | ~(gd < 0)
        d = torch.where(steep[:, None], -g, d)
        gd = torch.where(steep, -(g * g).sum(1), gd)
        t = torch.where(steep, torch.clamp(1.0 / d.norm(dim=1), max=1.0),
                        torch.ones_like(gd))
        pending = active & torch.isfinite(gd)
        # pass 1: the full step
        cand = theta + t[:, None] * d
        fc, gc = fun(cand)
        accepted = pending & torch.isfinite(fc) \
            & (fc <= f + ARMIJO_C1 * t * gd)
        theta_new = torch.where(accepted[:, None], cand, theta)
        f_new = torch.where(accepted, fc, f)
        g_new = torch.where(accepted[:, None], gc, g)
        pending &= ~accepted
        if bool(pending.any()):
            # pass 2: every halving of the failed rows at once (values)
            tl = t[None, :] * halvings[:, None]                 # (L, N)
            cl = theta[None] + tl[:, :, None] * d[None]         # (L, N, D)
            fl = fun(cl.reshape(-1, D), grad=False).reshape(LADDER, N)
            okl = torch.isfinite(fl) \
                & (fl <= f[None] + ARMIJO_C1 * tl * gd[None])
            first = torch.argmax(okl.to(torch.int8), dim=0)     # longest step
            found = pending & okl.any(0)
            t2 = tl.gather(0, first[None])[0]
            # pass 3: value and gradient at the accepted halving
            cand = theta + t2[:, None] * d
            fc, gc = fun(cand)
            theta_new = torch.where(found[:, None], cand, theta_new)
            f_new = torch.where(found, fc, f_new)
            g_new = torch.where(found[:, None], gc, g_new)
            accepted |= found
        s_vec = theta_new - theta
        y_vec = g_new - g
        sy = (s_vec * y_vec).sum(1)
        yy = (y_vec * y_vec).sum(1)
        pair = accepted & (sy > 1e-10) & torch.isfinite(sy) & (yy > 0)
        slot = it % LBFGS_MEMORY
        S[slot] = torch.where(pair[:, None], s_vec, 0.0)
        Y[slot] = torch.where(pair[:, None], y_vec, 0.0)
        rho[slot] = torch.where(pair, 1.0 / torch.where(pair, sy, 1.0), 0.0)
        gamma = torch.where(pair, sy / torch.where(pair, yy, 1.0), gamma)
        has_hist |= pair
        theta, f, g = theta_new, f_new, g_new
        done |= (active & ~accepted) | (g.norm(dim=1) <= GRAD_TOL)
        if (it + 1) % CHECK_EVERY == 0 and bool(done.all()):
            break
    return theta


def _fit_packed(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                t0s: torch.Tensor, max_iter: int):
    """Fit B padded GPs, each from R restarts, in one batched optimization.

    x: (B, n, d), y: (B, n) standardized, mask: (B, n), t0s: (B, R, d+2),
    float32 on one device. Returns the best theta (B, d+2), its objective
    value (B,), and the Cholesky/alpha pair of the kernel at the optimum.
    """
    B, R, D = t0s.shape
    dim = x.shape[2]
    xr = x.repeat_interleave(R, dim=0)
    yr = y.repeat_interleave(R, dim=0)
    mr = mask.repeat_interleave(R, dim=0)

    def fun(th: torch.Tensor, grad: bool = True):
        if grad:
            return neg_mll_and_grad(th, xr, yr, mr)
        k = th.shape[0] // xr.shape[0]          # ladder passes tile the rows
        with torch.no_grad():
            return _neg_mll(th, xr.repeat(k, 1, 1), yr.repeat(k, 1),
                            mr.repeat(k, 1))

    ts = lbfgs_batched(fun, t0s.reshape(B * R, D), max_iter=max_iter)
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
        theta, _val, chol, alpha = _fit_packed(
            pack(xs), pack(ys), pack(mask), pack(t0s), max_iter=max_iter)
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
        mean_s, var_s = _posterior_packed(
            pack(self.x), pack(self.mask), pack(self.theta), pack(self.chol),
            pack(self.alpha), pack(xq)[None])
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
    mean_s, var_s = _posterior_packed(pack(xs), pack(mask), pack(theta),
                                      pack(chol), pack(alpha), pack(xq)[None])
    y_std = np.asarray([g.y_std for g in gps])
    y_mean = np.asarray([g.y_mean for g in gps])
    mean = mean_s.cpu().numpy() * y_std[:, None] + y_mean[:, None]
    var = var_s.cpu().numpy() * (y_std ** 2)[:, None]
    return mean, var
