"""Exact Gaussian-process regression (the unit model behind MOBO, paper §2.2).

One GP per (segment, objective/constraint). Matérn-5/2 kernel with ARD
lengthscales; inputs live in the unit hypercube (see
:mod:`repro_torch.core.config_space`); targets are standardized internally
so the weak log-normal hyper-priors are scale-free.

This module is the **scalar reference oracle** and runs on the host:
:meth:`GP.fit` minimizes the negative log marginal likelihood with
multi-restart scipy L-BFGS-B driving a float32 torch objective whose
gradient comes from autograd, one model at a time. The batched path is
:mod:`repro_torch.core.gp_bank`, which fits whole batches of these GPs from
the same restart initializations and the same objective. The kernel, the
hyper-parameter packing (``theta`` = d log-lengthscales, log signal, log
noise) and the priors below are shared by both.

Numerics follow the reference, which runs this path in float32: the
objective, the Cholesky factor, ``alpha`` and the posterior are float32,
while ``theta`` stays the float64 vector scipy returns. A kernel matrix that
is not positive definite gives a NaN objective (``torch.linalg.cholesky_ex``
reports it; ``torch.linalg.cholesky`` would raise), as the reference's
Cholesky does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from scipy import optimize as sopt

_JITTER = 1e-6
_F32 = torch.float32
_LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------------
# kernel + marginal likelihood (batched over a leading axis)
# --------------------------------------------------------------------------
def _matern52(x1: torch.Tensor, x2: torch.Tensor, ls: torch.Tensor,
              signal: torch.Tensor) -> torch.Tensor:
    """Matérn-5/2 with ARD lengthscales. x1: (B, n, d), x2: (B, m, d),
    ls: (B, d), signal: (B,) -> (B, n, m)."""
    z1 = x1 / ls[:, None, :]
    z2 = x2 / ls[:, None, :]
    d2 = (z1 * z1).sum(-1)[:, :, None] + (z2 * z2).sum(-1)[:, None, :] \
        - 2.0 * z1 @ z2.transpose(1, 2)
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    s5r = math.sqrt(5.0) * r
    return signal[:, None, None] * (1.0 + s5r + 5.0 * d2 / 3.0) \
        * torch.exp(-s5r)


def _unpack(theta: torch.Tensor, dim: int):
    """(B, d+2) log hyper-parameters -> lengthscales (B, d), signal (B,),
    noise (B,)."""
    return (torch.exp(theta[:, :dim]), torch.exp(theta[:, dim]),
            torch.exp(theta[:, dim + 1]))


def _kernel_matrix(theta: torch.Tensor, x: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked K + (noise + jitter) I of B padded problems: padded rows are
    decoupled (zero rows/columns, unit diagonal), which leaves the Cholesky
    factor of the real block unchanged by the padding."""
    n, dim = x.shape[1], x.shape[2]
    ls, signal, noise = _unpack(theta, dim)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = _matern52(x, x, ls, signal) + (noise + _JITTER)[:, None, None] * eye
    m2 = mask[:, :, None] * mask[:, None, :]
    return torch.where(m2 > 0, k, 0.0) + torch.diag_embed(1.0 - mask)


def _cholesky(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Cholesky factor and a per-matrix success flag; a matrix that
    is not positive definite gets a NaN factor (the reference's Cholesky
    returns NaN there; ``torch.linalg.cholesky`` would raise)."""
    chol, info = torch.linalg.cholesky_ex(k)
    ok = info == 0
    return torch.where(ok[:, None, None], chol, torch.nan), ok


def _neg_mll(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood plus the hyper-priors of B padded
    problems over their ``mask == 1`` rows: theta (B, d+2), x (B, n, d),
    y (B, n) standardized, mask (B, n) -> (B,). NaN where K is not positive
    definite."""
    dim = x.shape[2]
    chol, ok = _cholesky(_kernel_matrix(theta, x, mask))
    alpha = torch.cholesky_solve(y[:, :, None], chol)[:, :, 0]
    n_real = mask.sum(1)
    logdet = (torch.log(torch.diagonal(chol, dim1=1, dim2=2)) * mask).sum(1)
    mll = -0.5 * (y * alpha).sum(1) - logdet - 0.5 * n_real * _LOG_2PI
    # Weak log-normal priors keep hyper-parameters in a sane band when n is
    # tiny (the cold-start regime RGPE is designed for).
    prior = (((theta[:, :dim] - math.log(0.5)) ** 2).sum(1) / 8.0
             + theta[:, dim] ** 2 / 8.0
             + (theta[:, dim + 1] - math.log(1e-2)) ** 2 / 18.0)
    return torch.where(ok, -(mll - prior), torch.nan)


def neg_mll_and_grad(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_neg_mll` of B problems and its gradient in theta (autograd);
    both NaN on a row whose kernel matrix is not positive definite."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        v = _neg_mll(th, x, y, mask)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(v), v, 0.0)
                                   .sum(), th)
    g = torch.where(torch.isfinite(v)[:, None], g, torch.nan)
    return v.detach(), g


def restart_inits(dim: int, restarts: int, seed: int) -> np.ndarray:
    """Multi-restart starting points for the log hyper-parameters, (R, d+2).

    Single source of truth for both optimizers: the scalar scipy path below
    and the batched path (:meth:`repro_torch.core.gp_bank.GPBank.fit`) draw
    identical initializations, from the reference's NumPy generator."""
    rng = np.random.default_rng(seed)
    t0s = np.empty((max(restarts, 1), dim + 2))
    for r in range(max(restarts, 1)):
        t0s[r] = np.concatenate([
            np.log(rng.uniform(0.2, 1.0, dim)),
            [np.log(rng.uniform(0.5, 2.0))],
            [np.log(rng.uniform(1e-3, 1e-1))],
        ])
    return t0s


def fallback_theta(dim: int) -> np.ndarray:
    """The hyper-parameters a fit returns when every restart failed."""
    return np.concatenate([np.zeros(dim), [0.0], [np.log(1e-2)]])


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=_F32)


@dataclass
class GP:
    """A fitted exact GP.

    Construct via :meth:`GP.fit` (scalar scipy path) or slice one out of a
    fitted :class:`~repro_torch.core.gp_bank.GPBank` with
    :meth:`~repro_torch.core.gp_bank.GPBank.member`; both produce this same
    dataclass of host NumPy arrays, so downstream consumers (RGPE, the
    controller) never care which optimizer fitted the model.
    """

    x: np.ndarray            # (n, d) unit-cube inputs, float64
    y_mean: float
    y_std: float
    theta: np.ndarray        # log hyper-parameters: d lengthscales, signal,
                             # noise
    chol: np.ndarray         # Cholesky of K + noise I, float32
    alpha: np.ndarray        # K^-1 y (standardized), float32

    # -- fitting -----------------------------------------------------------
    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, *, restarts: int = 3,
            seed: int = 0, max_iter: int = 120) -> "GP":
        x = np.asarray(x, np.float64).reshape(len(y), -1)
        y = np.asarray(y, np.float64).ravel()
        n, dim = x.shape
        y_mean = float(y.mean())
        y_std = float(y.std()) or 1.0
        ys = (y - y_mean) / y_std

        xj, yj = _f32(x)[None], _f32(ys)[None]
        ones = torch.ones((1, n), dtype=_F32)

        def objective(t64: np.ndarray) -> Tuple[float, np.ndarray]:
            v, g = neg_mll_and_grad(_f32(t64)[None], xj, yj, ones)
            return float(v[0]), g[0].double().numpy()

        best_v, best_t = np.inf, None
        for t0 in restart_inits(dim, restarts, seed):
            res = sopt.minimize(objective, t0, jac=True, method="L-BFGS-B",
                                options={"maxiter": max_iter})
            if res.fun < best_v and np.isfinite(res.fun):
                best_v, best_t = float(res.fun), np.asarray(res.x)
        if best_t is None:  # every restart non-finite
            best_t = fallback_theta(dim)

        chol, _ = _cholesky(_kernel_matrix(_f32(best_t)[None], xj, ones))
        alpha = torch.cholesky_solve(yj[:, :, None], chol)[0, :, 0]
        return GP(x=x, y_mean=y_mean, y_std=y_std, theta=np.asarray(best_t),
                  chol=chol[0].numpy(), alpha=alpha.numpy())

    # -- posterior ---------------------------------------------------------
    def posterior(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance (original units) at (m, d) queries,
        in float32 on the host."""
        dim = self.x.shape[1]
        xq = _f32(np.asarray(xq, np.float64).reshape(-1, dim))
        ls, signal, _ = _unpack(_f32(self.theta)[None], dim)
        ks = _matern52(xq[None], _f32(self.x)[None], ls, signal)[0]
        mean_s = ks @ _f32(self.alpha)
        v = torch.linalg.solve_triangular(_f32(self.chol), ks.T, upper=False)
        var_s = torch.clamp(signal[0] - (v * v).sum(0), min=1e-10)
        mean = mean_s.numpy() * self.y_std + self.y_mean
        var = var_s.numpy() * self.y_std ** 2
        return mean, var

    def sample(self, xq: np.ndarray, n_samples: int,
               rng: np.random.Generator) -> np.ndarray:
        """Independent-marginal posterior samples, (n_samples, m)."""
        mean, var = self.posterior(xq)
        return rng.normal(mean[None, :], np.sqrt(var)[None, :],
                          size=(n_samples, len(mean)))

    def loo_samples(self, n_samples: int, rng: np.random.Generator
                    ) -> np.ndarray:
        """Leave-one-out posterior samples at the training points.

        Used by RGPE to score the target model without optimistic bias
        (Feurer et al.). Uses the closed-form LOO identities on K^-1."""
        n, dim = self.x.shape
        k = _kernel_matrix(_f32(self.theta)[None], _f32(self.x)[None],
                           torch.ones((1, n), dtype=_F32))[0]
        kinv = torch.linalg.inv(k).numpy()
        ys = (self.chol @ self.chol.T) @ self.alpha  # K alpha = standardized y
        diag = np.diag(kinv)
        mu_loo = ys - self.alpha / diag
        var_loo = np.maximum(1.0 / diag, 1e-10)
        s = rng.normal(mu_loo[None, :], np.sqrt(var_loo)[None, :],
                       size=(n_samples, n))
        return s * self.y_std + self.y_mean

    @property
    def train_targets(self) -> np.ndarray:
        ys = (self.chol @ self.chol.T) @ self.alpha  # K alpha = standardized y
        return ys * self.y_std + self.y_mean
