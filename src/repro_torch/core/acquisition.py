"""Acquisition functions for MOBO (paper §2.2/§2.3).

Profiling candidates are scored by *expected hypervolume improvement weighted
by the probability of feasibility* over all modeled constraints (paper §2.3's
acquisition: only configurations whose models predict the recovery constraint
RC satisfied are worth profiling budget). The bi-objective case (resource
usage, latency — the two objectives of paper §2.2's MOBO formulation) admits
an **exact** EHVI under independent Gaussian marginals via a strip
decomposition of the dominated region: for a staircase front the improvement
factors per strip into a width ramp in objective 1 and a height ramp in
objective 2, and

    E[max(c - z, 0)] = (c - mu) Phi((c - mu)/sigma) + sigma phi((c - mu)/sigma)

closes both integrals. Batch (q-point) selection uses sequential greedy with
Kriging-believer hallucination.

Two implementations coexist:

* the NumPy/SciPy functions (:func:`pareto_front_2d`, :func:`ehvi_2d`,
  :func:`hypervolume_2d`) — the float64 reference oracle, copied from the
  reference;
* a batched float32 torch path (:func:`pareto_front_mask_2d`,
  :func:`ehvi_2d_batch`) that computes Pareto-front masks and EHVI for a
  whole *batch* of fronts / candidate grids in one pass on a device, as the
  reference's jitted path does. Its sorts are stable, as the reference's
  are, so ties break the same way. :func:`select_profiling_batch` routes
  through it by default.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import stats

from .executor import resolve_device

_F32 = torch.float32


def _ramp_expectation(c: np.ndarray, mu: np.ndarray, sigma: np.ndarray
                      ) -> np.ndarray:
    """E[max(c - Z, 0)], Z ~ N(mu, sigma^2); broadcasts, handles c = -inf."""
    sigma = np.maximum(sigma, 1e-12)
    neg_inf = np.isneginf(c)
    c_safe = np.where(neg_inf, 0.0, c)
    z = (c_safe - mu) / sigma
    out = (c_safe - mu) * stats.norm.cdf(z) + sigma * stats.norm.pdf(z)
    return np.where(neg_inf, 0.0, out)


def pareto_front_2d(points: np.ndarray) -> np.ndarray:
    """Non-dominated subset for 2-objective minimization, sorted by obj 1."""
    if len(points) == 0:
        return points.reshape(0, 2)
    order = np.lexsort((points[:, 1], points[:, 0]))
    front: List[np.ndarray] = []
    best_y = np.inf
    for p in points[order]:
        if p[1] < best_y - 1e-15:
            front.append(p)
            best_y = p[1]
    return np.asarray(front)


def hypervolume_2d(front: np.ndarray, ref: Tuple[float, float]) -> float:
    """Dominated hypervolume (minimization) of a staircase front w.r.t ref."""
    front = pareto_front_2d(np.asarray(front, np.float64))
    front = front[(front[:, 0] < ref[0]) & (front[:, 1] < ref[1])]
    if len(front) == 0:
        return 0.0
    hv, prev_y = 0.0, ref[1]
    for x, y in front:
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return float(hv)


def ehvi_2d(mu: np.ndarray, var: np.ndarray, front: np.ndarray,
            ref: Tuple[float, float]) -> np.ndarray:
    """Exact EHVI for a batch of candidates.

    mu, var: (n, 2) posterior marginals; front: (k, 2) observed points
    (will be reduced to its Pareto subset); ref: reference point. Returns (n,).
    """
    mu = np.atleast_2d(mu)
    var = np.atleast_2d(var)
    sd = np.sqrt(np.maximum(var, 1e-18))
    front = pareto_front_2d(np.asarray(front, np.float64))
    front = front[(front[:, 0] < ref[0]) & (front[:, 1] < ref[1])]

    # Strip edges along objective 1 and staircase heights along objective 2.
    # Strip j spans [e_j, e_{j+1}] with un-dominated headroom below h_j.
    if len(front) == 0:
        edges = np.array([-np.inf, ref[0]])
        heights = np.array([ref[1]])
    else:
        edges = np.concatenate([[-np.inf], front[:, 0], [ref[0]]])
        heights = np.concatenate([[ref[1]], front[:, 1]])

    g1_right = _ramp_expectation(np.minimum(edges[1:], ref[0])[None, :],
                                 mu[:, :1], sd[:, :1])
    g1_left = _ramp_expectation(edges[:-1][None, :], mu[:, :1], sd[:, :1])
    widths = np.maximum(g1_right - g1_left, 0.0)           # (n, strips)
    heights_e = _ramp_expectation(heights[None, :], mu[:, 1:], sd[:, 1:])
    return np.sum(widths * heights_e, axis=1)


# ---------------------------------------------------------------------------
# batched torch path (Pareto masks + EHVI over candidate grids)
# ---------------------------------------------------------------------------

def _ramp_expectation_t(c: torch.Tensor, mu: torch.Tensor,
                        sigma: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`_ramp_expectation` (handles c = -inf)."""
    sigma = torch.clamp(sigma, min=1e-12)
    neg_inf = torch.isneginf(c)
    c_safe = torch.where(neg_inf, 0.0, c)
    z = (c_safe - mu) / sigma
    pdf = torch.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
    out = (c_safe - mu) * torch.special.ndtr(z) + sigma * pdf
    return torch.where(neg_inf, 0.0, out)


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise order sorting by ``primary``, ties by ``secondary``, then by
    position: the reference's ``lexsort((secondary, primary))``."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(primary, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _pareto_mask(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Non-dominated masks of B padded (k, 2) point sets (minimization).

    Matches :func:`pareto_front_2d`: sort by (obj1, obj2), keep a point iff
    its obj2 strictly undercuts every earlier kept point. Invalid (padding)
    rows are pushed to the end and never kept."""
    big = float(np.finfo(np.float32).max / 4)
    x = torch.where(valid, pts[..., 0], big)
    y = torch.where(valid, pts[..., 1], big)
    order = _lexsort2(x, y)
    ys = torch.gather(y, -1, order)
    inf = torch.full_like(ys[:, :1], torch.inf)
    prev_min = torch.cat([inf, torch.cummin(ys, dim=-1).values[:, :-1]], -1)
    keep_sorted = (ys < prev_min - 1e-15) & torch.gather(valid, -1, order)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def _ehvi_kernel(mu: torch.Tensor, sd: torch.Tensor, pts: torch.Tensor,
                 valid: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """EHVI of (B, n, 2) candidates against B padded (k, 2) fronts."""
    r0, r1 = ref[:, 0:1], ref[:, 1:2]
    keep = _pareto_mask(pts, valid) & (pts[..., 0] < r0) & (pts[..., 1] < r1)
    # Park dropped rows at the reference corner: they sort last and span
    # zero-width strips, leaving the staircase intact.
    fx = torch.where(keep, pts[..., 0], r0)
    fy = torch.where(keep, pts[..., 1], r1)
    order = torch.argsort(fx, dim=-1, stable=True)
    fx, fy = torch.gather(fx, -1, order), torch.gather(fy, -1, order)

    edges = torch.cat([torch.full_like(r0, -torch.inf), fx, r0], dim=-1)
    heights = torch.cat([r1, fy], dim=-1)
    g1_right = _ramp_expectation_t(
        torch.minimum(edges[:, 1:], r0)[:, None, :], mu[..., :1], sd[..., :1])
    g1_left = _ramp_expectation_t(edges[:, None, :-1], mu[..., :1],
                                  sd[..., :1])
    widths = torch.clamp(g1_right - g1_left, min=0.0)    # (B, n, strips)
    heights_e = _ramp_expectation_t(heights[:, None, :], mu[..., 1:],
                                    sd[..., 1:])
    return (widths * heights_e).sum(-1)


def _pad_fronts(fronts: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (k_i, 2) fronts into padded points + validity."""
    from .gp_bank import bucket_pow2
    k_max = bucket_pow2(max((len(f) for f in fronts), default=1))
    b = len(fronts)
    pts = np.zeros((b, k_max, 2))
    valid = np.zeros((b, k_max), dtype=bool)
    for i, f in enumerate(fronts):
        f = np.asarray(f, np.float64).reshape(-1, 2)
        pts[i, :len(f)] = f
        valid[i, :len(f)] = True
    return pts, valid


def pareto_front_mask_2d(points: np.ndarray,
                         valid: Optional[np.ndarray] = None,
                         device: str = "cuda") -> np.ndarray:
    """Batched non-dominated masks, one float32 pass on ``device``.

    points: (B, k, 2) minimization objectives; valid: optional (B, k) bool
    marking real rows (padding excluded). Returns a (B, k) bool mask of the
    Pareto-optimal subset per batch row — the set equals
    :func:`pareto_front_2d` row by row.
    """
    dev = resolve_device(device)
    points = np.asarray(points, np.float64)
    if valid is None:
        valid = np.ones(points.shape[:2], dtype=bool)
    return _pareto_mask(torch.as_tensor(points, dtype=_F32, device=dev),
                        torch.as_tensor(np.asarray(valid, bool), device=dev)
                        ).cpu().numpy()


def ehvi_2d_batch(mu: np.ndarray, var: np.ndarray,
                  fronts: Sequence[np.ndarray], refs: np.ndarray,
                  device: str = "cuda") -> np.ndarray:
    """Exact EHVI for B candidate grids against B observed fronts at once.

    mu, var: (B, n, 2) posterior marginals; fronts: sequence of B (k_i, 2)
    observed point sets (reduced to Pareto subsets internally); refs:
    (B, 2) reference points. Returns (B, n), computed in float32 on
    ``device`` — the batched equivalent of calling :func:`ehvi_2d` per row.
    """
    dev = resolve_device(device)
    mu = np.asarray(mu, np.float64)
    var = np.asarray(var, np.float64)
    sd = np.sqrt(np.maximum(var, 1e-18))
    pts, valid = _pad_fronts(list(fronts))
    refs = np.asarray(refs, np.float64).reshape(len(pts), 2)
    f32 = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa: E731
    return _ehvi_kernel(f32(mu), f32(sd), f32(pts),
                        torch.as_tensor(valid, device=dev),
                        f32(refs)).cpu().numpy()


def _ehvi_dispatch(mu: np.ndarray, var: np.ndarray, front: np.ndarray,
                   ref: Tuple[float, float], backend: str,
                   device: str) -> np.ndarray:
    if backend == "torch":
        return ehvi_2d_batch(mu[None], var[None], [front],
                             np.asarray(ref)[None], device=device)[0]
    if backend == "numpy":
        return ehvi_2d(mu, var, front, ref)
    raise ValueError(f"unknown EHVI backend {backend!r}; available: "
                     f"('numpy', 'torch')")


def expected_improvement(mu: np.ndarray, var: np.ndarray, best: float
                         ) -> np.ndarray:
    """Single-objective EI for minimization."""
    return _ramp_expectation(np.asarray(best), np.asarray(mu),
                             np.sqrt(np.maximum(var, 1e-18)))


def prob_feasible(mu: np.ndarray, var: np.ndarray, threshold: float
                  ) -> np.ndarray:
    """P(metric <= threshold) under the Gaussian posterior."""
    sd = np.sqrt(np.maximum(var, 1e-18))
    return stats.norm.cdf((threshold - np.asarray(mu)) / sd)


def select_profiling_batch(
        candidates: np.ndarray,
        post_objectives,            # callable (X) -> ((n,2) mu, (n,2) var)
        post_recovery,              # callable (X) -> ((n,) mu, (n,) var) | None
        observed_front: np.ndarray,
        ref: Tuple[float, float],
        q: int,
        *,
        recovery_constraint: Optional[float] = None,
        exclude: Sequence[int] = (),
        bias: Optional[np.ndarray] = None,
        backend: str = "torch",
        device: str = "cuda",
) -> List[int]:
    """Greedy q-batch maximizing feasibility-weighted EHVI (paper §2.3).

    ``bias`` multiplies the acquisition — the domain-knowledge preference of
    §2.3 (prefer larger configs after a revert, smaller after a downscale).
    Returns indices into ``candidates``.

    ``backend="torch"`` (default) scores the candidate grid through the
    batched :func:`ehvi_2d_batch` on ``device``; ``"numpy"`` keeps the
    float64 scipy oracle.
    """
    mu, var = post_objectives(candidates)
    # Feasibility / bias multipliers are front-independent: compute once and
    # reuse across greedy rounds (every EHVI call scores the full grid).
    mult = np.ones(len(mu))
    if post_recovery is not None and recovery_constraint is not None:
        rmu, rvar = post_recovery(candidates)
        mult = mult * prob_feasible(rmu, rvar, recovery_constraint)
    if bias is not None:
        mult = mult * bias
    score = np.asarray(_ehvi_dispatch(mu, var, observed_front, ref, backend,
                                          device),
                       np.float64) * mult
    dead = np.zeros(len(score), dtype=bool)
    dead[list(exclude)] = True
    score[dead] = -np.inf

    picked: List[int] = []
    front = np.asarray(observed_front, np.float64).reshape(-1, 2).copy()
    for _ in range(q):
        j = int(np.argmax(score))
        if not np.isfinite(score[j]) or score[j] <= 0:
            break
        picked.append(j)
        dead[j] = True
        # Kriging believer: hallucinate the candidate at its posterior mean
        # and re-score the remainder against the augmented front.
        front = np.vstack([front, mu[j]]) if len(front) else mu[j:j + 1]
        if dead.all():
            break
        score = np.asarray(_ehvi_dispatch(mu, var, front, ref, backend, device),
                           np.float64) * mult
        score[dead] = -np.inf
    return picked
