"""Rank-weighted Gaussian Process Ensembles (paper §2.2, eq. 1).

Demeter trains one MOBO model per workload segment, but a fresh segment has
almost no observations — §2.2's answer is RGPE (Feurer et al.): base GPs
trained on *other* segments are combined with the target segment's GP,

    m_tar(x) ~ N( Σ_i a_i μ_i(x) ,  Σ_i a_i² σ_i²(x) ),

where the weights ``a_i`` come from a pairwise ranking loss evaluated on the
target segment's observations. A base model earns weight in proportion to
the fraction of posterior samples in which it misranks the target segment's
configurations *least* — ranking (not regression error) because the
optimizer only consumes the ordering of configurations, and it is invariant
to the level shifts that dominate between workload segments. The target
model itself is scored with leave-one-out posterior samples to avoid
optimistic bias, and weight dilution is prevented by discarding base models
whose sampled loss exceeds the target model's 95th-percentile loss (Feurer
et al., §4.2).

Posterior evaluation is batched: with more than one active member the
ensemble packs every member GP into stacked arrays and predicts all of them
in one batched float32 torch pass on the ensemble's device
(:func:`repro_torch.core.gp_bank.batched_posterior`), so the controller's
full-candidate-grid queries cost one batched pass per metric instead of one
per member. The ranking-loss sampling stays on a NumPy generator, as in the
reference, so both packages draw the same samples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .gp import GP
from .gp_bank import batched_posterior


def _ranking_loss(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Number of misranked pairs per sample. pred: (S, n), target: (n,)."""
    # For all i < j: misranked if (pred_i < pred_j) != (target_i < target_j).
    n = len(target)
    iu, ju = np.triu_indices(n, k=1)
    pd = pred[:, iu] < pred[:, ju]
    td = (target[iu] < target[ju])[None, :]
    return np.sum(pd != td, axis=1).astype(np.float64)


@dataclass
class RGPEnsemble:
    """Weighted GP mixture with the paper's mean/variance combination rule.

    ``device`` is where the batched member posterior runs (see
    :func:`repro_torch.core.gp_bank.batched_posterior`), split over
    ``devices`` of its kind when that is set; a lone active member is
    evaluated by :meth:`GP.posterior` on the host.
    """

    gps: List[GP]
    weights: np.ndarray
    device: str = "cuda"
    devices: Optional[int] = None

    def posterior(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        xq = np.atleast_2d(np.asarray(xq, np.float64))
        active = [(gp, a) for gp, a in zip(self.gps, self.weights) if a > 0.0]
        if not active:
            return np.zeros(len(xq)), np.full(len(xq), 1e-12)
        if len(active) == 1:
            gp, a = active[0]
            m, v = gp.posterior(xq)
            return a * m, np.maximum((a * a) * v, 1e-12)
        # All members in one batched pass, then the paper's mixture rule.
        mus, vars_ = batched_posterior([gp for gp, _ in active], xq,
                                       device=self.device,
                                       devices=self.devices)
        w = np.asarray([a for _, a in active])
        return w @ mus, np.maximum((w * w) @ vars_, 1e-12)

    @property
    def n_members(self) -> int:
        return int(np.sum(self.weights > 0))


def build_rgpe(target_gp: Optional[GP],
               target_x: np.ndarray,
               target_y: np.ndarray,
               base_gps: Sequence[GP],
               *,
               n_samples: int = 256,
               dilution_percentile: float = 95.0,
               seed: int = 0,
               device: str = "cuda",
               devices: Optional[int] = None) -> Optional[RGPEnsemble]:
    """Assemble the RGPE for one (segment, metric).

    Falls back gracefully at the cold-start corner cases:
      * no models at all            -> None (caller reverts to C_max);
      * only a target model         -> ensemble == target GP;
      * no/insufficient target data -> uniform weights over base models.
    """
    base_gps = list(base_gps)
    if target_gp is None and not base_gps:
        return None
    if target_gp is not None and not base_gps:
        return RGPEnsemble([target_gp], np.array([1.0]), device=device,
                           devices=devices)

    n_target = len(target_y)
    if target_gp is None or n_target < 3:
        # Not enough target evidence for ranking: borrow uniformly.
        gps = list(base_gps) + ([target_gp] if target_gp is not None else [])
        w = np.full(len(gps), 1.0 / len(gps))
        return RGPEnsemble(gps, w, device=device, devices=devices)

    # Score on the target GP's own training set (it may lag the segment's
    # live data by a few points when refits are batched).
    target_x = target_gp.x
    target_y = np.asarray(target_gp.train_targets, np.float64)
    rng = np.random.default_rng(seed)

    losses = []  # (n_models+1, S) — target model is the last row
    for gp in base_gps:
        samples = gp.sample(target_x, n_samples, rng)
        losses.append(_ranking_loss(samples, target_y))
    loo = target_gp.loo_samples(n_samples, rng)
    target_loss = _ranking_loss(loo, target_y)
    losses.append(target_loss)
    loss = np.stack(losses)                       # (K+1, S)

    # Weight-dilution guard: a base model is unusable in sample s when its
    # loss exceeds the target model's 95th-percentile loss.
    cut = np.percentile(target_loss, dilution_percentile)
    loss[:-1][loss[:-1] > cut] = np.inf

    # a_i = fraction of samples where model i attains the minimum loss
    # (ties split uniformly among the argmins).
    k1, s = loss.shape
    weights = np.zeros(k1)
    mins = loss.min(axis=0)
    for col in range(s):
        winners = np.flatnonzero(loss[:, col] == mins[col])
        weights[winners] += 1.0 / len(winners)
    weights /= s

    gps = list(base_gps) + [target_gp]
    keep = weights > 1e-3
    if not np.any(keep):  # pragma: no cover
        keep = np.ones_like(weights, bool)
    w = np.where(keep, weights, 0.0)
    w = w / w.sum()
    return RGPEnsemble(gps, w, device=device, devices=devices)
