"""The Demeter controller: profiling + optimization processes (paper §2).

Demeter runs two iterative processes against an executor (the target
system — here one row of the DSP cluster simulation, served through
:class:`~repro_torch.core.executor.ScenarioView`):

* **Profiling** (§2.3): forecast the workload, and if the segment's MOBO
  models cannot yet confidently pick a near-optimal configuration, launch q
  parallel short-lived profiling runs chosen by feasibility-weighted EHVI
  (annealed per segment), measure latency + injected-failure recovery, and
  fold the observations back into the models.
* **Optimizing** (§2.4, Fig. 4): derive the latency constraint LC from
  observed latencies; revert to C_max when the target job is unstable or the
  models know nothing about the predicted rate; otherwise pick the cheapest
  predicted-feasible configuration, guarded by the safety buffer SB and the
  efficiency threshold ET.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .acquisition import ehvi_2d, hypervolume_2d, select_profiling_batch
from .config_space import ConfigSpace
from .executor import EngineConfig, coerce_config, resolve_device
from .forecast import binned_forecast
from .forecast_bank import make_forecaster
from .gp import GP
from .gp_bank import GPBank
from .latency import LatencyConstraint
from .registry import FIT_BACKENDS
from .rgpe import RGPEnsemble, build_rgpe
from .segments import (LATENCY, METRICS, RECOVERY, USAGE, Segment,
                       SegmentStore)


@dataclass
class DemeterHyperParams:
    """Paper §3.2 defaults."""

    segment_size: float = 10_000.0        # SS
    safety_buffer: float = 0.30           # SB
    efficiency_threshold: float = 0.05    # ET
    recovery_constraint_s: float = 180.0  # RC
    forecast_horizon: int = 10            # TSF steps ahead
    forecast_bins: int = 5
    profile_parallelism: int = 2          # max concurrent profiling runs
    profile_anneal: float = 0.5           # q ~ ceil(q0 * anneal^rounds)
    profile_interval_s: float = 1500.0    # profiling process loop delay
    profile_budget_frac: float = 0.15     # max profiling usage vs target job
    max_profile_rounds: int = 8           # hard cap per segment (annealing
                                          # floor is 1, so a cap is needed)
    min_obs_to_optimize: int = 3          # obs needed before trusting a segment
    ehvi_stop_rel: float = 0.01           # stop profiling when EHVI is this
                                          # small relative to the front's HV


def _metric_salt(metric: str) -> int:
    """Stable per-metric seed offset (``hash(str)`` is randomized per
    process; fits must be reproducible across runs)."""
    try:
        return METRICS.index(metric) * 331
    except ValueError:
        return zlib.crc32(metric.encode()) % 997


#: Optimizer budget shared by both fit backends (restarts, L-BFGS iters).
FIT_RESTARTS = 2
FIT_MAX_ITER = 60


#: The registered fit backends share one signature:
#: ``fitter(datasets, seeds, device) -> list[GP]`` where ``datasets`` is a
#: sequence of ``(x, y)`` training pairs, ``seeds`` the per-model restart
#: seeds and ``device`` where a batched fitter places its tensors.

@FIT_BACKENDS.register("scalar")
def _fit_scalar(datasets: Sequence[Tuple[np.ndarray, np.ndarray]],
                seeds: Sequence[int], device: str = "cuda") -> List[GP]:
    """Per-GP scipy L-BFGS-B loop on the host (the reference oracle;
    ``device`` has nothing to act on here)."""
    return [GP.fit(x, y, restarts=FIT_RESTARTS, max_iter=FIT_MAX_ITER, seed=s)
            for (x, y), s in zip(datasets, seeds)]


@FIT_BACKENDS.register("bank")
def _fit_bank(datasets: Sequence[Tuple[np.ndarray, np.ndarray]],
              seeds: Sequence[int], device: str = "cuda") -> List[GP]:
    """Every dataset in one batched GPBank L-BFGS on ``device``."""
    bank = GPBank.fit(list(datasets), restarts=FIT_RESTARTS,
                      max_iter=FIT_MAX_ITER, seeds=list(seeds), device=device)
    return [bank.member(i) for i in range(len(datasets))]


@dataclass
class ModelBank:
    """Per-(segment, metric) GPs + RGPE ensembles with dirty-tracking.

    Two fit backends share one staleness policy and identical restart
    initializations:

    * ``"bank"`` (default) — all stale models are packed into a
      :class:`~repro_torch.core.gp_bank.GPBank` and fitted in one batched
      L-BFGS on ``device``; :meth:`refresh` (one controller) and
      :meth:`batch_refresh` (a whole sweep of controllers) fold every
      pending refit into one batch.
    * ``"scalar"`` — the per-GP scipy L-BFGS-B loop on the host
      (:meth:`repro_torch.core.gp.GP.fit`), kept as the reference oracle.

    ``device`` (``"cuda"`` by default; raises where there is no card) is
    where the bank fitter and the RGPE posteriors place their tensors.

    ``fit_wall_s`` / ``n_fits`` accumulate the wall-clock cost of fits this
    bank triggered *lazily* (via :meth:`gp`); batched refreshes report their
    shared wall time through their return value instead, so sweeps can
    account model-update cost without double counting.
    """

    store: SegmentStore
    min_fit: int = 3
    max_base_models: int = 4
    refit_growth: float = 0.10           # refit when data grew >= 10 %
    fit_backend: str = "bank"            # "bank" | "scalar"
    device: str = "cuda"
    fit_wall_s: float = 0.0
    n_fits: int = 0
    _gps: Dict[Tuple[int, str], Tuple[int, int, Optional[GP]]] = field(
        default_factory=dict)            # key -> (version, n_fit, gp)

    def __post_init__(self) -> None:
        FIT_BACKENDS.validate(self.fit_backend)
        resolve_device(self.device)

    # -- staleness policy ---------------------------------------------------
    def _plan(self, segment: Segment, metric: str):
        """Decide ('cached', gp) | ('fit', (x, y)) | ('empty', None)."""
        key = (segment.index, metric)
        cached = self._gps.get(key)
        if cached is not None and cached[0] == segment.version:
            return "cached", cached[2]
        x, y = segment.data(metric)
        if cached is not None:
            n_fit = cached[1]
            fresh_enough = (len(y) == n_fit
                            or (cached[2] is not None
                                and len(y) < n_fit * (1 + self.refit_growth)))
            if fresh_enough:
                self._gps[key] = (segment.version, n_fit, cached[2])
                return "cached", cached[2]
        if len(y) >= self.min_fit and np.ptp(y) > 0:
            return "fit", (x, y)
        self._gps[key] = (segment.version, len(y), None)
        return "empty", None

    def _seed(self, segment: Segment, metric: str) -> int:
        return segment.index * 131 + _metric_salt(metric)

    def _install(self, segment: Segment, metric: str, n: int,
                 gp: Optional[GP]) -> None:
        self._gps[(segment.index, metric)] = (segment.version, n, gp)

    # -- fitting ------------------------------------------------------------
    def gp(self, segment: Segment, metric: str) -> Optional[GP]:
        """The (possibly cached) GP for one (segment, metric); lazy fit."""
        action, payload = self._plan(segment, metric)
        if action != "fit":
            return payload
        x, y = payload
        t0 = time.perf_counter()
        fitter = FIT_BACKENDS.get(self.fit_backend)
        g = fitter([(x, y)], [self._seed(segment, metric)], self.device)[0]
        self.fit_wall_s += time.perf_counter() - t0
        self.n_fits += 1
        self._install(segment, metric, len(y), g)
        return g

    def stale_fits(self) -> List[Tuple[Segment, str, Tuple]]:
        """All (segment, metric, (x, y)) pairs whose model needs a refit.

        Deliberately covers the *whole* store, not just the current
        segment: every fitted segment is a base-model candidate for
        RGPE's nearest-first transfer walk (:meth:`ensemble` may reach any
        of them when closer segments lack models), the segment count is
        bounded by rate-range / SS, and keeping the scope identical for
        both fit backends keeps model-update cost comparisons
        apples-to-apples.
        """
        out = []
        for _, seg in sorted(self.store.segments.items()):
            for metric in METRICS:
                action, payload = self._plan(seg, metric)
                if action == "fit":
                    out.append((seg, metric, payload))
        return out

    def refresh(self) -> int:
        """Refit every stale (segment, metric) model in one batched fit."""
        n, _wall = ModelBank.batch_refresh([self])
        return n

    @staticmethod
    def batch_refresh(banks: Sequence["ModelBank"]) -> Tuple[int, float]:
        """One model-update step for many controllers.

        Collects every stale (segment, metric) dataset across ``banks`` and
        hands each registered fit backend its whole group in one call (the
        "bank" backend fits its group as one :class:`GPBank` batch; the
        "scalar" oracle loops per GP). Returns
        ``(n_models_fitted, wall_seconds)``.
        """
        t0 = time.perf_counter()
        jobs = []                      # (bank, segment, metric, x, y)
        for bank in banks:
            for seg, metric, (x, y) in bank.stale_fits():
                jobs.append((bank, seg, metric, x, y))
        if not jobs:
            return 0, time.perf_counter() - t0

        # One fitter call per (backend, device) group: banks on different
        # devices must not be merged.
        by_backend: Dict[Tuple[str, str], List] = {}
        for job in jobs:
            key = (job[0].fit_backend, job[0].device)
            by_backend.setdefault(key, []).append(job)
        for (backend, device), group in by_backend.items():
            fitter = FIT_BACKENDS.get(backend)
            gps = fitter([(x, y) for _, _, _, x, y in group],
                         [b._seed(seg, metric)
                          for b, seg, metric, _, _ in group], device)
            for (b, seg, metric, _x, y), g in zip(group, gps):
                b._install(seg, metric, len(y), g)
        return len(jobs), time.perf_counter() - t0

    # -- ensembles ----------------------------------------------------------
    def ensemble(self, segment: Segment, metric: str) -> Optional[RGPEnsemble]:
        target_gp = self.gp(segment, metric)
        tx, ty = segment.data(metric)
        others = self.store.others(segment)
        # Nearest segments first — behaviour transfers locally in rate.
        others.sort(key=lambda s: abs(s.index - segment.index))
        base = []
        for seg in others:
            g = self.gp(seg, metric)
            if g is not None:
                base.append(g)
            if len(base) >= self.max_base_models:
                break
        return build_rgpe(target_gp, tx, ty, base,
                          seed=segment.index * 7919 + _metric_salt(metric),
                          device=self.device)


@dataclass
class DemeterController:
    """Binds the two processes to an executor + a configuration space.

    Backend selection (GP fit path, TSF path) and the device come from one
    :class:`~repro_torch.core.executor.EngineConfig` passed as ``config=``;
    ``None`` is ``EngineConfig()``, whose device is the card (it raises
    where there is no card: pass ``EngineConfig(device="cpu")``). The old
    string kwargs ``fit_backend=`` and ``forecast_backend=`` still work as
    deprecation shims and fold into the config.
    """

    space: ConfigSpace
    executor: object
    #: hyper-parameters; ``None`` resolves to ``config.hp`` (or §3.2 defaults)
    hp: Optional[DemeterHyperParams] = None
    #: TSF workload forecaster. ``None`` builds one from ``forecaster`` /
    #: ``config.forecast_backend``; a sweep engine passes a shared
    #: :class:`~repro_torch.core.forecast_bank.BankedForecaster` view
    #: instead so all scenarios' streams advance in one batched update.
    tsf: Optional[object] = None
    lc: LatencyConstraint = field(default_factory=LatencyConstraint)
    #: .. deprecated:: use ``config=EngineConfig(fit_backend=...)``.
    fit_backend: Optional[str] = None
    #: TSF forecaster kind (see :data:`repro_torch.core.registry.FORECASTERS`).
    forecaster: str = "arima"
    #: .. deprecated:: use ``config=EngineConfig(forecast_backend=...)``.
    forecast_backend: Optional[str] = None
    #: the control-plane configuration (backends + hp + device)
    config: Optional[EngineConfig] = None
    store: SegmentStore = field(init=False)
    bank: ModelBank = field(init=False)
    #: event log for experiments: (kind, payload) tuples
    events: List[Tuple[str, Dict]] = field(default_factory=list)
    n_reconfigurations: int = 0
    profile_cost: float = 0.0
    #: wall-clock spent in the TSF forecaster (updates + rollout reads);
    #: sweeps aggregate this into ``SweepResult.forecast_update_wall_s``
    tsf_wall_s: float = 0.0
    #: precomputed ``allocated_cost`` over ``space.enumerate()`` (the cost
    #: vector only depends on the space and the executor's cost model)
    alloc: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.config = config = coerce_config(
            self.config, fit_backend=self.fit_backend,
            forecast_backend=self.forecast_backend, hp=self.hp)
        # The resolved backend names stay readable as plain attributes.
        self.fit_backend = config.fit_backend
        self.forecast_backend = config.forecast_backend
        resolve_device(config.device)
        self.hp = config.resolved_hp()
        if self.tsf is None:
            self.tsf = make_forecaster(self.forecaster,
                                       backend=config.forecast_backend,
                                       horizon=self.hp.forecast_horizon,
                                       device=config.device)
        self.store = SegmentStore(self.hp.segment_size)
        self.bank = ModelBank(self.store, fit_backend=config.fit_backend,
                              device=config.device)
        self._candidates = self.space.matrix()
        self._configs = self.space.enumerate()
        if self.alloc is not None:
            if len(self.alloc) != len(self._configs):
                raise ValueError(
                    f"alloc has {len(self.alloc)} entries for a space of "
                    f"{len(self._configs)} configs")
            self._alloc = np.asarray(self.alloc, float)
        else:
            self._alloc = np.asarray(
                [self.executor.allocated_cost(c) for c in self._configs])

    # ------------------------------------------------------------------
    # shared plumbing
    # ------------------------------------------------------------------
    def ingest(self, metrics: Mapping[str, float]) -> None:
        """Feed target-job telemetry (call every metrics interval)."""
        if "rate" in metrics:
            t0 = time.perf_counter()
            self.tsf.update(metrics["rate"])
            self.tsf_wall_s += time.perf_counter() - t0
        if "latency" in metrics:
            self.lc.observe(metrics["latency"])

    def predicted_rate(self) -> float:
        t0 = time.perf_counter()
        out = binned_forecast(self.tsf, self.hp.forecast_horizon,
                              self.hp.forecast_bins)
        self.tsf_wall_s += time.perf_counter() - t0
        return out

    def _posteriors(self, segment: Segment, metric: str):
        ens = self.bank.ensemble(segment, metric)
        if ens is None:
            return None
        return lambda xq: ens.posterior(xq)

    def _objective_posterior(self, segment: Segment):
        pu = self._posteriors(segment, USAGE)
        pl = self._posteriors(segment, LATENCY)
        if pu is None or pl is None:
            return None

        def post(xq):
            mu_u, var_u = pu(xq)
            mu_l, var_l = pl(xq)
            return np.stack([mu_u, mu_l], 1), np.stack([var_u, var_l], 1)

        return post

    def _front_and_ref(self, segment: Segment):
        pts = np.asarray([[o.metrics[USAGE], o.metrics[LATENCY]]
                          for o in segment.observations
                          if USAGE in o.metrics and LATENCY in o.metrics and
                          np.isfinite(o.metrics[USAGE]) and
                          np.isfinite(o.metrics[LATENCY])])
        if len(pts) == 0:
            return np.zeros((0, 2)), (1.0, 1.0)
        ref = (float(pts[:, 0].max()) * 1.2 + 1e-9,
               float(pts[:, 1].max()) * 1.2 + 1e-9)
        return pts, ref

    # ------------------------------------------------------------------
    # process 1: profiling (paper §2.3)
    # ------------------------------------------------------------------
    def profiling_step(self) -> List[Dict[str, float]]:
        rate = self.predicted_rate()
        if rate <= 0:
            return []
        segment = self.store.segment_for(rate)

        q = self._annealed_q(segment)
        if q < 1:
            return []

        picked_cfgs = self._select_profiles(segment, rate, q)
        if not picked_cfgs:
            return []

        results = self.executor.profile(picked_cfgs, rate)
        ran: List[Dict[str, float]] = []
        for cfg, res in zip(picked_cfgs, results):
            if res is None:
                continue
            x = self.space.encode(cfg)
            self.store.record(cfg, x, rate, res)
            self.profile_cost += self.executor.allocated_cost(cfg)
            ran.append(cfg)
        segment.profile_rounds += 1
        self.events.append(("profile", {"rate": rate, "configs": ran}))
        return ran

    def _annealed_q(self, segment: Segment) -> int:
        if segment.profile_rounds >= self.hp.max_profile_rounds:
            return 0
        q0 = self.hp.profile_parallelism
        q = int(np.ceil(q0 * self.hp.profile_anneal ** segment.profile_rounds))
        return min(q, q0)

    def _select_profiles(self, segment: Segment, rate: float, q: int
                         ) -> List[Dict[str, float]]:
        n = len(self._configs)
        tried = {self.space.index(o.config) for o in segment.observations}

        post = self._objective_posterior(segment)
        if post is None:
            # Cold start: seed along the allocation axis (cheap, median,
            # C_max-adjacent) so the first GPs see contrast; rotate the
            # spread each round so repeated cold-start rounds add new data.
            untried = [i for i in range(n) if i not in tried]
            if not untried:
                return []
            order = sorted(untried, key=lambda i: self._alloc[i])
            offset = (segment.profile_rounds * 0.37) % 1.0
            fracs = [(f + offset) % 1.0 for f in np.linspace(0.15, 0.95, q)]
            seeds = dict.fromkeys(order[int(f * (len(order) - 1))]
                                  for f in fracs)
            return [self._configs[i] for i in seeds]

        front, ref = self._front_and_ref(segment)
        # Knowledge saturation check: residual EHVI small vs front HV.
        pr = self._posteriors(segment, RECOVERY)
        bias = self._domain_bias(segment, rate)
        idx = select_profiling_batch(
            self._candidates, post, pr, front, ref, q,
            recovery_constraint=self.hp.recovery_constraint_s,
            exclude=list(tried), bias=bias, device=self.config.device)
        if not idx:
            return []
        mu, var = post(self._candidates[idx])
        hv = max(hypervolume_2d(front, ref), 1e-12)
        best = float(ehvi_2d(mu[:1], var[:1], front, ref)[0])
        if best / hv < self.hp.ehvi_stop_rel:
            return []  # models are confident enough — skip profiling
        return [self._configs[i] for i in idx]

    def _domain_bias(self, segment: Segment, rate: float
                     ) -> Optional[np.ndarray]:
        """Paper §2.3 domain knowledge: after a revert at a similar rate,
        prefer configurations with *more* resources than the failed one;
        after a downscale, prefer *fewer*."""
        reverted = [o for o in segment.observations if o.reverted]
        downs = [o for o in segment.observations if o.downscaled]
        if not reverted and not downs:
            return None
        bias = np.ones(len(self._configs))
        for o in reverted:
            cut = self.executor.allocated_cost(o.config)
            bias *= np.where(self._alloc > cut, 1.0, 0.2)
        if not reverted:
            for o in downs:
                cut = self.executor.allocated_cost(o.config)
                bias *= np.where(self._alloc <= cut, 1.0, 0.5)
        return bias

    # ------------------------------------------------------------------
    # process 2: optimizing (paper §2.4, Fig. 4)
    # ------------------------------------------------------------------
    def optimization_step(self, metrics: Optional[Mapping[str, float]] = None
                          ) -> Optional[Dict[str, float]]:
        """One optimizing-process iteration (paper §2.4, Fig. 4).

        ``metrics`` lets a batched harness (the sweep engine) push telemetry
        it already holds instead of the controller pulling via
        ``executor.observe()`` — the only executor round-trip on this path.
        """
        if metrics is None:
            metrics = self.executor.observe()
        current = self.executor.current_config()
        cmax = self.executor.cmax_config()
        lavg = metrics.get("latency", float("nan"))

        # Unstable target job -> C_max, and remember the config was unfit.
        if np.isfinite(lavg) and not self.lc.is_normal(lavg):
            self._mark(current, metrics, reverted=True)
            if current != cmax:
                self._apply(cmax, reason="latency-violation")
                return cmax
            return None

        rate = self.predicted_rate()
        segment = self.store.segment_for(rate)
        if len(segment) < self.hp.min_obs_to_optimize:
            if current != cmax:
                self._apply(cmax, reason="unknown-workload")
                return cmax
            return None

        choice = self._pick_config(segment)
        if choice is None:
            if current != cmax:
                self._apply(cmax, reason="no-feasible-config")
                return cmax
            return None

        cfg, predicted_usage = choice
        # Baseline side of the ET check: the *observed* usage of the running
        # configuration (we are measuring it continuously); fall back to the
        # model prediction when telemetry is missing.
        cur_usage = metrics.get("usage", float("nan"))
        if not np.isfinite(cur_usage):
            cur_usage = self._predicted_usage(segment, current)
        if cfg == current or cur_usage is None:
            return None
        saving = (cur_usage - predicted_usage) / max(cur_usage, 1e-12)
        if saving >= self.hp.efficiency_threshold:
            self._mark(current, metrics, downscaled=True)
            self._apply(cfg, reason=f"efficiency+{saving:.2%}")
            return cfg
        return None

    def _pick_config(self, segment: Segment
                     ) -> Optional[Tuple[Dict[str, float], float]]:
        post = self._objective_posterior(segment)
        pr = self._posteriors(segment, RECOVERY)
        lc = self.lc.constraint()
        if post is None or lc is None:
            return None
        mu, _var = post(self._candidates)
        feasible = mu[:, 1] < lc
        if pr is not None:
            rmu, _rvar = pr(self._candidates)
            feasible &= rmu <= self.hp.recovery_constraint_s
        idx = np.flatnonzero(feasible)
        if len(idx) == 0:
            return None
        # Sort by predicted usage; apply the safety buffer percentile skip.
        order = idx[np.argsort(mu[idx, 0])]
        k = min(int(np.floor(self.hp.safety_buffer * len(order))),
                len(order) - 1)
        j = int(order[k])
        return self._configs[j], float(mu[j, 0])

    def _predicted_usage(self, segment: Segment,
                         config: Mapping[str, float]) -> Optional[float]:
        post = self._posteriors(segment, USAGE)
        if post is None:
            return None
        mu, _ = post(self.space.encode(config)[None, :])
        return float(mu[0])

    # ------------------------------------------------------------------
    def _apply(self, cfg: Dict[str, float], *, reason: str) -> None:
        self.executor.reconfigure(cfg)
        self.n_reconfigurations += 1
        self.events.append(("reconfigure", {"config": dict(cfg),
                                            "reason": reason}))

    def _mark(self, config: Mapping[str, float], metrics: Mapping[str, float],
              **flags) -> None:
        """Record a target-job outcome observation with domain-knowledge flags."""
        rate = metrics.get("rate")
        if rate is None or not np.isfinite(rate):
            return
        obs_metrics = {}
        if np.isfinite(metrics.get("usage", float("nan"))):
            obs_metrics[USAGE] = float(metrics["usage"])
        if np.isfinite(metrics.get("latency", float("nan"))):
            obs_metrics[LATENCY] = float(metrics["latency"])
        try:
            x = self.space.encode(config)
        except ValueError:
            return
        self.store.record(config, x, float(rate), obs_metrics, **flags)
