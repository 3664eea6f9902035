"""The fused sweep engine: whole decision intervals on the device.

The sweep's event loop is sparse — failures fire every tens of minutes,
policies act every decision interval — while the simulator ticks every
5 s. The engine registered as ``"fused"`` therefore takes a whole
host-quiet run of K ticks (everything between two scheduled events) in one
:meth:`FusedSweepExecutor.step_interval` call: the host precomputes the
interval's clocks and RNG draws as ``[K, S]`` planes, copies them to the
device once, and :func:`fused_interval_scan` advances the device state
through the K ticks in one call of
:func:`repro_torch.kernels.ops.fused_interval`: on the card one launch of
the CUDA interval kernel, on the CPU its plain version, which runs each
tick as :func:`~repro_torch.dsp.simulator.step_batch_arrays` for the
metrics and the fused tick for the lag carry and the anomaly detector — an
AR(1)+bias RLS predictor on ``log1p(consumer_lag)`` whose trigger flags
accumulate into :attr:`FusedSweepExecutor.anomaly_triggers`. The detector
feeds nothing back into the simulation, so the engine's results equal the
``"batched"`` engine's.

What stays on the host, vectorized NumPy: the downtime/checkpoint clocks
and the per-row RNG streams. Their draws must stay bit-identical to the
``"batched"`` engine's (``BatchedNormals`` order: z1 for all rows, then the
masked ``|z2|``), so they are precomputed for the interval. The consumer
lag and the detector state are the persistent device tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.registry import SIM_ENGINES
from ..kernels import ops
from ..kernels.ref import METRIC_KEYS
from .executor import SweepExecutorBase
from .simulator import BatchedNormals, BatchState, ClusterModel, JobConfig

#: AR order of the on-device detector: bias + previous log-lag sample.
DET_ORDER = 2
#: RLS forgetting factor / trigger threshold of the on-device detector.
DET_LAMBDA = 0.995
DET_THRESH = 3.0


def fused_interval_scan(model: ClusterModel, lag: torch.Tensor,
                        det_w: torch.Tensor, det_p: torch.Tensor,
                        det_y: torch.Tensor, det_trig: torch.Tensor,
                        rates: torch.Tensor, lag_add: torch.Tensor,
                        down_pre: torch.Tensor, down_post: torch.Tensor,
                        z1: torch.Tensor, z2: torch.Tensor,
                        workers: torch.Tensor, cpu_cores: torch.Tensor,
                        memory_mb: torch.Tensor, task_slots: torch.Tensor,
                        cap_base: torch.Tensor, det_lam: float,
                        det_thresh: float, dt: float) -> torch.Tensor:
    """Advance the device state through one decision interval.

    ``lag [S]``, ``det_w [S, k]``, ``det_p [S, k, k]``, ``det_y [S]`` and
    ``det_trig [S]`` are the persistent state and are updated in place
    (the port's stand-in for the reference's donated scan carry). The
    ``[K, S]`` planes ``rates``/``lag_add``/``down_pre``/``down_post``/
    ``z1``/``z2`` are the host-precomputed control state of the K ticks.

    Returns the :func:`~repro_torch.dsp.simulator.step_batch_arrays`
    metrics stacked to ``[len(METRIC_KEYS), K, S]``.

    One call of :func:`repro_torch.kernels.ops.fused_interval` runs exactly
    the K real ticks: one kernel launch on the card. The reference pads K
    to a power-of-two multiple of a chunk and masks the padding ticks,
    because each distinct K retraces its jitted scan; PyTorch runs eagerly
    and the kernel takes K at run time, so neither the padding nor the
    mask exists here.
    """
    return ops.fused_interval(
        model, lag, det_w, det_p, det_y, det_trig, rates, lag_add, down_pre,
        down_post, z1, z2, workers, cpu_cores, memory_mb, task_slots,
        cap_base, det_lam, det_thresh, dt)


@SIM_ENGINES.register("fused")
class FusedSweepExecutor(SweepExecutorBase):
    """Sweep executor advancing whole decision intervals per call.

    The sweep engine hands :meth:`step_interval` K ticks of rates plus a
    ``[K, S]`` failure-injection schedule; the host precomputes the
    clock/RNG planes and :func:`fused_interval_scan` advances the device
    state. :meth:`step` stays available as a one-tick interval.

    The tensors live on ``EngineConfig.device`` (``"cuda"`` by default); a
    CUDA device that is not there raises instead of falling back.
    """

    #: the sweep engine drives interval stepping when this is True
    supports_intervals = True

    def __init__(self, model: ClusterModel, configs: Sequence[JobConfig],
                 seeds: Sequence[int], **kwargs):
        super().__init__(model, configs, seeds, **kwargs)
        n = len(configs)
        self.state = BatchState.from_configs(configs)
        self.rngs = BatchedNormals(self.seeds)
        self._cap_base = model.capacity_batch(self.state)
        self._cfg_cache = list(configs)
        #: rollback lag staged by inject_failure between intervals, folded
        #: into the first tick of the next interval
        self._lag_add = np.zeros(n)

        f64 = dict(dtype=torch.float64, device=self.device)
        self._lag = torch.zeros(n, **f64)
        # detector state: AR(1)+bias RLS on log1p(lag) per scenario
        self._det_w = torch.zeros((n, DET_ORDER), **f64)
        self._det_p = (10.0 * torch.eye(DET_ORDER, **f64)).repeat(n, 1, 1)
        self._det_y = torch.zeros(n, **f64)
        self._det_trig = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._dev_cfg: Optional[tuple] = None     # rebuilt when configs move
        #: step_interval calls: one fused_interval call (a launch on the
        #: card) each
        self.intervals_stepped = 0

    # -- device plumbing ----------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        mirror keeps mutating its arrays)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            copy=True)

    def _device_configs(self) -> tuple:
        """Config-derived ``[S]`` operands, copied to the device again after
        every reconfiguration (configs change per decision, not per tick)."""
        if self._dev_cfg is None:
            st = self.state
            self._dev_cfg = tuple(
                self._to_device(a) for a in (st.workers, st.cpu_cores,
                                             st.memory_mb, st.task_slots,
                                             self._cap_base))
        return self._dev_cfg

    def device_state(self) -> Dict[str, torch.Tensor]:
        """The persistent device tensors (live, not copies)."""
        return {"lag": self._lag, "det_w": self._det_w, "det_p": self._det_p,
                "det_y": self._det_y, "det_trig": self._det_trig}

    def load_device_state(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Overwrite the persistent device tensors in place (see
        :func:`repro_torch.interop.fused_state_from_arrays`); the host
        mirror's lag follows."""
        for name, buf in self.device_state().items():
            src = tensors[name]
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(
                    f"{name}: expected {tuple(buf.shape)} {buf.dtype}, got "
                    f"{tuple(src.shape)} {src.dtype}")
            buf.copy_(src)
        self.state.from_device(self._lag)

    # -- interval stepping ---------------------------------------------------
    def step_interval(self, rates_ks: np.ndarray,
                      inject_ks: Optional[np.ndarray] = None
                      ) -> Dict[str, np.ndarray]:
        """Advance every scenario through K ticks in one device pass.

        ``rates_ks`` is ``[K, S]``; ``inject_ks`` (optional ``[K, S]`` bool)
        marks failures to inject *after* tick k — where the per-tick driver
        calls ``inject_failure`` — with the rollback lag staged into tick
        k+1's ``lag_add`` plane (or carried into the next interval when k
        is the last tick). Records telemetry history for all K columns and
        returns the metric dict as ``[K, S]`` arrays.
        """
        rates_ks = np.asarray(rates_ks, float)
        K, S = rates_ks.shape
        if S != len(self.seeds):
            raise ValueError(f"expected {len(self.seeds)} scenario columns, "
                             f"got {S}")
        st = self.state
        dt = self.dt

        dpre = np.zeros((K, S), bool)
        dpost = np.zeros((K, S), bool)
        z1 = np.zeros((K, S))
        z2 = np.zeros((K, S))
        lag_add = np.zeros((K, S))
        lag_add[0] = self._lag_add
        self._lag_add = np.zeros(S)

        # Host half, precomputed for the whole interval: downtime/checkpoint
        # clocks + RNG draws in the exact batched order (z1 all rows, then
        # masked |z2|), with tick-k injections applied between tick k and
        # tick k+1 — the per-tick engines' sequencing.
        for k in range(K):
            down_pre = st.downtime_left_s > 0.0
            st.downtime_left_s = np.where(
                down_pre, np.maximum(st.downtime_left_s - dt, 0.0),
                st.downtime_left_s)
            since = np.where(down_pre, st.since_checkpoint_s,
                             st.since_checkpoint_s + dt)
            since = np.where(~down_pre & (since >= st.checkpoint_interval_s),
                             0.0, since)
            st.since_checkpoint_s = since
            down_post = st.downtime_left_s > 0.0
            dpre[k] = down_pre
            dpost[k] = down_post
            z1[k] = self.rngs.draw()
            z2[k] = np.abs(self.rngs.draw(~down_post))
            st.last_rate = rates_ks[k]
            if inject_ks is not None and inject_ks[k].any():
                stage = lag_add[k + 1] if k + 1 < K else self._lag_add
                for j in np.nonzero(inject_ks[k])[0]:
                    self._stage_failure(int(j), stage)

        planes = [self._to_device(a)
                  for a in (rates_ks, lag_add, dpre, dpost, z1, z2)]
        ms = fused_interval_scan(
            self.model, self._lag, self._det_w, self._det_p, self._det_y,
            self._det_trig, *planes, *self._device_configs(), DET_LAMBDA,
            DET_THRESH, dt)
        self.intervals_stepped += 1
        st.from_device(self._lag)
        out = dict(zip(METRIC_KEYS, ms.cpu().numpy()))

        i0 = self.step_index + 1
        for key in self.hist:
            self.hist[key][:, i0:i0 + K] = out[key].T
        # configs only change at interval boundaries -> constant workers
        self.workers_hist[:, i0:i0 + K] = st.workers[:, None]
        self.step_index += K
        return out

    @property
    def anomaly_triggers(self) -> np.ndarray:
        """Per-scenario count of detector trigger flags (auxiliary
        telemetry; feeds nothing back into results)."""
        return self._det_trig.cpu().numpy()

    # -- SweepExecutorBase stepping hooks -----------------------------------
    def step(self, rates: np.ndarray) -> Dict[str, np.ndarray]:
        """Tick-at-a-time stepping = a one-tick interval (history recording
        included, so the base-class bookkeeping is not repeated here)."""
        m = self.step_interval(np.asarray(rates, float)[None, :])
        return {k: v[0] for k, v in m.items()}

    def _stage_failure(self, idx: int, stage: np.ndarray) -> None:
        """:meth:`ClusterModel.inject_failure_batch` with the rollback lag
        staged into ``stage`` (a later tick's lag_add plane, or the
        cross-interval carry) instead of added to the device buffer."""
        st = self.state
        state_mb = self.model.state_size_mb(float(st.last_rate[idx]))
        restore = state_mb / (self.model.restore_mb_per_s
                              * max(float(st.workers[idx]), 1.0))
        st.downtime_left_s[idx] = self.model.failure_detect_s \
            + self.model.redeploy_s + restore
        stage[idx] += st.last_rate[idx] * st.since_checkpoint_s[idx]
        st.since_checkpoint_s[idx] = 0.0

    def inject_failure(self, idx: int) -> None:
        self._stage_failure(idx, self._lag_add)

    def _reconfigure_impl(self, idx: int, cfg: JobConfig,
                          restart_s: Optional[float]) -> bool:
        if self._cfg_cache[idx] == cfg:
            return False
        st = self.state
        st.set_config(idx, cfg)
        st.downtime_left_s[idx] = max(
            float(st.downtime_left_s[idx]),
            self.model.reconfig_restart_s if restart_s is None else restart_s)
        st.since_checkpoint_s[idx] = 0.0
        self._cap_base[idx] = self.model.capacity(cfg)
        self._cfg_cache[idx] = cfg
        self._dev_cfg = None
        return True

    def config_of(self, idx: int) -> JobConfig:
        return self._cfg_cache[idx]

    def workers(self) -> np.ndarray:
        return self.state.workers

    def caught_up(self) -> np.ndarray:
        return self.state.caught_up
