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

The engine always lays its rows over a ``scenario`` mesh
(:func:`repro_torch.distributed.mesh.scenario_mesh`; ``devices=None`` is
every visible device of ``EngineConfig.device``'s kind): the rows are
padded to the mesh width with C_max rows, as the sharded engine pads them,
and split into contiguous partitions, each with its own state tensors on
its device and one :func:`~repro_torch.kernels.ops.fused_interval` call
per interval. Every per-tick operation is elementwise over rows, so the
partitions never communicate; with one device there is one partition.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.registry import SIM_ENGINES
from ..kernels import fused_tick as _k2
from ..kernels import ops
from ..kernels.ref import METRIC_KEYS
from .executor import ScenarioMeshExecutorBase
from .simulator import ClusterModel, JobConfig

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
class FusedSweepExecutor(ScenarioMeshExecutorBase):
    """Sweep executor advancing whole decision intervals per call.

    The sweep engine hands :meth:`step_interval` K ticks of rates plus a
    ``[K, S]`` failure-injection schedule; the host precomputes the
    clock/RNG planes and :func:`fused_interval_scan` advances the device
    state. :meth:`step` stays available as a one-tick interval.

    The tensors live on ``EngineConfig.device`` (``"cuda"`` by default),
    one partition per device of the scenario mesh; a CUDA device that is
    not there raises instead of falling back.
    """

    #: the sweep engine drives interval stepping when this is True
    supports_intervals = True

    def __init__(self, model: ClusterModel, configs: Sequence[JobConfig],
                 seeds: Sequence[int], **kwargs):
        super().__init__(model, configs, seeds, **kwargs)
        # each partition's persistent state on its device: the lag and the
        # detector's AR(1)+bias RLS on log1p(lag)
        self._parts: List[Dict[str, torch.Tensor]] = []
        for rows, dev in zip(self.partitions, self.mesh):
            f64 = dict(dtype=torch.float64, device=dev)
            m = len(rows)
            self._parts.append({
                "lag": torch.zeros(m, **f64),
                "det_w": torch.zeros((m, DET_ORDER), **f64),
                "det_p": (10.0 * torch.eye(DET_ORDER, **f64)).repeat(m, 1, 1),
                "det_y": torch.zeros(m, **f64),
                "det_trig": torch.zeros(m, dtype=torch.int64, device=dev)})
        #: step_interval calls; each makes one fused_interval call (a launch
        #: on the card) per partition
        self.intervals_stepped = 0

    # -- device plumbing ----------------------------------------------------
    def device_state(self) -> Dict[str, torch.Tensor]:
        """The persistent device tensors of every row: the live tensors
        with one partition, else copies gathered on the first device."""
        if len(self._parts) == 1:
            return dict(self._parts[0])
        first = self.mesh[0]
        return {k: torch.cat([p[k].to(first) for p in self._parts])
                for k in self._parts[0]}

    def load_device_state(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Overwrite the persistent device tensors in place (see
        :func:`repro_torch.interop.fused_state_from_arrays`; one row per
        padded row, split over the partitions); the host mirror's lag
        follows."""
        for name in self._parts[0]:
            src = tensors[name]
            want = (self.n_rows, *self._parts[0][name].shape[1:])
            dtype = self._parts[0][name].dtype
            if tuple(src.shape) != want or src.dtype != dtype:
                raise ValueError(
                    f"{name}: expected {want} {dtype}, got "
                    f"{tuple(src.shape)} {src.dtype}")
            for rows, part in zip(self.partitions, self._parts):
                part[name].copy_(src[rows.start:rows.stop])
        self._adopt_lag()

    def _adopt_lag(self) -> None:
        """The partitions' lags into the host mirror (a host copy)."""
        if len(self._parts) == 1:
            self.state.from_device(self._parts[0]["lag"])
        else:
            self.state.lag_events = np.concatenate(
                [p["lag"].cpu().numpy() for p in self._parts])

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
        n = self.n_rows

        R = np.zeros((K, n))
        R[:, :S] = rates_ks
        dpre = np.zeros((K, n), bool)
        dpost = np.zeros((K, n), bool)
        z1 = np.zeros((K, n))
        z2 = np.zeros((K, n))
        lag_add = np.zeros((K, n))
        lag_add[0] = self._lag_add
        self._lag_add = np.zeros(n)

        # Host half, precomputed for the whole interval: downtime/checkpoint
        # clocks + RNG draws in the exact batched order (z1 all rows, then
        # masked |z2|), with tick-k injections applied between tick k and
        # tick k+1 — the per-tick engines' sequencing.
        for k in range(K):
            dpre[k], dpost[k], z1[k], z2[k] = self._host_tick(dt)
            st.last_rate = R[k]
            if inject_ks is not None and inject_ks[k].any():
                stage = lag_add[k + 1] if k + 1 < K else self._lag_add
                for j in np.nonzero(inject_ks[k])[0]:
                    self._stage_failure(int(j), stage)

        host = (R, lag_add, dpre, dpost, z1, z2)
        with obs.timed_phase("simulate", "engine.fused.interval",
                             K=K, Kp=K, scenarios=S):
            # one fused_interval call per partition, each on its device;
            # every launch is issued before any result is read back
            planes = list(zip(*(self._to_partitions(a) for a in host)))
            cfg = self._device_configs()
            ms = [fused_interval_scan(
                      self.model, part["lag"], part["det_w"], part["det_p"],
                      part["det_y"], part["det_trig"], *planes[p], *cfg[p],
                      DET_LAMBDA, DET_THRESH, dt)
                  for p, part in enumerate(self._parts)]
        self.intervals_stepped += 1
        self._adopt_lag()
        ms = np.concatenate([m.cpu().numpy() for m in ms], axis=2)
        out = {key: ms[i, :, :S] for i, key in enumerate(METRIC_KEYS)}
        if obs.enabled():
            obs.inc("sweep.intervals")
            obs.inc("sweep.ticks", K)
            obs.inc("sweep.scenario_ticks", K * S)
            obs.inc("transfer.h2d_bytes", sum(a.nbytes for a in host))
            obs.inc("transfer.d2h_bytes", ms.nbytes + st.lag_events.nbytes)
            obs.track_kernel_loads("fused_scan",
                                   obs.kernel_libs_loaded(("fused_tick",)))
            obs.track_launches(_k2.fused_interval)

        i0 = self.step_index + 1
        for key in self.hist:
            self.hist[key][:, i0:i0 + K] = out[key].T
        # configs only change at interval boundaries -> constant workers
        self.workers_hist[:, i0:i0 + K] = st.workers[:S, None]
        self.step_index += K
        return out

    @property
    def anomaly_triggers(self) -> np.ndarray:
        """Per-scenario count of detector trigger flags (auxiliary
        telemetry; feeds nothing back into results)."""
        return np.concatenate([p["det_trig"].cpu().numpy()
                               for p in self._parts])[:len(self.seeds)]

    # -- SweepExecutorBase stepping hooks -----------------------------------
    def step(self, rates: np.ndarray) -> Dict[str, np.ndarray]:
        """Tick-at-a-time stepping = a one-tick interval (history recording
        included, so the base-class bookkeeping is not repeated here)."""
        m = self.step_interval(np.asarray(rates, float)[None, :])
        return {k: v[0] for k, v in m.items()}


# ---------------------------------------------------------------------------
# contracts (see repro_torch.analysis)
# ---------------------------------------------------------------------------

def _fused_interval_contract():
    from ..analysis.contracts import COLLECTIVE_OPS, CompilationContract
    return CompilationContract(
        name="engine:fused",
        # Elementwise over the scenario axis tick by tick: the partitions
        # never communicate.
        forbidden_ops=COLLECTIVE_OPS,
        # The whole interval is one K2 launch; the per-tick kernel is not
        # on the path.
        launches={"fused_interval": 1, "fused_tick": 0},
        # The lag and the detector state are the persistent device tensors
        # and are updated in place (the reference's donated carry). The
        # trigger counter moves only when a trigger fires.
        in_place=("lag", "det_w", "det_p", "det_y"),
        # float64 is deliberate: the interval mirrors the float64 NumPy
        # engine.
        dtype_ceiling="float64",
        max_ops=8,
        # A host read inside the interval would wake the host per call —
        # the failure mode this engine exists to remove.
        forbid_host_sync=True,
        # K2 takes K and S at run time: one library for every interval
        # shape.
        max_loads=1,
        graph_capturable=True,
        note="whole-interval K2 call: one launch, no collective, state "
             "updated in place, no host sync, one library load for every "
             "shape, replayable from a CUDA graph")


FUSED_INTERVAL_CONTRACT = _fused_interval_contract()


def interval_arg_sets(device: str = "cpu",
                      shapes: Sequence[Tuple[int, int]] = ((2, 5), (2, 12),
                                                          (3, 8), (3, 16))
                      ) -> List[tuple]:
    """A workload of ``(S, K)`` interval shapes as ``(args, kwargs)`` sets
    for :func:`fused_interval_scan` on ``device`` (the ``max_loads``
    budget: one library load for all of them)."""
    model = ClusterModel()
    f64 = dict(dtype=torch.float64, device=device)
    sets = []
    for S, K in shapes:
        plane = torch.zeros((K, S), **f64)
        flags = torch.zeros((K, S), dtype=torch.bool, device=device)
        rows = torch.ones(S, **f64)
        args = (model, torch.zeros(S, **f64),
                torch.zeros((S, DET_ORDER), **f64),
                torch.eye(DET_ORDER, **f64).repeat(S, 1, 1),
                torch.zeros(S, **f64),
                torch.zeros(S, dtype=torch.int64, device=device),
                plane + 5e4, plane, flags, flags, plane, plane, rows * 4.0,
                rows, rows * 4096.0, rows, rows * 40_000.0, DET_LAMBDA,
                DET_THRESH, 5.0)
        sets.append((args, {}))
    return sets


def _fused_probe(device: str = "cuda"):
    from ..analysis.contracts import (COLLECTIVE_OPS, CompilationContract,
                                      ContractProbe, count_loads)

    ex = FusedSweepExecutor(ClusterModel(), [JobConfig(), JobConfig()],
                            seeds=[0, 1], dt=5.0, n_steps=64, device=device)
    # One interval of K = 8 ticks on the first partition, at rates above
    # capacity so that every state tensor moves.
    part, dev = ex._parts[0], ex.mesh[0]
    S, K = part["lag"].shape[0], 8
    f64 = dict(dtype=torch.float64, device=dev)
    flags = torch.zeros((K, S), dtype=torch.bool, device=dev)
    planes = (torch.full((K, S), 1e6, **f64), torch.zeros((K, S), **f64),
              flags, flags, torch.zeros((K, S), **f64),
              torch.zeros((K, S), **f64))
    interval = ContractProbe(
        contract=FUSED_INTERVAL_CONTRACT, fn=fused_interval_scan,
        args=(ex.model, part["lag"], part["det_w"], part["det_p"],
              part["det_y"], part["det_trig"], *planes,
              *ex._device_configs()[0], DET_LAMBDA, DET_THRESH, ex.dt),
        state=part, device=device,
        loads=lambda: count_loads(fused_interval_scan,
                                  interval_arg_sets(str(dev))))
    # The per-tick K2 kernel, the Pallas kernel's direct counterpart.
    n = 4
    rows = torch.ones(n, **f64)
    tick = ContractProbe(
        contract=CompilationContract(
            name="kernel:fused-tick", forbidden_ops=COLLECTIVE_OPS,
            launches={"fused_tick": 1}, forbid_host_sync=True,
            note="fused lag update + detector observe + RLS tick (K2)"),
        fn=ops.fused_tick,
        args=(rows * 10.0, torch.zeros(n, **f64), rows * 5e4, rows * 4e4,
              torch.zeros(n, dtype=torch.bool, device=dev),
              torch.zeros((n, DET_ORDER), **f64),
              torch.eye(DET_ORDER, **f64).repeat(n, 1, 1),
              torch.zeros(n, **f64), DET_LAMBDA, DET_THRESH, 5.0),
        device=device)
    # Companion probe: an interval with obs forced on must dispatch no
    # more operations than with obs off.
    rates = np.full((4, 2), 5e4)
    obs_probe = obs.probe.instrumentation_contract_probe(
        "engine:fused+obs", ex.step_interval, (rates,), device=device)
    return [interval, tick, obs_probe]


SIM_ENGINES.attach_contract("fused", _fused_probe)
