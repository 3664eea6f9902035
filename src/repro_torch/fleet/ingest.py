"""Batched telemetry ingestion for the fleet controller.

Thousands of jobs report telemetry asynchronously; the service consumes it
in epochs. :class:`IngestBuffer` is the seam between the two cadences:

* **offer** (host, per sample): append to the job's bounded queue.
  Backpressure is drop-oldest: a full queue sheds its oldest sample so the
  freshest telemetry always survives. Samples may arrive out of order;
  anything at or before the row's *watermark* (the last drained epoch
  boundary minus the lateness allowance) is too late to attribute to an
  epoch and is dropped, counted.
* **drain** (once per epoch): collect every row's due samples, pad them
  into one ``[rows, samples, keys]`` float32 plane and reduce it to
  per-row means on the fleet's device: one copy of the plane to the
  device, a few tensor operations and one copy of the means and counts
  back, for the whole fleet. Late-but-allowed samples land in the next
  epoch's reduce.

The sample axis is padded to a power of two (minimum 4), as the
reference pads it. The sums run over the sample axis in index order (one
elementwise add per sample), so the card and the CPU give the same bits.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.executor import resolve_device
from ..core.gp_bank import bucket_pow2

#: Metric keys carried through the epoch reduce, in plane order.
INGEST_KEYS = ("rate", "latency", "usage")

#: Per-row sample queue bound (backpressure threshold).
DEFAULT_QUEUE_CAP = 256

#: How long after an epoch is drained its samples may still arrive.
DEFAULT_LATENESS_S = 120.0


def epoch_reduce(vals: torch.Tensor) -> torch.Tensor:
    """NaN-masked per-(row, key) means over the sample axis.

    ``vals`` is ``[R, N, K]`` float32 with NaN marking absent samples (and
    absent keys within a sample). Returns ``[R, 2K]`` float32: the means
    (NaN where a (row, key) has no finite sample) beside the counts, so
    that one copy brings both back. The sum adds one sample at a time in
    index order.
    """
    mask = ~torch.isnan(vals)
    n = mask.sum(dim=1)
    z = torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                            device=vals.device))
    s = z[:, 0]
    for j in range(1, vals.shape[1]):
        s = s + z[:, j]
    nf = n.to(vals.dtype)
    mean = torch.where(n > 0, s / torch.clamp(nf, min=1.0),
                       torch.full_like(s, float("nan")))
    return torch.cat([mean, nf], dim=1)


class IngestBuffer:
    """Per-job telemetry queues feeding one batched epoch reduce on
    ``device`` (the card by default; it raises where there is none, so
    pass ``device="cpu"``)."""

    def __init__(self, capacity: int, *,
                 keys: Sequence[str] = INGEST_KEYS,
                 queue_cap: int = DEFAULT_QUEUE_CAP,
                 lateness_s: float = DEFAULT_LATENESS_S,
                 device: str = "cuda"):
        if capacity < 1:
            raise ValueError("IngestBuffer needs capacity >= 1")
        if queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.keys = tuple(keys)
        self.queue_cap = int(queue_cap)
        self.lateness_s = float(lateness_s)
        self._q: List[List[Tuple[float, Tuple[float, ...]]]] = [
            [] for _ in range(self.capacity)]
        self.watermark = np.full(self.capacity, -np.inf)
        # counters (exposed through FleetController.stats)
        self.accepted = 0
        self.dropped_late = 0
        self.dropped_overflow = 0
        self.out_of_order = 0
        self.drained = 0

    # -- ingress (host, per sample) -----------------------------------------
    def offer(self, row: int, t: float,
              metrics: Mapping[str, float]) -> bool:
        """Queue one sample for ``row`` at timestamp ``t``.

        Returns False when the sample is too late to attribute to any
        future epoch (``t`` at or below the row's watermark)."""
        if t <= self.watermark[row]:
            self.dropped_late += 1
            return False
        q = self._q[row]
        if q and t < q[-1][0]:
            self.out_of_order += 1
        if len(q) >= self.queue_cap:        # backpressure: shed the oldest
            q.sort(key=lambda s: s[0])
            del q[0]
            self.dropped_overflow += 1
        q.append((float(t),
                  tuple(float(metrics.get(k, np.nan)) for k in self.keys)))
        self.accepted += 1
        return True

    def clear_row(self, row: int) -> None:
        """Forget a departed job's queue and watermark (slot reuse)."""
        self._q[row] = []
        self.watermark[row] = -np.inf

    def queue_depth(self, row: int) -> int:
        return len(self._q[row])

    def max_queue_depth(self) -> int:
        return max((len(q) for q in self._q), default=0)

    # -- epoch drain (one reduce) -------------------------------------------
    def drain(self, upto_t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Reduce every row's samples with ``t <= upto_t`` to per-row means.

        One copy to the device, one reduce and one copy back for the whole
        fleet. Advances each row's watermark to ``upto_t - lateness_s``;
        samples newer than that may still arrive and fold into the *next*
        epoch. Returns ``(means [capacity, K] float64, counts [capacity, K]
        int64)``: NaN means for rows/keys with no samples this epoch.
        """
        taken: List[List[Tuple[float, Tuple[float, ...]]]] = []
        n_max = 0
        for q in self._q:
            due = [s for s in q if s[0] <= upto_t]
            if due:
                due.sort(key=lambda s: s[0])
                q[:] = [s for s in q if s[0] > upto_t]
            taken.append(due)
            n_max = max(n_max, len(due))
        self.watermark = np.maximum(self.watermark,
                                    upto_t - self.lateness_s)
        n_taken = sum(len(d) for d in taken)
        K = len(self.keys)
        if n_taken == 0:
            return (np.full((self.capacity, K), np.nan),
                    np.zeros((self.capacity, K), dtype=np.int64))
        n_pad = bucket_pow2(n_max, minimum=4)
        plane = np.full((self.capacity, n_pad, K), np.nan, dtype=np.float32)
        for r, due in enumerate(taken):
            for j, (_, vals) in enumerate(due):
                plane[r, j, :] = vals
        with obs.timed_phase("fleet", "fleet.ingest.drain",
                             rows=self.capacity, samples=n_taken):
            out = epoch_reduce(torch.from_numpy(plane).to(self.device))
        out = out.cpu().numpy()
        self.drained += n_taken
        obs.inc("fleet.ingest_samples", n_taken)
        return (out[:, :K].astype(np.float64),
                out[:, K:].astype(np.int64))


# ---------------------------------------------------------------------------
# contract (see repro_torch.analysis)
# ---------------------------------------------------------------------------

def _epoch_reduce_contract():
    from ..analysis.contracts import COLLECTIVE_OPS, CompilationContract
    return CompilationContract(
        name="fleet backend:ingest",
        forbidden_ops=COLLECTIVE_OPS,
        # Telemetry means need no more precision than their float32 inputs;
        # the fleet reduce must never promote.
        dtype_ceiling="float32",
        forbid_host_sync=True,
        # about 3 operations per padded sample plus a fixed dozen
        max_ops=32,
        # The reduce is plain torch: no kernel library at any sample count.
        max_loads=0,
        note="fleet epoch reduce: one call per epoch for the whole fleet, "
             "sample axis padded pow2(min 4)")


#: The ingestion hot path's invariants.
EPOCH_REDUCE_CONTRACT = _epoch_reduce_contract()


def contract_probe(device: str = "cuda"):
    """The ingestion reduce packaged for
    :func:`repro_torch.analysis.contracts.run_probe`; registered on the
    ``"sim"`` fleet backend (the reduce is backend-independent)."""
    from ..analysis.contracts import ContractProbe, count_loads
    dev = resolve_device(device)

    def plane(rows: int, n: int) -> torch.Tensor:
        vals = np.full((rows, n, len(INGEST_KEYS)), np.nan, dtype=np.float32)
        vals[:, 0, :] = 1.0
        return torch.from_numpy(vals).to(dev)

    return ContractProbe(
        contract=EPOCH_REDUCE_CONTRACT, fn=epoch_reduce, args=(plane(8, 4),),
        device=device,
        loads=lambda: count_loads(epoch_reduce, [
            ((plane(8, bucket_pow2(n, minimum=4)),), {})
            for n in (3, 4, 7, 8, 9)]))
