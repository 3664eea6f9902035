"""Batched serving engine: continuous batching over a slot KV cache.

The port of ``repro/serving/engine.py``. One engine = one model replica on
one device. Requests arrive on a queue (the paper's Kafka source), prefill
and decode steps process them (the operators), and completion latency is
the end-to-end latency Demeter constrains. The engine exposes the metrics
Demeter's TSF/MOBO consume: arrival rate, p95 latency, slot occupancy and
step timings.

The reference jit-compiles its prefill and decode; here they run eagerly,
and every cache write lands in place in the engine's arena. A decode step
waits on the device once, for the sampled tokens.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..models import cache_slot_view, decode_step, init_cache, prefill
from ..models.config import ModelConfig
from .kv_cache import KVCacheManager


@dataclass
class Request:
    request_id: str
    tokens: np.ndarray                  # prompt token ids
    max_tokens: int
    arrival_s: float
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: List[int] = field(default_factory=list)

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s


#: Ring sizes for the windowed metrics (``p95_latency`` reads the last 512
#: latencies, ``telemetry`` the last 64 step times), so a long-running
#: service does not grow them without bound.
LATENCY_RING = 512
STEP_TIME_RING = 64


@dataclass
class EngineMetrics:
    completed: int = 0
    decode_steps: int = 0
    latencies: Deque[float] = field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_RING))
    step_times: Deque[float] = field(
        default_factory=lambda: collections.deque(maxlen=STEP_TIME_RING))

    def p95_latency(self) -> float:
        if not self.latencies:
            return float("nan")
        return float(np.percentile(np.fromiter(self.latencies, float), 95))


class ServingEngine:
    """Single-replica engine; slots/max_len are Demeter's knobs.

    ``model`` is a :class:`~repro_torch.models.Transformer` of a ported
    family with a decode step (dense, ssm, hybrid, moe with or without
    MLA, or vlm on tokens); it
    is moved to ``device`` (the card unless the caller passes
    ``device="cpu"``) if it lies elsewhere. The cache's dtype follows the model's parameters.
    """

    def __init__(self, cfg: ModelConfig, model, *, n_slots: int,
                 max_len: int, device="cuda",
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.clock = clock
        self.cache_mgr = KVCacheManager(n_slots, max_len)
        dtype = next(p.dtype for p in self.model.parameters()
                     if p.is_floating_point())
        self.cache = init_cache(cfg, n_slots, max_len, dtype=dtype,
                                device=self.device)
        self.queue: Deque[Request] = collections.deque()
        self.requests: Dict[str, Request] = {}
        self.metrics = EngineMetrics()
        self._tokens = np.zeros((n_slots, 1), np.int64)

    # -- request ingress -----------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.requests[req.request_id] = req

    # -- scheduling ----------------------------------------------------------
    def admit(self) -> int:
        """Move queued requests into free slots (prefill them)."""
        admitted = 0
        while self.queue:
            req = self.queue[0]
            slot = self.cache_mgr.allocate(req.request_id, len(req.tokens),
                                           req.max_tokens)
            if slot is None:
                break
            self.queue.popleft()
            self._prefill_into_slot(slot, req)
            admitted += 1
        return admitted

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        # Single-sequence prefill through a view of the slot's cache lines,
        # cursor at 0: the mamba layers start from zero state whatever the
        # slot's previous request left there (the reference's do not).
        prompt = torch.as_tensor(np.asarray(req.tokens, np.int64),
                                 device=self.device)[None, :]
        logits, _ = prefill(self.model, prompt,
                            cache_slot_view(self.cache, slot))
        tok = int(torch.argmax(logits[0]))
        req.output.append(tok)
        req.first_token_s = self.clock()
        self._tokens[slot, 0] = tok
        self.cache_mgr.slots[slot].length = len(req.tokens)
        self.cache_mgr.slots[slot].generated = 1   # the prefill token counts

    def step(self) -> int:
        """One decode step across all active slots (ragged lengths)."""
        active = self.cache_mgr.active()
        if not active:
            return 0
        t0 = self.clock()
        tokens = torch.as_tensor(self._tokens, device=self.device)
        logits, _ = decode_step(self.model, tokens, self.cache,
                                torch.from_numpy(self.cache_mgr.lengths()))
        toks = torch.argmax(logits, -1).cpu().numpy()   # the step's one sync
        now = self.clock()
        self.metrics.step_times.append(now - t0)
        self.metrics.decode_steps += 1
        for slot in active:
            req = self.requests[self.cache_mgr.slots[slot].request_id]
            tok = int(toks[slot])
            req.output.append(tok)
            self._tokens[slot, 0] = tok
            self.cache_mgr.advance(slot)
            if self.cache_mgr.done(slot):
                req.done_s = now
                self.metrics.completed += 1
                if req.latency_s is not None:
                    self.metrics.latencies.append(req.latency_s)
                self.cache_mgr.release(slot)
        return len(active)

    # -- telemetry (Demeter's observe()) ---------------------------------------
    def telemetry(self) -> Dict[str, float]:
        return {
            "queue_depth": float(len(self.queue)),
            "occupancy": self.cache_mgr.occupancy(),
            "p95_latency_s": self.metrics.p95_latency(),
            "completed": float(self.metrics.completed),
            "mean_step_s": float(np.mean(np.fromiter(
                self.metrics.step_times, float)))
            if self.metrics.step_times else float("nan"),
        }
