"""Deterministic, resumable data pipeline: the reference's, draw for draw.

(a) Every restart resumes exactly where it left off: batches are seeded by
the step, so nothing beyond the step counter is checkpointed; (b) each host
loads only its shard (fed by its index); (c) synthetic and file-backed
sources sit behind one interface. Batches are NumPy arrays from the
reference's NumPy generator seeded by ``(seed, step, host_index)``, so the
port trains on the reference's batches bit for bit; the trainer moves each
array to its device in one copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    batch_per_host: int
    seq_len: int
    n_hosts: int = 1
    host_index: int = 0
    seed: int = 1234
    path: Optional[str] = None    # None -> synthetic


class SyntheticLM:
    """Zipfian token stream, seeded by (seed, step, host)."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        # Zipf-ish distribution over the vocab (heavier head, long tail).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.dc.seed, step, self.dc.host_index))
        shape = (self.dc.batch_per_host, self.dc.seq_len + 1)
        toks = rng.choice(len(self._p), size=shape, p=self._p)
        toks = toks.astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        front = self.cfg.frontend
        if front is not None and front.kind == "audio":
            frames = rng.standard_normal(
                (self.dc.batch_per_host, self.dc.seq_len,
                 front.d_in)).astype(np.float32)
            mask = rng.random((self.dc.batch_per_host,
                               self.dc.seq_len)) < 0.08
            out = {"frames": frames,
                   "labels": toks[:, :-1] % self.cfg.vocab_size,
                   "loss_mask": mask.astype(np.float32)}
        elif front is not None and front.kind == "vision":
            out["patches"] = rng.standard_normal(
                (self.dc.batch_per_host, front.prefix_len,
                 front.d_in)).astype(np.float32)
        return out


class TokenFile:
    """memmap-backed token stream; deterministic stride per (step, host)."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        if dc.path is None:
            raise ValueError("TokenFile needs DataConfig.path")
        self.cfg = cfg
        self.dc = dc
        self._data = np.memmap(dc.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        span = dc.seq_len + 1
        per_step = dc.batch_per_host * dc.n_hosts
        base = (step * per_step + dc.host_index * dc.batch_per_host) * span
        n = len(self._data)
        rows = [np.asarray(self._data[off:off + span])
                for off in ((base + i * span) % max(n - span, 1)
                            for i in range(dc.batch_per_host))]
        toks = np.stack(rows).astype(np.int32) % self.cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_pipeline(cfg: ModelConfig, dc: DataConfig):
    return TokenFile(cfg, dc) if dc.path else SyntheticLM(cfg, dc)
