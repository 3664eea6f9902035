"""Fault-tolerant elastic training loop, the reference's, on one card.

* periodic **asynchronous checkpoints** (the interval is Demeter's 5th
  parameter);
* **failure handling**: a failure event (injected in tests, detected by
  the runtime in a deployment) aborts the step loop; the trainer restores
  the newest checkpoint, onto the trainer's device, and resumes from its
  exact data step (the pipeline is step-seeded, so no data is lost or
  duplicated and the replay is deterministic);
* **straggler detection**: a step slower than ``straggler_factor`` times
  the rolling median, ``straggler_patience`` times running, is flagged;
* hooks for Demeter: each step's time is reported, so the controller can
  tune the checkpoint interval against the observed failure rate.

The reference rebuilds a (possibly smaller) mesh on recovery; on one card
the counterpart is the device the trainer runs on (see
:func:`repro_torch.distributed.elastic.rescale`).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from .checkpoint import CheckpointManager
from .data import DataConfig, make_pipeline
from .train import TrainConfig, init_train_state, make_train_step, parameters


@dataclass
class FTConfig:
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_interval_steps: int = 50
    straggler_factor: float = 3.0      # step deadline vs rolling median
    straggler_patience: int = 3        # consecutive violations before action


@dataclass
class StepEvent:
    step: int
    loss: float
    duration_s: float
    straggler: bool = False


class ElasticTrainer:
    """Drives train steps with checkpoint/restart and deterministic
    resume, on ``device`` (the card unless the caller passes ``"cpu"``).
    ``cfg`` must be on the plain attention route
    (``attention_impl="reference"``): the kernel route has no backward."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
                 ft: FTConfig, *, device: str = "cuda", seed: int = 0):
        self.device = resolve_device(device)
        self._step_fn = make_train_step(cfg, tc)
        self.cfg, self.tc, self.dc, self.ft = cfg, tc, dc, ft
        self.ckpt = CheckpointManager(ft.checkpoint_dir)
        self.pipeline = make_pipeline(cfg, dc)
        self.events: List[StepEvent] = []
        self.step = 0
        self._streak = 0
        self._failure_flag = False
        self.model = init_params(cfg, seed=seed, device=self.device)
        self.state = init_train_state(self.model, tc)

    # -- failure injection / detection --------------------------------------
    def inject_failure(self) -> None:
        """Simulate a worker loss (tests, chaos harness)."""
        self._failure_flag = True

    # -- main loop -----------------------------------------------------------
    def batch(self, step: int):
        """The pipeline's batch of ``step`` on the trainer's device, one
        copy per array."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.pipeline.batch(step).items()}

    def run(self, n_steps: int,
            on_step: Optional[Callable[[StepEvent], None]] = None
            ) -> List[StepEvent]:
        """Execute ``n_steps`` step events (replays after a recovery count:
        they are real work the cluster performs)."""
        produced = 0
        while produced < n_steps:
            produced += 1
            if self._failure_flag:
                self._recover()
            t0 = time.monotonic()
            self.model, self.state, metrics = self._step_fn(
                self.model, self.state, self.batch(self.step))
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            ev = StepEvent(self.step, loss, dt,
                           straggler=self._is_straggler(dt))
            self.events.append(ev)
            if on_step:
                on_step(ev)
            self.step += 1
            if self.step % self.ft.checkpoint_interval_steps == 0:
                self._checkpoint()
        self.ckpt.wait()
        return self.events

    # -- internals -----------------------------------------------------------
    def _tree(self):
        return {"params": parameters(self.model), "state": self.state}

    def _checkpoint(self) -> None:
        self.ckpt.save(self.step, self._tree())

    def _is_straggler(self, dt: float) -> bool:
        recent = [e.duration_s for e in self.events[-32:]]
        if len(recent) < 8:
            return False
        med = float(np.median(recent))
        slow = dt > self.ft.straggler_factor * med
        self._streak = self._streak + 1 if slow else 0
        return self._streak >= self.ft.straggler_patience

    def _recover(self) -> None:
        """Elastic restart: restore the newest checkpoint onto the
        trainer's device and rewind the step counter to it; with no
        checkpoint yet, start training over from seed 0's parameters."""
        self._failure_flag = False
        latest = self.ckpt.latest_step()
        if latest is None:
            self.model = init_params(self.cfg, seed=0, device=self.device)
            self.state = init_train_state(self.model, self.tc)
            self.step = 0
            return
        self.ckpt.wait()
        step, tree = self.ckpt.restore(latest, like=self._tree())
        with torch.no_grad():
            for name, p in parameters(self.model).items():
                p.copy_(tree["params"][name])
        self.state = tree["state"]
        self.step = step
