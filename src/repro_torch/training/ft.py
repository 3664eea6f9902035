"""Fault-tolerant elastic training loop, the reference's.

* periodic **asynchronous checkpoints** (the interval is Demeter's 5th
  parameter);
* **failure handling**: a failure event (injected in tests, detected by
  the runtime in a deployment) aborts the step loop; the trainer restores
  the newest checkpoint, onto the trainer's device or, on a mesh, resharded
  onto a (possibly smaller) mesh, and resumes from its exact data step (the
  pipeline is step-seeded, so no data is lost or duplicated and the replay
  is deterministic);
* **straggler detection**: a step slower than ``straggler_factor`` times
  the rolling median, ``straggler_patience`` times running, is flagged;
* hooks for Demeter: each step's time is reported, so the controller can
  tune the checkpoint interval against the observed failure rate.

On a mesh (``mesh=``, a :class:`~torch.distributed.device_mesh.
DeviceMesh` that every rank builds alike) the parameters and moments are
DTensors under :func:`~repro_torch.distributed.sharding.param_shardings`
and each step runs inside a
:func:`~repro_torch.distributed.sharding.sharding_context`; every rank runs
the trainer, global rank 0 writes the checkpoints, and
``_recover(new_mesh=...)`` restores onto the new mesh's shardings (see
:func:`repro_torch.distributed.elastic.surviving_mesh`). A rank outside the
new mesh leaves the loop.
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
from ..distributed.elastic import rescale, set_parameters
from ..distributed.sharding import param_shardings, sharding_context
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
    (``attention_impl="reference"``): the kernel route has no backward.
    With ``mesh``, the parameters and optimizer state are DTensors on it
    (``device`` is of the mesh's kind)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
                 ft: FTConfig, *, mesh=None, device: str = "cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh needs "
                             f"device={mesh.device_type!r}, got {device!r}")
        self._step_fn = make_train_step(cfg, tc)
        self.cfg, self.tc, self.dc, self.ft = cfg, tc, dc, ft
        self.mesh = mesh
        self.ckpt = CheckpointManager(
            ft.checkpoint_dir,
            writer=mesh is None or torch.distributed.get_rank() == 0)
        self.pipeline = make_pipeline(cfg, dc)
        self.events: List[StepEvent] = []
        self.step = 0
        self.active = True
        self._streak = 0
        self._failure_flag = False
        self._fresh_model(seed)

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
            if not self.active:
                break
            t0 = time.monotonic()
            if self.mesh is None:
                self.model, self.state, metrics = self._step_fn(
                    self.model, self.state, self.batch(self.step))
                loss = float(metrics["loss"])
            else:
                with sharding_context(self.mesh):
                    self.model, self.state, metrics = self._step_fn(
                        self.model, self.state, self.batch(self.step))
                    loss = float(metrics["loss"].full_tensor())
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
    def _fresh_model(self, seed: int) -> None:
        """Parameters drawn from ``seed`` (placed on the mesh, if any) and a
        fresh optimizer state."""
        self.model = init_params(self.cfg, seed=seed, device=self.device)
        if self.mesh is not None:
            set_parameters(self.model, rescale(parameters(self.model),
                                               self.mesh))
        self.state = init_train_state(self.model, self.tc)

    def _barrier(self) -> None:
        """Wait for every rank of the mesh: one barrier per mesh axis, each
        over that axis's groups."""
        for dim in range(self.mesh.ndim):
            torch.distributed.barrier(group=self.mesh.get_group(dim))

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

    def _recover(self, new_mesh=None) -> None:
        """Elastic restart: restore the newest checkpoint onto the
        trainer's device, or onto the shardings of ``new_mesh`` (by default
        the trainer's mesh), and rewind the step counter to it; with no
        checkpoint yet, start training over from seed 0's parameters. On a
        mesh, every rank waits for the writer's files first; a rank outside
        ``new_mesh`` then leaves the loop (``active`` False)."""
        self._failure_flag = False
        if self.mesh is not None:
            self.ckpt.wait()
            self._barrier()
        if new_mesh is not None:
            self.mesh = new_mesh
            if new_mesh.get_coordinate() is None:
                self.active = False
                return
        latest = self.ckpt.latest_step()
        if latest is None:
            self._fresh_model(0)
            self.step = 0
            return
        self.ckpt.wait()
        like = self._tree()
        if self.mesh is None:
            step, tree = self.ckpt.restore(latest, like=like)
            with torch.no_grad():
                for name, p in parameters(self.model).items():
                    p.copy_(tree["params"][name])
        else:
            sh = param_shardings(self.mesh, like["params"])
            step, tree = self.ckpt.restore(latest, like=like, shardings={
                "params": sh, "state": {"opt": {"m": sh, "v": sh},
                                        "ef": sh}})
            set_parameters(self.model, tree["params"])
        self.state = tree["state"]
        self.step = step
