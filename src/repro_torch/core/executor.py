"""The port's engine configuration and device resolution."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .registry import SIM_ENGINES


def _ensure_registered() -> None:
    """Import the modules that register the built-in engines and
    controllers, so validation works whichever module was imported first."""
    from ..dsp import executor, fused, policies  # noqa: F401


def resolve_device(name: str) -> torch.device:
    """``name`` as a :class:`torch.device`, refusing a CUDA device that is
    not there: the port never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass EngineConfig(device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {name!r}")
    return device


@dataclass(frozen=True)
class EngineConfig:
    """One configuration object for the sweep stack, validated at
    construction."""

    #: Sweep simulation engine: "fused" (whole decision intervals on the
    #: device, one fused-tick kernel launch per tick) or "batched" (the
    #: vectorized NumPy host engine).
    sim_backend: str = "fused"
    #: Baseline-controller decision cadence (seconds).
    decision_interval_s: float = 60.0
    #: Where the fused engine keeps its state and launches its kernels.
    #: The batched engine runs on the host whatever this says.
    device: str = "cuda"

    def __post_init__(self) -> None:
        _ensure_registered()
        SIM_ENGINES.validate(self.sim_backend)
        if not self.decision_interval_s > 0:
            raise ValueError(f"decision_interval_s must be positive, got "
                             f"{self.decision_interval_s!r}")
