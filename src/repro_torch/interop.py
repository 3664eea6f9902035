"""State carried across from the reference package.

The system has no weights: what the reference and the port share is
simulation state and model parameters. These helpers take plain Python and
NumPy values — ``dataclasses.asdict`` of the reference's ``ClusterModel``
and ``JobConfig``, and the fused engine's device state as NumPy arrays —
so the conversion on the reference side needs nothing of this package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .dsp.fused import DET_ORDER
from .dsp.simulator import ClusterModel, JobConfig


def _exact_fields(cls, d: Mapping[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    missing, unknown = names - set(d), set(d) - names
    if missing or unknown:
        raise ValueError(f"{cls.__name__} fields do not match: missing "
                         f"{sorted(missing)}, unknown {sorted(unknown)}")
    return dict(d)


def cluster_model_from_dict(d: Mapping[str, Any]) -> ClusterModel:
    """The port's :class:`ClusterModel` from the reference's ``asdict``."""
    return ClusterModel(**{k: float(v) for k, v in
                           _exact_fields(ClusterModel, d).items()})


def job_config_from_dict(d: Mapping[str, Any]) -> JobConfig:
    """The port's :class:`JobConfig` from the reference's ``asdict``."""
    return JobConfig.from_dict(_exact_fields(JobConfig, d))


#: The fused engine's persistent device state: name -> (trailing shape, dtype).
FUSED_STATE = {"lag": ((), torch.float64),
               "det_w": ((DET_ORDER,), torch.float64),
               "det_p": ((DET_ORDER, DET_ORDER), torch.float64),
               "det_y": ((), torch.float64),
               "det_trig": ((), torch.int64)}


def fused_state_from_arrays(arrays: Mapping[str, np.ndarray],
                            device: Union[str, torch.device]
                            ) -> Dict[str, torch.Tensor]:
    """The fused executor's device tensors from NumPy arrays ``{"lag",
    "det_w", "det_p", "det_y", "det_trig"}`` (S rows each); load them with
    :meth:`~repro_torch.dsp.fused.FusedSweepExecutor.load_device_state`."""
    if set(arrays) != set(FUSED_STATE):
        raise ValueError(f"expected arrays {sorted(FUSED_STATE)}, got "
                         f"{sorted(arrays)}")
    S = np.shape(arrays["lag"])[0] if np.ndim(arrays["lag"]) else None
    out = {}
    for name, (trail, dtype) in FUSED_STATE.items():
        a = np.asarray(arrays[name])
        if S is None or a.shape != (S, *trail):
            raise ValueError(f"{name} must have shape (S, *{trail}) with the "
                             f"lag's S rows, got {a.shape}")
        out[name] = torch.tensor(a, dtype=dtype, device=device)
    return out
