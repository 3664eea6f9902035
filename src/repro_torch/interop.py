"""State carried across from the reference package.

The system has no weights: what the reference and the port share is
simulation state and model parameters. These helpers take plain Python and
NumPy values — ``dataclasses.asdict`` of the reference's ``ClusterModel``
and ``JobConfig``, the fused engine's device state, a forecast-bank
family's state and parameters, and a fitted GP's arrays — so the conversion
on the reference side needs nothing of this package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .core.forecast_bank import ForecastBank
from .core.gp import GP
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


def forecast_family_from_arrays(bank: ForecastBank, kind: str,
                                state: Mapping[str, np.ndarray],
                                params: Mapping[str, np.ndarray]) -> None:
    """Load one family of ``bank`` from NumPy arrays named like the
    reference's ``_ArimaState``/``_HoltState``/``_SNaiveState`` and their
    params (a ``NamedTuple._asdict()`` of NumPy copies). Rows beyond the
    family's stream count (the reference pads its stream axis to a power of
    two) are dropped; the trailing shapes must match. The bank's cached
    forecasts are dropped too."""
    fam = bank.family(kind)
    new = []
    for group, arrays in ((fam.state, state), (fam.params, params)):
        names = set(group._fields)
        if set(arrays) != names:
            raise ValueError(f"{kind} expects arrays {sorted(names)}, got "
                             f"{sorted(arrays)}")
        new.append([torch.as_tensor(np.array(arrays[f])[:fam.n],
                                    dtype=buf.dtype, device=buf.device)
                    for f, buf in zip(group._fields, group)])
    fam.load_state(*new)
    bank._drop_family_cache(kind)


def gp_from_arrays(x: np.ndarray, y_mean: float, y_std: float,
                   theta: np.ndarray, chol: np.ndarray,
                   alpha: np.ndarray) -> GP:
    """A port :class:`~repro_torch.core.gp.GP` from a fitted reference GP's
    fields, with their NumPy dtypes kept."""
    n = np.shape(alpha)[0]
    if np.shape(x)[0] != n or np.shape(chol) != (n, n):
        raise ValueError(f"x {np.shape(x)}, chol {np.shape(chol)} and alpha "
                         f"{np.shape(alpha)} disagree on n")
    return GP(x=np.array(x), y_mean=float(y_mean), y_std=float(y_std),
              theta=np.array(theta), chol=np.array(chol),
              alpha=np.array(alpha))

