"""State carried across from the reference package.

What the reference and the port share is simulation state, model
parameters and, for the serving stack, model configs and weights. These
helpers take plain Python and NumPy values — ``dataclasses.asdict`` of the
reference's ``ClusterModel``, ``JobConfig`` and ``ModelConfig``, the fused
engine's device state, a forecast-bank family's state and parameters, a
fitted GP's arrays, and a model's parameter tree and train state — so the
conversion on the reference side needs nothing of this package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from .core.forecast_bank import DetectorBank, ForecastBank
from .core.gp import GP
from .dsp.fused import DET_ORDER
from .dsp.simulator import ClusterModel, JobConfig
from .models import config as model_config
from .models.transformer import Transformer, init_params


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


def detector_bank_from_arrays(bank: DetectorBank,
                              arrays: Mapping[str, np.ndarray]) -> None:
    """Load ``bank`` from NumPy copies of a reference ``DetectorBank``'s
    ``_state`` (its ``_asdict()`` fields), ``_ring`` and ``_rn``, given as
    one mapping with the keys ``ring`` and ``rn`` beside the state's. Both
    banks pad their rows to the same power of two, so every shape must
    match."""
    names = bank._state._fields + ("ring", "rn")
    if set(arrays) != set(names):
        raise ValueError(f"expected arrays {sorted(names)}, got "
                         f"{sorted(arrays)}")
    bufs = (*bank._state, bank._ring, bank._rn)
    t = {n: torch.as_tensor(np.array(arrays[n]), dtype=b.dtype,
                            device=b.device) for n, b in zip(names, bufs)}
    bank.load_state([t[n] for n in bank._state._fields], t["ring"], t["rn"])


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



#: the sub-config dataclass of each nested field of ``ModelConfig``
_SUB_CONFIGS = {"moe": model_config.MoEConfig, "mla": model_config.MLAConfig,
                "ssm": model_config.SSMConfig,
                "hybrid": model_config.HybridConfig,
                "frontend": model_config.FrontendConfig}
#: the reference's attention implementations and the port's counterparts
_ATTENTION_IMPLS = {"reference": "reference", "pallas": "kernel"}


def model_config_from_dict(d: Mapping[str, Any]) -> model_config.ModelConfig:
    """The port's ``ModelConfig`` from the reference's ``asdict``; its
    ``attention_impl`` ``"pallas"`` becomes the port's ``"kernel"``."""
    d = _exact_fields(model_config.ModelConfig, d)
    for name, cls in _SUB_CONFIGS.items():
        if d[name] is not None:
            sub = _exact_fields(cls, d[name])
            d[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in sub.items()})
    if d["attention_impl"] not in _ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {d['attention_impl']!r}; "
                         f"expected one of {sorted(_ATTENTION_IMPLS)}")
    d["attention_impl"] = _ATTENTION_IMPLS[d["attention_impl"]]
    return model_config.ModelConfig(**d)


def _flatten(tree: Union[Mapping[str, Any], list, tuple], prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    """Dotted names and NumPy leaves of a tree of dicts and lists (a list's
    items are named by their index: the reference's ``prefix`` blocks)."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, value in items:
        if isinstance(value, (Mapping, list, tuple)):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A NumPy array as a tensor of the same dtype; bfloat16 (an extension
    dtype NumPy cannot hand to torch) passes through float32 exactly."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_reference_params(module: torch.nn.Module,
                          params: Mapping[str, Any]) -> None:
    """Copy a reference parameter tree into ``module`` in place: ``params``
    holds NumPy leaves in nested dicts (or dotted names) that name the
    module's ``state_dict`` entries exactly, with the same shapes."""
    src = dict(_flatten(params))
    state = module.state_dict()
    missing, unknown = set(state) - set(src), set(src) - set(state)
    if missing or unknown:
        raise ValueError(f"parameter trees do not match: missing "
                         f"{sorted(missing)}, unknown {sorted(unknown)}")
    with torch.no_grad():
        for name, tensor in state.items():
            if tuple(src[name].shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: shape {src[name].shape}, the port "
                                 f"expects {tuple(tensor.shape)}")
            tensor.copy_(_to_torch(src[name]))


def model_params_from_reference(cfg: model_config.ModelConfig,
                                params: Mapping[str, Any],
                                device="cuda") -> Transformer:
    """A port model of ``cfg`` on ``device`` holding the reference's
    parameters: ``params`` is the reference's parameter tree (nested dicts)
    with NumPy leaves, as ``repro.models.init_params`` builds it. The
    layer stack's leaves are unstacked into the port's per-layer modules:
    ``(L, ...)`` for the dense, ssm, encoder and vlm families,
    ``(groups, period, ...)`` for the hybrid, whose ``shared.*`` leaves go
    to the shared block, and ``(L - first_dense_layers, ...)`` for the moe
    family, whose list of dense first blocks (``prefix``) gives the port's
    first ``first_dense_layers`` blocks. The other leaves keep their names: a frontend's
    (``frontend.proj``, ``pos_conv_w``, ``pos_conv_b`` for audio;
    ``frontend.proj1``, ``proj2`` for vision), and hubert's tree has no
    ``embed`` and its own ``lm_head``, as the port's model. The
    model's dtype is the leaves' (``final_norm.scale``'s); float32 leaves
    of a bfloat16 model (mamba2's ``a_log``, ``dt_bias``, ``d_skip``) stay
    float32."""
    flat = dict(_flatten(params))
    model = init_params(cfg, device=device,
                        dtype=_to_torch(flat["final_norm.scale"]).dtype)
    load_reference_params(model, _port_names(cfg, flat))
    return model


def _port_names(cfg: model_config.ModelConfig,
                flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's dotted leaves under the port's parameter names: the
    layer stack unstacked into ``blocks.<i>.*`` (the MoE family's dense
    ``prefix`` list first), the other leaves as they are."""
    n_prefix = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    lead = ((cfg.n_layers // cfg.hybrid.period, cfg.hybrid.period)
            if cfg.family == "hybrid" else (cfg.n_layers - n_prefix,))
    src = {}
    for name, a in flat.items():
        if name.startswith("prefix."):
            src[f"blocks.{name[len('prefix.'):]}"] = a
            continue
        if not name.startswith("stack."):
            src[name] = a
            continue
        if tuple(a.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: layers stacked as "
                             f"{a.shape[:len(lead)]}, the config has {lead}")
        for i, idx in enumerate(np.ndindex(*lead)):
            src[f"blocks.{n_prefix + i}.{name[len('stack.'):]}"] = a[idx]
    return src


def train_state_from_reference(model: Transformer,
                               state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's train state (``init_train_state``'s tree: ``{"opt":
    {"m", "v", "step"}}`` and, with compression, ``"ef"``; NumPy leaves,
    the moments and buffers in the reference's layer-stacked layout) as
    the port's (:func:`repro_torch.training.init_train_state`'s): the same
    tensors keyed by ``model``'s parameter names, on ``model``'s device."""
    names = [n for n, _ in model.named_parameters()]
    dev = next(model.parameters()).device

    def tree(t: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        src = _port_names(model.cfg, dict(_flatten(t)))
        if set(src) != set(names):
            raise ValueError(f"state does not match the model's parameters:"
                             f" missing {sorted(set(names) - set(src))}, "
                             f"unknown {sorted(set(src) - set(names))}")
        return {n: _to_torch(src[n]).to(dev) for n in names}

    opt = state["opt"]
    out = {"opt": {"m": tree(opt["m"]), "v": tree(opt["v"]),
                   "step": torch.as_tensor(np.array(opt["step"]),
                                           dtype=torch.int32).to(dev)}}
    if "ef" in state:
        out["ef"] = tree(state["ef"])
    return out
