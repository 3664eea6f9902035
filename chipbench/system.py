"""The system under test: ``repro_torch``'s serving engine and model, built
from the port's configuration (an architecture file's ``model_config``,
``chipbench/arch``) and the benchmark's own weights.

With the architecture files, this is the only module of the harness that
builds the port's objects; the plain references (``chipbench/reference``)
import nothing of it.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ServingEngine

def build_model(mcfg: ModelConfig, weights: Dict[str, torch.Tensor]):
    """The port's model of ``mcfg`` holding ``weights`` (no copy): built
    on the meta device, each parameter then replaced by its weight. The
    names and shapes must be the model's own, one for one."""
    model = init_params(mcfg, device="meta")
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and model differ: "
                         f"{sorted(set(params) ^ set(weights))[:6]}")
    for name, p in params.items():
        w = weights[name]
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{name}: weight {tuple(w.shape)}, model "
                             f"{tuple(p.shape)}")
        owner, attr = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), attr,
                nn.Parameter(w, requires_grad=False))
    return model


def build_engine(mcfg: ModelConfig, weights: Dict[str, torch.Tensor], *,
                 slots: int, max_len: int, device) -> ServingEngine:
    return ServingEngine(mcfg, build_model(mcfg, weights), n_slots=slots,
                         max_len=max_len, device=device)
