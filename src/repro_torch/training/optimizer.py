"""AdamW and its learning-rate schedule, the reference's, in PyTorch.

Parameters are a model's named ``nn.Parameter``\\ s (a dict of tensors keyed
by name); the optimizer state is a dict of float32 first and second moments
keyed by the same names, and an int32 step. No ``torch.optim``: its AdamW
decays before the moment update and rounds in another order. Every update
is computed in float32 and cast back to the parameter's dtype, in the
reference's order of operations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10 % of peak, in float32 at the
    integer ``step`` (a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.lr * warm * cos


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Zero float32 moments beside each parameter (a DTensor's placed as
    it is), and step 0 (int32)."""
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa
                     for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm over every tensor: a sum of per-tensor sums of
    squares, in the mapping's order."""
    sq = sum(t.float().square().sum() for t in tensors.values())
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Mapping[str, torch.Tensor],
                 state: Mapping[str, object],
                 params: Mapping[str, torch.Tensor], *,
                 ndims: Optional[Mapping[str, int]] = None
                 ) -> Tuple[Tensors, Dict[str, object], Tensors]:
    """One AdamW step: global clipping of ``grads`` to ``cfg.grad_clip``,
    bias-corrected moments, and weight decay on the tensors of two or more
    dimensions. ``ndims`` gives each parameter's dimension count in the
    layout whose rule applies (the reference's layer-stacked tree: see
    :func:`repro_torch.training.train.reference_ndims`); by default each
    tensor's own. Returns the new parameters (fresh tensors), the new state
    and ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    bc1 = 1.0 - torch.pow(one * cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(one * cfg.b2, stepf)
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        m = cfg.b1 * state["m"][name] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][name] + (1 - cfg.b2) * g.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if (p.ndim if ndims is None else ndims[name]) >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p[name] = (p.float() - lr * delta).to(p.dtype)
        new_m[name], new_v[name] = m, v
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
