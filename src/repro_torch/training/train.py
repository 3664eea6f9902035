"""Train-step construction: gradient accumulation, compression, AdamW.

``make_train_step`` builds ``(model, state, batch) -> (model, state,
metrics)``, the reference's step: gradients by autograd through
:func:`repro_torch.models.train_loss`, optionally summed over microbatches
in float32, optionally passed through int8 error-feedback compression, then
:func:`repro_torch.training.optimizer.adamw_update`, whose new values are
written into the model's parameters in place.

The step differentiates the plain attention route
(``attention_impl="reference"``), as the reference's does: the port's
kernels (K1-K7) have no backward, like the reference's Pallas kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..distributed.compression import compress_decompress, ef_init
from ..models import train_loss
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from .optimizer import OptimizerConfig, adamw_init, adamw_update

Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    accum_steps: int = 1          # microbatches per step
    compress_grads: bool = False  # int8 EF compression before the optimizer


def parameters(model: Transformer) -> Dict[str, torch.Tensor]:
    """The model's trainable parameters by name (``named_parameters``
    order): the tree the optimizer, the compression and the checkpoints
    key by."""
    return dict(model.named_parameters())


def _stack_lead(model: Transformer) -> Dict[str, int]:
    """Each parameter's leading layer axes in the reference's parameter
    tree: one for the layer stack's leaves (two for the hybrid family's
    (groups, period) stack), none for the MoE family's dense first blocks
    (a list there) and every leaf outside the stack."""
    cfg = model.cfg
    n_prefix = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    lead = 2 if cfg.family == "hybrid" else 1
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "blocks" and int(parts[1]) >= n_prefix
        out[name] = lead if stacked else 0
    return out


def reference_ndims(model: Transformer) -> Dict[str, int]:
    """Each parameter's dimension count in the reference's parameter tree:
    the count AdamW's decay rule (two or more dimensions) reads, so that
    the port decays what the reference decays, a stacked norm scale
    included."""
    params = dict(model.named_parameters())
    return {n: params[n].ndim + lead for n, lead in _stack_lead(model).items()}


def reference_stacks(model: Transformer) -> List[List[str]]:
    """The parameters that form one leaf of the reference's tree, each
    group in layer order: a stacked parameter's per-layer tensors.
    Compression quantizes a group as that one leaf."""
    groups: Dict[str, List[str]] = {}
    for name, lead in _stack_lead(model).items():
        if lead:
            groups.setdefault(name.split(".", 2)[2], []).append(name)
    return [g for g in groups.values() if len(g) > 1]


def init_train_state(model: Transformer, tc: TrainConfig) -> Dict[str, Any]:
    """AdamW's state for ``model``'s parameters, and the error-feedback
    buffers when ``tc.compress_grads``."""
    params = parameters(model)
    state = {"opt": adamw_init(params)}
    if tc.compress_grads:
        state["ef"] = ef_init(params)
    return state


def make_train_step(cfg: ModelConfig, tc: TrainConfig
                    ) -> Callable[[Transformer, Dict[str, Any], Batch],
                                  Tuple[Transformer, Dict[str, Any],
                                        Dict[str, torch.Tensor]]]:
    """The train step of ``cfg`` under ``tc``; raises a ``ValueError`` for
    the kernel route, which has no backward (train on
    ``attention_impl="reference"``)."""
    if cfg.attention_impl == "kernel":
        raise ValueError(
            f"{cfg.name}: attention_impl='kernel' has no backward (the "
            f"port's kernels, like the reference's Pallas kernels, are "
            f"forward-only); train on attention_impl='reference'")
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")

    def grads_of(model: Transformer, params: Dict[str, torch.Tensor],
                 batch: Batch):
        loss, _ = train_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def accum_grads(model, params, batch):
        """Split the batch into ``accum_steps`` microbatches (the leading
        axis reshaped to (n, B/n), as the reference's scan reads it) and
        sum their losses and float32 gradients, then scale by 1/n."""
        n = tc.accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                 for k, v in batch.items()}
        for i in range(n):
            loss, grads = grads_of(model, params,
                                   {k: v[i] for k, v in micro.items()})
            for k, g in grads.items():
                acc[k] += g.float()
            loss_sum = loss_sum + loss
        scale = 1.0 / n
        return loss_sum * scale, {k: g * scale for k, g in acc.items()}

    def train_step(model: Transformer, state: Dict[str, Any], batch: Batch):
        if model.cfg.attention_impl == "kernel":
            raise ValueError(f"{model.cfg.name}: the model is on the "
                             f"kernel route; train on attention_impl="
                             f"'reference'")
        params = parameters(model)
        if tc.accum_steps > 1:
            loss, grads = accum_grads(model, params, batch)
        else:
            loss, grads = grads_of(model, params, batch)
        metrics = {"loss": loss}
        new_state = {}
        if tc.compress_grads:
            grads, new_state["ef"] = compress_decompress(
                grads, state["ef"], reference_stacks(model))
        new_params, new_state["opt"], opt_metrics = adamw_update(
            tc.optimizer, grads, state["opt"], params,
            ndims=reference_ndims(model))
        del grads
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(new_params[name])
        metrics.update(opt_metrics)
        return model, new_state, metrics

    return train_step
