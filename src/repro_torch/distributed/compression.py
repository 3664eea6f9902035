"""Gradient compression with error feedback, the reference's, in PyTorch.

int8 block quantization: each tensor is quantized per block of 256 values
with a float32 scale (max-abs / 127). The quantization residual is carried
in an error-feedback buffer and added back before the next quantization, so
the scheme is unbiased over time (EF-SGD). The quantize-dequantize pair runs
inside the train step, as in the reference, so convergence is what a
deployment that sends the int8 payload would see.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

BLOCK = 256


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes (n_blocks, BLOCK) and float32 scales (n_blocks, 1) of
    ``g``, zero-padded to whole blocks. ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the codes are the reference's."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                     size: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


def ef_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero float32 error-feedback buffers shaped (and, for a DTensor,
    placed) like the gradients."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


@torch.no_grad()
def compress_decompress(grads: Mapping[str, torch.Tensor],
                        ef_state: Mapping[str, torch.Tensor],
                        stacks: Optional[Sequence[Sequence[str]]] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """int8 error-feedback compression of each gradient: returns the
    restored gradients (in each gradient's dtype; what the optimizer
    consumes) and the new error-feedback buffers (the residuals).

    ``stacks`` lists groups of names that form one leaf of the reference's
    tree (a layer-stacked leaf, its layers in order): a group is quantized
    as one flat vector, so its blocks of 256 run across layer boundaries
    as the reference's do. Where every member's size is a multiple of 256
    the blocks meet those boundaries and the members are quantized one by
    one, with the same result. Other names are leaves of their own."""
    grouped = {n for group in stacks or () for n in group}
    leaves = [list(group) for group in stacks or ()] + \
        [[n] for n in grads if n not in grouped]
    restored_all, ef = {}, {}
    for group in leaves:
        aligned = all(grads[n].numel() % BLOCK == 0 for n in group)
        for members in ([[n] for n in group] if aligned else [group]):
            corrected = torch.cat([(grads[n].float() + ef_state[n])
                                   .reshape(-1) for n in members])
            q, scale = _quantize_leaf(corrected)
            restored = _dequantize_leaf(q, scale, corrected.shape,
                                        corrected.numel())
            residual = corrected - restored
            at = 0
            for n in members:
                g, k = grads[n], grads[n].numel()
                restored_all[n] = restored[at:at + k].reshape(g.shape) \
                    .to(g.dtype)
                ef[n] = residual[at:at + k].reshape(g.shape)
                at += k
    return ({n: restored_all[n] for n in grads}, {n: ef[n] for n in grads})


def compression_ratio() -> float:
    """Wire bytes against float32 (an int8 payload and a float32 scale per
    block)."""
    return (BLOCK * 1 + 4) / (BLOCK * 4)
