"""The weights of a configuration, made on the device from the seed.

An architecture file's ``spec`` (``chipbench/arch``) lists every weight of
a configuration (name, shape and the scale of its normal draw); the names
are the parameter paths of the serving model, so the same tensors go to
the program and, read as float32, to the plain reference. :func:`make`
draws them all into one flat buffer in the served dtype with a
``torch.Generator`` on the device, in a few large calls, and hands out
views of it (each at a 512-byte boundary).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: a weight: (name, shape, scale of N(0, scale^2))
Weight = Tuple[str, Tuple[int, ...], float]

#: elements of one draw, and the alignment of each view
CHUNK = 1 << 28
ALIGN = 256


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(weights: List[Weight], seed: int, device, dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """Every weight of ``weights``, drawn from ``seed`` on ``device`` in
    ``dtype``: one flat buffer filled by N(0, 1) draws of at most
    :data:`CHUNK` elements, each view then scaled in place."""
    offsets, total = [], 0
    for _, shape, _ in weights:
        offsets.append(total)
        total += -(-numel(shape) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for start in range(0, total, CHUNK):
            flat[start:start + CHUNK].normal_(generator=gen)
        out = {}
        for (name, shape, scale), off in zip(weights, offsets):
            out[name] = flat[off:off + numel(shape)].view(shape).mul_(scale)
    return out
