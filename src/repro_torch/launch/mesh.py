"""Mesh construction over an existing process group (no device access at
import).

A :class:`~torch.distributed.device_mesh.DeviceMesh` spans the ranks of
the default process group, which the caller starts first
(``torch.distributed.init_process_group``: NCCL on the cards, gloo on the
CPU, a fake group for the dry-run), with a world size equal to the mesh's
size.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

from ..core.executor import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with a ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` on ``device``'s kind (the cards
    unless the caller passes ``"cpu"``) over the default process group,
    whose world size must be ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    size = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of shape {shape} needs a process group of world size "
            f"{size}; none is started (torch.distributed."
            f"init_process_group)")
    if dist.get_world_size() != size:
        raise ValueError(f"a mesh of shape {shape} ({size} ranks) needs a "
                         f"process group of world size {size}; this one has "
                         f"{dist.get_world_size()}")
    kind = resolve_device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)
