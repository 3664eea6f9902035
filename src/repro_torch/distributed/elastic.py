"""Elastic rescaling: move a tree of tensors onto another device or mesh.

Losing a pod (512 -> 256 ranks) or growing back is a re-placement of every
leaf under the *same* partition rules on the new mesh: the specs come from
the rule tables the dry-run proves out, so an elastic restart is exactly
"restore the checkpoint with the new mesh's shardings" (see
:mod:`repro_torch.training.ft` and :mod:`repro_torch.training.checkpoint`).
On one card the target is a device: restoring a checkpoint written on the
card onto the CPU, or back.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..core.executor import resolve_device
from .mesh import NamedSharding
from .sharding import param_shardings


def rescale(tree, target, *,
            shardings: Optional[Mapping[str, NamedSharding]] = None):
    """``tree`` re-placed on ``target``.

    A device (or its name): every tensor of ``tree`` (dicts, lists and
    tuples of tensors) moves there; other leaves stay as they are. A
    :class:`~torch.distributed.device_mesh.DeviceMesh`: ``tree`` maps
    parameter names to tensors, and each becomes a DTensor under
    ``shardings`` (by default :func:`param_shardings` on the mesh); a
    DTensor leaf is gathered to its global value first. Every rank of the
    world calls it with the same ``tree``."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(target, DeviceMesh):
        from torch.distributed.tensor import DTensor, distribute_tensor
        full = {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in tree.items()}
        sh = shardings if shardings is not None \
            else param_shardings(target, full)
        return {k: distribute_tensor(v, sh[k].mesh, sh[k].placements)
                for k, v in full.items()}
    dev = resolve_device(str(target))

    def move(node):
        if isinstance(node, torch.Tensor):
            return node.to(dev)
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        return node
    return move(tree)


def set_parameters(model: torch.nn.Module, tensors: Mapping) -> None:
    """Make ``tensors[name]`` (a placement's DTensors, say) ``model``'s
    parameter ``name``, each wrapped as a new ``nn.Parameter``."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(t))


def surviving_mesh(mesh, lost_axis: str = "pod"):
    """The mesh that remains after losing one slice along ``lost_axis``:
    the ranks at index 0 of that axis, the axis dropped; ``mesh`` itself
    where it has no such axis. With the production (pod=2, data=16,
    model=16) mesh, losing a pod leaves the single-pod (data=16, model=16)
    mesh. Building a mesh creates its process groups, so every rank of the
    world calls it; a rank outside the result finds
    ``get_coordinate()`` None on it."""
    names = tuple(mesh.mesh_dim_names or ())
    if lost_axis not in names:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh.select(names.index(lost_axis), 0)
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=tuple(n for n in names
                                           if n != lost_axis))
