"""Mesh axis conventions: the model-parallel axes and the sweep stack's
scenario axis.

Model-parallel axes (the reference's):

* ``pod``   — across pods (pure data parallelism; gradient all-reduce
  only);
* ``data``  — within-pod batch/FSDP axis;
* ``model`` — tensor/expert parallel axis.

Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2, data=16,
model=16) = 512 (:mod:`repro_torch.launch.mesh`). The port's mesh is
PyTorch's own :class:`~torch.distributed.device_mesh.DeviceMesh`, its axis
names the ``mesh_dim_names``. The spec helpers also take an *abstract*
mesh, axis names with their sizes and no process group: a mapping
``{"data": 4, "model": 4}`` or an object whose ``shape`` is one (the
reference's tests pass such an object); :func:`mesh_shape` reads either.

The scenario axis: one row of a
:class:`~repro_torch.dsp.simulator.BatchState` (or one GP or forecaster
bank member) sits at each position of the ``scenario`` axis.
Scenarios are independent, so work laid out on this axis partitions with
no communication at all: each partition is a contiguous block of rows on
its own device, stepped by its own calls.

The scenario axis needs no process group: :func:`scenario_mesh` returns
the list of :class:`torch.device` the axis spans. On ``"cuda"`` those are the visible
cards; on ``"cpu"`` they are ``n`` copies of the CPU, the host partitions
that let one machine run the partitioned code paths. Their count is
``REPRO_TORCH_HOST_DEVICES`` (default 1), read whenever a mesh is built,
so a test can set it with ``monkeypatch`` and needs no subprocess.
"""
from __future__ import annotations

import os
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import torch

POD, DATA, MODEL = "pod", "data", "model"

#: logical activation axes: the batch shards over pod and data
BATCH_AXES: Tuple[str, ...] = (POD, DATA)

#: a partition spec: one entry per tensor dimension, a mesh axis, a tuple
#: of axes or None (replicated); right-aligned where shorter than the tensor
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`DeviceMesh` (its
    ``mesh_dim_names``) or of an abstract mesh: a mapping, or an object
    whose ``shape`` is a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or shape is None:
        raise TypeError(f"a mesh is a DeviceMesh with mesh_dim_names, a "
                        f"mapping of axis names to sizes, or an object whose "
                        f"shape is one; got {mesh!r}")
    return dict(zip(names, (int(n) for n in shape)))


def batch_spec(mesh) -> Spec:
    """The spec of a leading batch dimension on this mesh: the batch axes
    it has, a tuple where there are two."""
    axes = tuple(a for a in BATCH_AXES if a in mesh_shape(mesh))
    return (axes if len(axes) > 1 else axes[0] if axes else None,)


class NamedSharding(NamedTuple):
    """A spec on a mesh and its DTensor placements, one per mesh axis: the
    counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]


def named(mesh, spec: Spec) -> NamedSharding:
    """``spec`` on ``mesh``: mesh axis by mesh axis, ``Shard(d)`` where
    tensor dimension ``d`` names that axis (alone or inside a tuple), else
    ``Replicate()``. Where a tuple names several axes on one dimension,
    the first is the major one, as in JAX; DTensor splits a dimension over
    its mesh axes in mesh order, so the tuple must list them in that
    order."""
    from torch.distributed.tensor import Replicate, Shard
    axes = list(mesh_shape(mesh))
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if [a for a in axes if a in names] != [a for a in names
                                               if a is not None]:
            raise ValueError(f"spec {spec}: dimension {d} names {entry}, "
                             f"not axes of {axes} in mesh order")
        for a in names:
            if a is not None:
                where[a] = d
    return NamedSharding(mesh, tuple(spec), tuple(
        Shard(where[a]) if a in where else Replicate() for a in axes))


def has_pod_axis(mesh) -> bool:
    return POD in mesh_shape(mesh)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


# --------------------------------------------------------------------------
# scenario meshes (sharded sweep / bank stack)
# --------------------------------------------------------------------------

#: The sweep-engine batch axis (see module docstring).
SCENARIO = "scenario"

#: Environment variable giving the number of CPU host partitions.
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


def host_device_count() -> int:
    """The number of CPU host partitions (``REPRO_TORCH_HOST_DEVICES``,
    default 1)."""
    raw = os.environ.get(HOST_DEVICES_ENV, "1")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{HOST_DEVICES_ENV} must be a positive integer, "
                         f"got {raw!r}") from None
    if n < 1:
        raise ValueError(f"{HOST_DEVICES_ENV} must be a positive integer, "
                         f"got {raw!r}")
    return n


def visible_device_count(device: Union[str, torch.device] = "cuda") -> int:
    """How many devices of ``device``'s kind a scenario mesh may span: the
    visible cards for CUDA, the host partitions for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return host_device_count()
    raise ValueError(f"device must be a cuda or cpu device, got {device!r}")


def device_count_hint(device: Union[str, torch.device] = "cuda") -> str:
    """The remedy for "not enough devices" errors, for ``device``'s kind."""
    if torch.device(device).type == "cpu":
        return (f"set {HOST_DEVICES_ENV}=N to split the CPU into N host "
                f"partitions")
    return (f"this machine shows {torch.cuda.device_count()} CUDA device(s) "
            f"(torch.cuda.device_count()); run on a machine with more cards, "
            f"or pass device='cpu' with {HOST_DEVICES_ENV}=N host partitions")


def scenario_mesh(devices: Optional[int] = None,
                  device: Union[str, torch.device] = "cuda"
                  ) -> List[torch.device]:
    """The devices of a flat ``scenario`` axis.

    ``devices=None`` takes every visible device of ``device``'s kind; a
    count takes the first ``devices`` of them (starting at ``device``'s
    index where it names one). Raises a :class:`ValueError` with the
    remedy when more devices are requested than are visible.
    """
    dev = torch.device(device)
    visible = visible_device_count(dev)
    start = dev.index or 0
    n = visible - start if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"scenario mesh needs at least 1 device, got "
                         f"devices={devices!r} ({visible} {dev.type} "
                         f"device(s) visible)")
    if start + n > visible:
        raise ValueError(
            f"devices={n} requested but only {visible} {dev.type} device(s) "
            f"visible; {device_count_hint(dev)}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", start + i) for i in range(n)]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest ``m >= n`` with ``m % multiple == 0`` (ragged-grid padding:
    a scenario axis divides evenly over the mesh)."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    return -(-n // multiple) * multiple


def partition_bounds(n_rows: int, n_parts: int) -> List[range]:
    """The contiguous row blocks of ``n_rows`` over ``n_parts`` partitions
    (the first ``n_rows % n_parts`` blocks one row longer)."""
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    base, extra = divmod(n_rows, n_parts)
    out, lo = [], 0
    for p in range(n_parts):
        hi = lo + base + (p < extra)
        out.append(range(lo, hi))
        lo = hi
    return out


def force_host_device_env(env: Mapping[str, str], n_devices: int
                          ) -> dict:
    """A copy of ``env`` with the host partition count forced to
    ``n_devices`` (the counterpart of the reference's
    ``force_host_device_flags``: every other variable is kept)."""
    out = dict(env)
    out[HOST_DEVICES_ENV] = str(int(n_devices))
    return out
