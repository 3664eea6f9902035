"""The reference's explicit collectives on 4 forced host devices.

``python tests/helpers/collectives_reference.py OUT.npz`` (with ``src`` on
the path) draws the inputs from a NumPy seed, runs the reference's
``ring_allreduce`` over a (data=4) mesh and ``hierarchical_allreduce``
over a (pod=2, data=2) mesh, and writes the inputs, each device's output
and the device ids of ``surviving_mesh`` to ``OUT.npz``. The device count
is latched when JAX starts, so this runs in a process of its own.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.distributed.collectives import (  # noqa: E402
    hierarchical_allreduce, ring_allreduce)
from repro.distributed.elastic import surviving_mesh  # noqa: E402

#: each rank's local buffer: 15 values (not a multiple of 4: the ring
#: pads) and 8 x 8
RING_SHAPES = {"ring_odd": (5, 3), "ring_even": (8, 8)}
HIER_SHAPE = (6, 7)


def per_device(arr: np.ndarray, devices, sharding, shape):
    """A global array of ``shape`` whose shard on device i is ``arr[i]``
    (under a replicated sharding each device holds its own buffer all the
    same: the reference's shard_map reads each device's local value)."""
    shards = [jax.device_put(arr[i], d) for i, d in enumerate(devices)]
    return jax.make_array_from_single_device_arrays(shape, sharding, shards)


def shards_of(y) -> np.ndarray:
    """Each device's shard of ``y``, in device order."""
    return np.stack([np.asarray(s.data) for s in sorted(
        y.addressable_shards, key=lambda s: s.device.id)])


def main(out: str) -> None:
    devs = jax.devices()[:4]
    rng = np.random.default_rng(24)
    res = {}
    ring = Mesh(np.asarray(devs), ("data",))
    for name, shape in RING_SHAPES.items():
        x = rng.standard_normal((4,) + shape).astype(np.float32)
        glob = per_device(x, devs, NamedSharding(ring, P("data")),
                          (4 * shape[0],) + shape[1:])
        res[name + "_in"] = x
        res[name + "_out"] = shards_of(ring_allreduce(glob, ring, "data"))
    pd = Mesh(np.asarray(devs).reshape(2, 2), ("pod", "data"))
    x = rng.standard_normal((4,) + HIER_SHAPE).astype(np.float32)
    res["hier_in"] = x
    res["hier_out"] = shards_of(hierarchical_allreduce(
        per_device(x, devs, NamedSharding(pd, P()), HIER_SHAPE), pd))
    res["surviving_ids"] = np.asarray(
        [d.id for d in surviving_mesh(pd).devices.flat])
    res["surviving_axes"] = np.asarray(surviving_mesh(pd).axis_names)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
