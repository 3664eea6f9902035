"""Checkpoints in the reference's layout, written by a background thread.

A checkpoint is a directory ``step_<10 digits>`` of ``leaf_<5 digits>.npy``
files, one per tensor of the saved tree in the reference's flattening
order (dict keys sorted, lists in order), and a ``manifest.json`` with the
step, each leaf's dtype and the leaf count. A dtype NumPy lacks (bfloat16)
is stored as its raw bytes (``uint8``) with the dtype named in the
manifest. Saves copy every leaf to the host before :meth:`save` returns,
then a writer thread writes them to ``<path>.tmp`` and renames it into
place (the train loop keeps stepping while the files are written) and keeps
the newest ``keep`` checkpoints. :meth:`restore` reads a checkpoint back
onto the devices of a ``like`` tree, or onto a mesh's shardings: a restart
on another device or mesh is a restore (see
:func:`repro_torch.distributed.elastic.rescale`).

A DTensor leaf is saved as its global value (``full_tensor()``, as the
reference writes the global ``jax.Array``), a collective that every rank
of its mesh makes; where ranks share the directory, only the manager made
with ``writer=True`` writes.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.executor import resolve_device

#: dtypes NumPy cannot hold, stored as raw bytes
_RAW = {"bfloat16": torch.bfloat16}


def _flatten(tree) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples, in the reference's
    (JAX's) order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(like, leaves: List[Any]):
    """``leaves`` in the structure of ``like`` (the inverse of
    :func:`_flatten`; each dict keeps ``like``'s key order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)
    return build(like)


def _to_host(leaf):
    """A host copy of one leaf: a CPU tensor for a tensor (the global
    value of a DTensor), an array for anything else."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _shardings_like(like, shardings) -> List[Any]:
    """``shardings`` (a tree that follows ``like`` as far as it goes: a
    missing key or None leaves the subtree unsharded) as one entry per leaf
    of ``like``, in :func:`_flatten`'s order."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _shardings_like(
            like[k], shardings.get(k) if isinstance(shardings, dict)
            else None)]
    if isinstance(like, (list, tuple)):
        return [s for i, item in enumerate(like) for s in _shardings_like(
            item, shardings[i] if isinstance(shardings, (list, tuple))
            else None)]
    return [shardings]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The array written for a host leaf and the dtype the manifest names."""
    if isinstance(leaf, torch.Tensor):
        for name, dt in _RAW.items():
            if leaf.dtype == dt:
                return leaf.contiguous().view(torch.uint8).numpy(), name
        leaf = leaf.numpy()
    return leaf, str(leaf.dtype)


class CheckpointManager:
    """Asynchronous checkpoint writer and restorer."""

    def __init__(self, directory: str, *, keep: int = 3,
                 writer: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> str:
        """Snapshot ``tree`` (dicts and lists of tensors or arrays) at
        ``step``. Every leaf is copied to the host here; the files are
        written on the writer thread unless ``blocking``; a manager that is
        not the writer gathers its DTensor leaves and writes nothing."""
        host = [_to_host(leaf) for leaf in _flatten(tree)]
        path = os.path.join(self.directory, f"step_{step:010d}")
        if not self.writer:
            return path
        with self._lock:
            self._pending += 1
        self._queue.put((path, step, host))
        if blocking:
            self.wait()
        return path

    def _drain(self) -> None:
        while True:
            path, step, host = self._queue.get()
            try:
                self._write(path, step, host)
            finally:
                with self._lock:
                    self._pending -= 1
                self._queue.task_done()

    def _write(self, path: str, step: int, host: List[Any]) -> None:
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        dtypes = {}
        for i, leaf in enumerate(host):
            name = f"leaf_{i:05d}"
            arr, dtypes[name] = _to_numpy(leaf)
            np.save(os.path.join(tmp, name + ".npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "dtypes": dtypes,
                       "n_leaves": len(host)}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until every queued save is on disk."""
        self._queue.join()

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._pending

    # -- restore -----------------------------------------------------------
    def list_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like=None,
                device: str = "cuda", shardings=None) -> Tuple[int, Any]:
        """Load checkpoint ``step`` (the newest by default) in the structure
        of ``like``: each leaf goes to the device of its ``like`` tensor, or
        to ``device`` (the card unless the caller passes ``"cpu"``) where
        the ``like`` leaf is not a tensor. ``shardings`` (a tree over
        ``like``'s of :class:`~repro_torch.distributed.mesh.NamedSharding`,
        see :func:`_shardings_like`) places a leaf as a DTensor on its
        sharding's mesh instead (``distribute_tensor``: every rank of that
        mesh restores)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if like is None:
            raise ValueError("restore() needs a `like` tree for structure")
        like_leaves = _flatten(like)
        fallback = (None if all(isinstance(x, torch.Tensor)
                                for x in like_leaves)
                    else resolve_device(device))
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["n_leaves"] != len(like_leaves):
            raise ValueError(f"checkpoint {step} holds {manifest['n_leaves']}"
                             f" leaves, `like` has {len(like_leaves)}")
        placed = _shardings_like(like, shardings)
        leaves = []
        for i, ref in enumerate(like_leaves):
            name = f"leaf_{i:05d}"
            t = torch.from_numpy(np.load(os.path.join(path, name + ".npy")))
            want = manifest["dtypes"][name]
            if want in _RAW:
                t = t.view(_RAW[want])
            if placed[i] is not None:
                from torch.distributed.tensor import distribute_tensor
                sh = placed[i]
                leaves.append(distribute_tensor(
                    t.to(sh.mesh.device_type), sh.mesh, sh.placements))
                continue
            dev = ref.device if isinstance(ref, torch.Tensor) else fallback
            leaves.append(t.to(dev))
        return step, _unflatten(like, leaves)
