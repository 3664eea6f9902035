"""Explicit collective schedules over a mesh axis's process group.

The reference writes these with ``shard_map`` where it wants to own the
schedule rather than leave it to GSPMD; the port issues them through
``torch.distributed`` on the groups of a
:class:`~torch.distributed.device_mesh.DeviceMesh`. Each rank passes its
local buffer and gets the reduced one back.

* :func:`ring_allreduce` — bandwidth-optimal ring reduce-scatter then
  all-gather, one send to the next rank and one receive from the previous
  a step, in the reference's chunk order, so each chunk's float32 sum
  adds the ranks' buffers in the reference's order.
* :func:`hierarchical_allreduce` — reduce within pods, then across the
  ``pod`` axis: the 2-level schedule for multi-pod meshes where the links
  between pods are the scarce resource.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a buffer of its
    shape from global rank ``frm``, as one batched pair."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_allreduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` over mesh axis ``axis``, by an
    explicit ring.

    ``x`` is this rank's local buffer: it is flattened and padded to ``n``
    chunks (``n`` the axis size). In ``n - 1`` reduce-scatter steps, step
    ``s`` sends chunk ``(idx - s) % n`` to the next rank and adds what
    arrives from the previous one into chunk ``(idx - s - 1) % n``; after
    them rank ``idx`` owns the whole sum of chunk ``(idx + 1) % n``, which
    ``n - 1`` all-gather steps pass around the ring."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    idx = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    shape, size = x.shape, x.numel()
    flat = x.reshape(-1)
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    acc = flat.reshape(n, -1).clone()
    for step in range(n - 1):
        got = _exchange(acc[(idx - step) % n].clone(), nxt, prv, group)
        acc[(idx - step - 1) % n] += got
    own = (idx + 1) % n
    cur = acc[own].clone()
    for step in range(n - 1):
        cur = _exchange(cur, nxt, prv, group)
        acc[(own - step - 1) % n] = cur
    return acc.reshape(-1)[:size].reshape(shape)


def hierarchical_allreduce(x: torch.Tensor, mesh, *,
                           inner_axis: str = "data",
                           outer_axis: str = "pod") -> torch.Tensor:
    """The sum of ``x`` within pods (``inner_axis``), then across them
    (``outer_axis``, where the mesh has one)."""
    y = x.clone()
    dist.all_reduce(y, group=mesh.get_group(inner_axis))
    if outer_axis in (mesh.mesh_dim_names or ()):
        dist.all_reduce(y, group=mesh.get_group(outer_axis))
    return y
