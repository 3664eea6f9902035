"""The scenario axis of the sweep stack, laid out over devices.

One row of a :class:`~repro_torch.dsp.simulator.BatchState` (or one GP or
forecaster bank member) sits at each position of the ``scenario`` axis.
Scenarios are independent, so work laid out on this axis partitions with
no communication at all: each partition is a contiguous block of rows on
its own device, stepped by its own calls.

PyTorch has no mesh object: :func:`scenario_mesh` returns the list of
:class:`torch.device` the axis spans. On ``"cuda"`` those are the visible
cards; on ``"cpu"`` they are ``n`` copies of the CPU, the host partitions
that let one machine run the partitioned code paths. Their count is
``REPRO_TORCH_HOST_DEVICES`` (default 1), read whenever a mesh is built,
so a test can set it with ``monkeypatch`` and needs no subprocess.

The model-parallel helpers of the reference's module (``batch_spec``,
``named``, ``has_pod_axis``) belong to the multi-GPU training slice and
are not here yet.
"""
from __future__ import annotations

import os
from typing import List, Mapping, Optional, Union

import torch

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
