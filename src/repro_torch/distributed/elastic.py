"""Elastic restarts on one card: re-placing a tree on another device.

The reference re-places a sharded tree onto a new mesh (losing a pod or
growing back) under the same partition rules. The port runs on one card,
so its counterpart is a move of every tensor to another device: restoring
a checkpoint written on the card onto the CPU, or back. The reference's
``surviving_mesh`` waits for the multi-GPU port.
"""
from __future__ import annotations

import torch

from ..core.executor import resolve_device


def rescale(tree, device):
    """``tree`` (dicts, lists and tuples of tensors) with every tensor on
    ``device``; other leaves as they are."""
    dev = resolve_device(str(device))

    def move(node):
        if isinstance(node, torch.Tensor):
            return node.to(dev)
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        return node
    return move(tree)
