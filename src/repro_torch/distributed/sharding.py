"""Sharding rules: logical axes -> mesh axes, param specs, activation hooks.

The reference's two mechanisms, on PyTorch's DTensor:

* **Parameter specs** — :func:`param_specs` matches each of a model's
  ``named_parameters()`` names (``.`` read as ``/``) against
  :data:`PARAM_RULES`, right-aligned. The reference stacks each layer's
  leaves under leading layer axes, which its specs pad with ``None``; the
  port's per-layer tensors are those leaves without the layer axes, so
  its specs are the reference's with those leading ``None``\\ s dropped.
  :func:`param_shardings` turns them into DTensor placements on a
  :class:`~torch.distributed.device_mesh.DeviceMesh`.
* **Activation hooks** — models call :func:`shard` with *logical* axis
  names; inside a :func:`sharding_context` these resolve through
  :data:`LOGICAL_RULES` and a DTensor activation is redistributed to the
  result; outside any context they return their input (single-device runs
  never see a mesh).

A spec (:data:`~repro_torch.distributed.mesh.Spec`) is a tuple with one
entry per tensor dimension: a mesh axis, a tuple of axes, or ``None``.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from .mesh import NamedSharding, Spec, mesh_shape, named

# --------------------------------------------------------------------------
# logical activation axes
# --------------------------------------------------------------------------
#: logical name -> mesh axis (or tuple of axes, or None = replicated)
LOGICAL_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "ssm_heads": "model",
    "state": None,
    "kv_seq": None,
    "latent": None,
    # Fallback axis for KV caches whose head count cannot shard on "model"
    # (GQA kv_heads < TP degree). None = replicate (baseline); the §Perf
    # hillclimb maps it to "model" (sequence-sharded KV, partial-score
    # attention).
    "kv_seq_model": None,
}

_ctx = threading.local()


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[Dict[str, object]] = None):
    """Resolve :func:`shard`'s logical axes on ``mesh`` (with ``rules``
    over :data:`LOGICAL_RULES`). The outermost context also enters DTensor's
    ``implicit_replication()``: the plain tensors a model creates (RoPE
    tables, masks, positions) and the batch meet DTensor parameters as
    replicated values. Every rank holds the same such tensor, so that
    reading is true."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, {**LOGICAL_RULES, **(rules or {})})
    try:
        if prev is None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.state = prev


def current_mesh():
    state = getattr(_ctx, "state", None)
    return state[0] if state else None


def _resolve(mesh, rules: Dict[str, object],
             logical: Sequence[Optional[str]]) -> Spec:
    return _live(mesh, tuple(None if name is None else rules.get(name)
                             for name in logical))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= shape[a]
        return n
    return shape[entry]


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop spec axes whose mesh extent does not divide the dim (e.g. a
    504-way vocab on a 16-way model axis, or 8 KV heads on 16 TP ranks —
    those dims stay replicated)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return tuple(out)


def _right_align(logical: Sequence, ndim: int) -> Tuple:
    logical = tuple(logical)
    if len(logical) > ndim:
        return logical[-ndim:] if ndim else ()
    return (None,) * (ndim - len(logical)) + logical


def shard(x, *logical: Optional[str]):
    """Constrain activation ``x`` to the logical axes: ``x`` itself without
    a context. Inside one, the spec right-aligns to x's rank, non-dividing
    axes fall back to replicated, and a DTensor is redistributed to the
    spec's placements; a plain tensor is this rank's whole value and is
    returned as it is."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = state
    spec = sanitize_spec(mesh, _resolve(mesh, rules,
                                        _right_align(logical, x.ndim)),
                         x.shape)
    placements = named(mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def split_dim(x, dim: int, *sizes: int):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape). Inside
    a context, a DTensor that shards ``dim`` over more ranks than
    ``sizes[0]`` divides by is first replicated on it: DTensor cannot split
    such a dimension (GSPMD reshards there on its own), and the hook after
    the split would replicate the smaller dimension anyway."""
    dim = dim % x.ndim
    if getattr(_ctx, "state", None) is not None:
        x = _splittable(x, dim, sizes[0])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def _splittable(x, dim: int, lead: int):
    """``x``, replicated on ``dim`` where it is a DTensor sharding ``dim``
    over more ranks than ``lead`` divides by."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    ways = 1
    for p, n in zip(x.placements, mesh_shape(x.device_mesh).values()):
        ways *= n if isinstance(p, Shard) and p.dim == dim else 1
    if lead % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


class _MergeLast(torch.autograd.Function):
    """The last two dimensions merged; the gradient split back through
    :func:`_splittable` (the backward may run on another thread, outside
    the context's thread-local state)."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, grad):
        grad = _splittable(grad, grad.ndim - 1, ctx.sizes[0])
        return grad.reshape(*grad.shape[:-1], *ctx.sizes)


def merge_last(x):
    """``x`` with its last two dimensions (heads and their width) merged, a
    reshape. Inside a context its gradient is split as :func:`split_dim`
    splits: the plain reshape's backward would ask DTensor for the split
    it cannot make."""
    if getattr(_ctx, "state", None) is None:
        return x.reshape(*x.shape[:-2], -1)
    return _MergeLast.apply(x)


# --------------------------------------------------------------------------
# parameter sharding rules (right-aligned patterns)
# --------------------------------------------------------------------------
#: (path regex, right-aligned spec). First match wins.
PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed/table$", ("model", None)),
    (r"frontend/", (None,)),
    (r"experts/(gate|up)/w$", ("model", "data", None)),
    (r"experts/down/w$", ("model", None, "data")),
    (r"router/w$", (None, None)),
    (r"(wq|wk|wv|wuq)/w$", ("data", "model")),
    (r"(wq|wk|wv|wuq)/b$", ("model",)),
    (r"(gate|up)/w$", ("data", "model")),
    (r"(wo|down)/w$", ("model", "data")),
    (r"(wo|down)/b$", (None,)),
    (r"wdkv/w$", ("data", None)),
    (r"(wuk|wuv)/w$", (None, "model")),
    (r"lm_head/w$", ("data", "model")),
    (r"(in_z|in_x)/w$", ("data", "model")),
    (r"(in_bc|in_dt)/w$", ("data", None)),
    (r"conv_x_w$", (None, "model")),
    (r"out_proj/w$", ("model", "data")),
    (r"proj/w$", (None, "data")),
    # norms, scalars, conv/bias leftovers: replicated
    (r".*", (None,)),
)


def _spec_for(path: str, ndim: int) -> Spec:
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, path):
            return _right_align(spec, ndim)
    return (None,) * ndim  # pragma: no cover


def _named_tensors(tree) -> Dict[str, torch.Tensor]:
    """A model's ``named_parameters()``, or a flat mapping of names to
    tensors (such as :func:`repro_torch.training.train.parameters`)."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def param_specs(tree) -> Dict[str, Spec]:
    """Each parameter's spec, by name: ``tree`` is a model or a mapping of
    dotted parameter names to tensors."""
    return {name: _spec_for(name.replace(".", "/"), t.ndim)
            for name, t in _named_tensors(tree).items()}


def _live(mesh, spec: Spec) -> Spec:
    """``spec`` without the axes ``mesh`` lacks (a tuple keeps the ones it
    has)."""
    names = mesh_shape(mesh)
    out = []
    for entry in spec:
        if isinstance(entry, tuple):
            live = tuple(a for a in entry if a in names)
            entry = live if len(live) > 1 else (live[0] if live else None)
        elif entry not in names:
            entry = None
        out.append(entry)
    return tuple(out)


def param_shardings(mesh, tree) -> Dict[str, NamedSharding]:
    """Each parameter's spec on ``mesh``, sanitized, and its placements.
    An axis the mesh lacks replicates, as :func:`shard`'s logical axes do
    (the reference's rule needs every axis a spec names)."""
    tensors = _named_tensors(tree)
    return {name: named(mesh, sanitize_spec(mesh, _live(mesh, spec),
                                            tensors[name].shape))
            for name, spec in param_specs(tensors).items()}


# --------------------------------------------------------------------------
# decode-cache sharding rules (logical axes, resolved against the mesh)
# --------------------------------------------------------------------------
#: (path regex, ordered list of right-aligned LOGICAL spec alternatives).
#: The first alternative whose every named axis divides the leaf is used —
#: e.g. a GQA cache with 8 KV heads on a 16-way model axis cannot
#: head-shard, so it falls back to sharding the *sequence* dim on "model"
#: (partial-score attention). This is what keeps per-device KV traffic at
#: cache/256 instead of replicating the cache — the dominant decode
#: roofline term.
CACHE_RULES: Tuple[Tuple[str, Tuple[Tuple, ...]], ...] = (
    (r"(^|/)(k|v)$", (("batch", None, "kv_heads", None),
                      ("batch", "kv_seq_model", None, None))),
    (r"c_kv$", (("batch", "kv_seq_model", None),)),
    (r"k_rope$", (("batch", "kv_seq_model", None),)),
    (r"conv_x$", (("batch", None, "ssm_heads"),)),
    (r"conv_bc$", (("batch", None, None),)),
    (r"ssd$", (("batch", "ssm_heads", None, None),)),
    (r"index$", ((),)),
    (r".*", (("batch", None, None),)),
)


def _shape_of(leaf) -> Tuple[int, ...]:
    """A cache leaf's shape; the port's ``index`` is a Python int (the
    reference's a 0-d array)."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def cache_specs(mesh, cache: Mapping[str, object],
                rules: Optional[Dict[str, object]] = None) -> Dict[str, Spec]:
    """Each decode-cache leaf's spec, by key (leaves right-aligned)."""
    table = {**LOGICAL_RULES, **(rules or {})}

    def _try(logical, shape):
        spec = _resolve(mesh, table, _right_align(logical, len(shape)))
        ok = all(e is None or dim % _axis_size(mesh, e) == 0
                 for dim, e in zip(shape, spec))
        return spec, ok

    def leaf_spec(key: str, shape) -> Spec:
        for pattern, alternatives in CACHE_RULES:
            if re.search(pattern, key):
                first = None
                for logical in alternatives:
                    spec, ok = _try(logical, shape)
                    if first is None:
                        first = spec
                    if ok:
                        return spec
                return sanitize_spec(mesh, first, shape)
        return (None,) * len(shape)  # pragma: no cover

    return {key: leaf_spec(key, _shape_of(leaf))
            for key, leaf in cache.items()}


def cache_shardings(mesh, cache: Mapping[str, object],
                    rules: Optional[Dict[str, object]] = None
                    ) -> Dict[str, NamedSharding]:
    """Each decode-cache leaf's sanitized spec and placements on ``mesh``."""
    return {key: named(mesh, sanitize_spec(mesh, spec,
                                           _shape_of(cache[key])))
            for key, spec in cache_specs(mesh, cache, rules).items()}
