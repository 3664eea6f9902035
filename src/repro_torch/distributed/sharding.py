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

The bodies that are local to one shard (attention per KV-head group, the
SSD mixer per SSM head, the expert FFN per expert, the embedding per
block of vocabulary rows) run as **regions** (:func:`local_region`): the
placements are declared once at the border, and each rank runs the body
on its plain local tensors through ``local_map``, so no op inside depends
on DTensor's sharding rules, which differ between PyTorch releases.

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


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor inside a sharding context (outside one,
    a thread-local read)."""
    if getattr(_ctx, "state", None) is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


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


#: a region's argument or result spec: per dimension a logical name, None,
#: or ``(name, width)`` for a dimension that packs blocks of ``width``
#: values, one per index of ``name`` (heads merged with their width)
RegionSpec = Tuple[object, ...]

_region = threading.local()


def _region_name(entry) -> Tuple[Optional[str], int]:
    return entry if isinstance(entry, tuple) else (entry, 1)


def _mesh_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of a resolved entry (an axis, a tuple, None)."""
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def _region_axes(mesh, rules: Dict[str, object], specs, shapes,
                 extra: Sequence[str]) -> Dict[str, object]:
    """Each logical name of a region's arguments resolved once: its mesh
    axes (the live ones of its rule) where they divide every dimension
    that carries the name, else None. Names in ``extra`` (the region's
    split axes that no argument carries) resolve by the rules alone."""
    dims: Dict[str, list] = {}
    for spec, shape in zip(specs, shapes):
        for entry, dim in zip(spec, shape):
            name, width = _region_name(entry)
            if name is not None:
                dims.setdefault(name, []).append(dim // width)
    axes = {}
    for name in (*dims, *extra):
        entry = _live(mesh, (rules.get(name),))[0]
        if entry is not None and any(
                d % _axis_size(mesh, entry) for d in dims.get(name, ())):
            entry = None
        axes[name] = entry
    return axes


def region_block(name: str) -> Tuple[int, int]:
    """Inside a region's body (:func:`local_region`): this rank's block
    of the logical axis ``name`` and the number of blocks, ``(index,
    count)`` over the mesh axes the name resolved to there; ``(0, 1)``
    outside a region or where the name is not split."""
    state = getattr(_region, "state", None)
    if state is None:
        return 0, 1
    mesh = state[0]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    index, count = 0, 1
    for a in _mesh_axes(state[1].get(name)):
        index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def local_region(fn, in_logical: Sequence[Optional[RegionSpec]],
                 out_logical: Sequence[RegionSpec],
                 partial: Sequence[str] = ()):
    """``fn`` as a region local to each rank's shard: a callable that,
    outside a :func:`sharding_context` (or with no DTensor argument),
    calls ``fn`` itself. Inside one, each tensor argument ``i`` is placed
    by its logical spec ``in_logical[i]`` (right-aligned; a plain tensor
    enters replicated, as ``implicit_replication()`` reads it, then takes
    its block; None places it replicated), ``fn`` runs on the local
    tensors through ``local_map``
    and its autograd is the backward, and each result is a DTensor placed
    by ``out_logical`` (one full-length spec per result; ``fn`` returns a
    single tensor where there is one spec).

    A logical name resolves once for the whole region: to its rule's mesh
    axes where they divide every dimension carrying the name, else
    replicated (so q's heads replicate with KV heads that cannot shard).
    ``partial`` names the logical axes the body splits its work over: the
    results are ``Partial`` sums over their mesh axes, and a body reads
    its block with :func:`region_block`. The gradient of an argument is a
    partial sum on every split axis it is replicated on. Non-tensor
    arguments pass through."""
    n_out = len(out_logical)

    def call(*args):
        state = getattr(_ctx, "state", None)
        if state is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor
        if not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        try:
            from torch.distributed.tensor.experimental import local_map
        except ImportError as e:       # no op-by-op fallback
            raise ImportError(
                "a sharded region needs torch.distributed.tensor."
                "experimental.local_map; this PyTorch build lacks it") from e
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
        which = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        specs = [_right_align(in_logical[i] or (), args[i].ndim)
                 for i in which]
        axes = _region_axes(mesh, state[1], specs,
                            [args[i].shape for i in which], partial)

        def place(spec):
            return named(mesh, tuple(axes[_region_name(e)[0]]
                                     if _region_name(e)[0] else None
                                     for e in spec)).placements

        names = mesh.mesh_dim_names
        ins = [place(s) for s in specs]
        partial_axes = {a for name in partial for a in _mesh_axes(axes[name])}
        outs = [[Partial() if a in partial_axes else p
                 for a, p in zip(names, place(spec))] for spec in out_logical]
        split = partial_axes | {a for pl in (*ins, *outs)
                                for a, p in zip(names, pl)
                                if isinstance(p, Shard)}
        grads = [tuple(p if isinstance(p, Shard) else
                       Partial() if a in split else Replicate()
                       for a, p in zip(names, pl)) for pl in ins]
        rep = [Replicate()] * mesh.ndim
        tensors = [args[i] if isinstance(args[i], DTensor) else
                   DTensor.from_local(args[i], mesh, rep, run_check=False)
                   for i in which]

        def body(*local):
            full = list(args)
            for i, t in zip(which, local):
                full[i] = t
            prev = getattr(_region, "state", None)
            _region.state = (mesh, axes)
            try:
                return fn(*full)
            finally:
                _region.state = prev

        # one list of placements per result (a tuple of them is many)
        return local_map(body, out_placements=tuple(outs) if n_out > 1
                         else outs[0], in_placements=tuple(ins),
                         in_grad_placements=tuple(grads), device_mesh=mesh,
                         redistribute_inputs=True)(*tensors)

    return call


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
