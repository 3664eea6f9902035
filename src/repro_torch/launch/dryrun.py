"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on
shapes alone, one rank of the production mesh.

Proves the distribution config is coherent without hardware: starts a
fake process group of 256 (or 512) ranks in this process, builds the
production mesh on it, places the cell's parameters, optimizer state,
inputs and cache as DTensors on the ``meta`` device under the sharding
rules (nothing is allocated), runs the cell's step on the plain attention
route (``train_loss`` with backward and AdamW, ``prefill``/``encode``, or
``decode_step``) and records this rank's FLOPs, the collectives DTensor
issued and this rank's argument bytes.

Eager PyTorch has no compiler analysis, so the reference's
``bytes_accessed`` and output, temp and peak bytes are ``null`` and its
``compile_s`` is ``trace_s``, the wall of the traced step. Layers are a
Python loop, so every layer is counted (the reference needs ``--unroll``
for that).

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek_7b --shape train_4k \\
        --mesh single --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --all       # every supported cell
    python -m repro_torch.launch.dryrun --smoke --mesh multi \\
        --shape train_4k --arch deepseek_moe_16b mamba2_1p3b

``--smoke`` runs each arch's smoke config (``configs.smoke_config``) in
place of its published one. A cell's ``trace_s`` includes DTensor's first
pass over the ops that this process has not seen yet, so it depends on the
cells run before it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config, smoke_config
from ..distributed.elastic import rescale, set_parameters
from ..distributed.mesh import batch_spec, named
from ..distributed.sharding import (cache_shardings, sanitize_spec,
                                    sharding_context)
from ..models import decode_step, encode, prefill
from ..models.config import ModelConfig
from ..training.train import (TrainConfig, init_train_state, make_train_step,
                              parameters)
from .mesh import make_production_mesh
from .specs import SHAPES, cell_supported, input_specs

#: the reference's collective names, each the sum of its ops' result bytes
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional-collective op name prefixes -> the reference's names
_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("permute", "collective-permute"))

#: ``_c10d_functional`` ops that move no data: the wait on a collective's
#: result and its autograd wrapper
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class CellCensus(TorchDispatchMode):
    """This rank's work under DTensor: every op on local tensors (DTensor
    ops are handed to DTensor, which runs them on its local shards; the
    fake tensors of its shape propagation are skipped). Counts FLOPs by
    ``torch.utils.flop_counter``'s table (``FlopCounterMode``'s) and the
    result bytes of each ``_c10d_functional`` collective under the
    reference's names (``collective_bytes``); a collective outside them
    counts under its own op name."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.collective_bytes: Dict[str, int] = {c: 0 for c in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:      # the local op DTensor ran: name it
            raise RuntimeError(f"{func}: {e}") from e
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional" \
                and func._opname not in _NOT_COLLECTIVES:
            kind = next((k for p, k in _KINDS if func._opname.startswith(p)),
                        func._opname)
            self.collective_bytes[kind] = \
                self.collective_bytes.get(kind, 0) + _nbytes(out)
        return out


def _fake_store():
    """PyTorch's fake process group store: a private testing module, the
    one in-process stand-in for a cluster."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(
            "the dry-run needs torch.testing._internal.distributed.fake_pg "
            "(PyTorch's fake process group); this PyTorch build lacks it"
        ) from e
    return FakeStore()


def _local_bytes(t) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _place(t: torch.Tensor, sharding):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def _batch_sharding(mesh, t: torch.Tensor):
    """The leading dim over the batch axes where they divide it, else
    replicated (the reference's ``_batch_shard``)."""
    return named(mesh, sanitize_spec(mesh, batch_spec(mesh), t.shape))


def lower_cell(arch: str, shape: str, *, multi_pod: bool,
               cfg_override: Optional[ModelConfig] = None,
               logical_rules: Optional[Dict[str, object]] = None
               ) -> Dict[str, object]:
    """Run one cell on one rank of a fake 256- or 512-rank group; returns
    its record. Refuses to start while a process group is up; destroys
    its own when done."""
    cfg = cfg_override or get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "a process group is already up")
    cfg = cfg.scaled(attention_impl="reference")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.perf_counter()
        spec = input_specs(cfg, shape)
        kind, model = spec["kind"], spec["params"]
        set_parameters(model, rescale(parameters(model), mesh))
        inputs = {k: _place(v, _batch_sharding(mesh, v))
                  for k, v in spec["inputs"].items()}
        cache = spec.get("cache")
        if cache is not None:
            placed = cache_shardings(mesh, cache, logical_rules)
            cache = {k: v if not isinstance(v, torch.Tensor)
                     else _place(v, placed[k]) for k, v in cache.items()}
        args = [*parameters(model).values(), *inputs.values(),
                *(() if cache is None else cache.values())]
        census = CellCensus()
        with sharding_context(mesh, logical_rules), census:
            if kind == "train":
                state = init_train_state(model, TrainConfig())
                args += [*state["opt"]["m"].values(),
                         *state["opt"]["v"].values(), state["opt"]["step"]]
                make_train_step(cfg, TrainConfig())(model, state, inputs)
            elif kind == "prefill" and cache is not None:
                prefill(model, inputs["tokens"], cache,
                        patches=inputs.get("patches"))
            elif kind == "prefill":
                encode(model, inputs)
            else:
                decode_step(model, inputs["tokens"], cache)
        trace_s = time.perf_counter() - t0
        coll = census.collective_bytes
        return {
            "arch": arch, "shape": shape, "mesh": mesh_name,
            "status": "ok",
            "devices": dist.get_world_size(),
            "trace_s": round(trace_s, 1),
            "flops": census.flops,
            "bytes_accessed": None,
            "collective_bytes": coll,
            "collective_total": int(sum(coll.values())),
            "memory": {"argument_bytes": sum(_local_bytes(a) for a in args),
                       "output_bytes": None, "temp_bytes": None,
                       "peak_bytes": None},
        }
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], nargs="+",
                    default=["all"])
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--all", action="store_true",
                    help="every cell (the default of --arch and --shape)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config, not its published one")
    args = ap.parse_args()

    archs = ARCH_IDS if "all" in args.arch else args.arch
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                key = (f"{arch}/{shape}/{'multi' if multi else 'single'}"
                       + ("/smoke" if args.smoke else ""))
                if results.get(key, {}).get("status") == "ok":
                    print(f"[skip cached] {key}")
                    continue
                print(f"[lower] {key}", flush=True)
                try:
                    rec = lower_cell(arch, shape, multi_pod=multi,
                                     cfg_override=smoke_config(arch)
                                     if args.smoke else None)
                except Exception as e:  # record, keep going
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = rec["status"]
                extra = (f" flops={rec['flops']:.3e}"
                         f" coll={rec['collective_total']:.3e}"
                         f" trace={rec['trace_s']}s"
                         if status == "ok" else
                         f" {rec.get('reason', rec.get('error', ''))[:120]}")
                print(f"  -> {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
