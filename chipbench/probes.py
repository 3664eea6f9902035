"""Instrumentation placed from outside the program: wrappers around its
entry points, installed for one window and taken off after it.

* :class:`EngineTimers` times the engine's ``step`` and
  ``_prefill_into_slot`` on the host clock over a measured window and
  tallies the model operations of what they processed.
* A :class:`Probe` wraps one function of the program (a module attribute,
  looked up at call time by its callers) for the traced window: it opens
  a ``torch.profiler.record_function`` range named by ``label`` around
  the call, sets the phase (prefill or decode) for the calls inside it,
  and runs ``count``, which tallies the work of the call into the
  :class:`Tally` without waiting on the device. Per-layer metric files
  (``chipbench/metrics``) declare the probes they read.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import work


@dataclass
class Tally:
    """What the probes of one traced window counted: ``work[label]`` is
    [operations, bytes] on the host; ``device[key]`` a device tensor of
    counts, read once the window has closed."""
    cfg: dict
    phase: Optional[str] = None
    work: Dict[str, List[float]] = field(default_factory=dict)
    device: Dict[str, torch.Tensor] = field(default_factory=dict)

    def add(self, label: str, flops: float, n_bytes: float) -> None:
        acc = self.work.setdefault(label, [0.0, 0.0])
        acc[0] += flops
        acc[1] += n_bytes

    def add_device(self, key: str, value: torch.Tensor) -> None:
        if key in self.device:
            self.device[key] += value
        else:
            self.device[key] = value.clone()

    def read_device(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.device.items()}


@dataclass(frozen=True)
class Probe:
    """``target`` is ``"module:function"``; ``label(args, tally)`` names
    the call's range (None: no range); ``labels`` lists every name it can
    give; ``phase`` is set on the tally during the call; ``count(args,
    tally)`` tallies its work."""
    name: str
    target: str
    label: Optional[Callable] = None
    labels: tuple = ()
    phase: Optional[str] = None
    count: Optional[Callable] = None


def _wrap(fn, probe: Probe, tally: Tally):
    def probed(*args, **kwargs):
        if probe.count is not None:
            probe.count(args, tally)
        before = tally.phase
        if probe.phase is not None:
            tally.phase = probe.phase
        name = probe.label(args, tally) if probe.label else None
        try:
            if name is None:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        finally:
            tally.phase = before
    return probed


class Installed:
    """Probes installed on the program until :meth:`remove`."""

    def __init__(self, probes: List[Probe], tally: Tally):
        self._undo = []
        seen = set()
        for p in probes:
            if p.name in seen:
                continue
            seen.add(p.name)
            mod_name, attr = p.target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            setattr(mod, attr, _wrap(fn, p, tally))
            self._undo.append((mod, attr, fn))

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []


def labels_of(probes: List[Probe]) -> set:
    return {name for p in probes for name in p.labels}


# -- the probes the metric files share ---------------------------------------
def _prompt_len(args) -> int:
    return int(args[1].shape[1])


def _contexts(args) -> np.ndarray:
    """A decode step's valid length a row (its new token included), over
    the rows that hold a request: ``decode_step(model, tokens, cache,
    lengths)`` takes the host lengths, 0 for an empty slot."""
    lengths = np.asarray(args[3])
    return lengths[lengths > 0] + 1


def _count_attn_prefill(args, tally: Tally) -> None:
    f, b = work.attn_prefill_work(tally.cfg, _prompt_len(args))
    layers = tally.cfg["num_hidden_layers"]
    tally.add("attn_prefill", layers * f, layers * b)


def _count_attn_decode(args, tally: Tally) -> None:
    f, b = work.attn_decode_work(tally.cfg, _contexts(args).tolist())
    layers = tally.cfg["num_hidden_layers"]
    tally.add("attn_decode", layers * f, layers * b)


def _count_experts(args, tally: Tally) -> None:
    """``_routed_sorted(experts, kind, xt, flat_e, keep, token_idx,
    flat_w)``: the kept assignments and the distinct experts they reach,
    accumulated on the device by phase."""
    flat_e, keep = args[3], args[4]
    n_exp = tally.cfg["n_routed_experts"]
    hist = torch.zeros(n_exp, device=flat_e.device).index_add_(
        0, flat_e, keep.to(torch.float32))
    phase = tally.phase or "unknown"
    tally.add_device(f"experts.kept.{phase}", keep.sum())
    tally.add_device(f"experts.reached.{phase}", (hist > 0).sum())


def _attend_label(args, tally: Tally) -> str:
    return "attn_decode" if args[1].shape[1] == 1 else "attn_prefill"


def _experts_label(args, tally: Tally) -> str:
    return f"moe_experts.{tally.phase or 'unknown'}"


MODEL_PREFILL = Probe("model.prefill", "repro_torch.serving.engine:prefill",
                      label=lambda a, t: "model.prefill",
                      labels=("model.prefill",), phase="prefill")
MODEL_DECODE = Probe("model.decode", "repro_torch.serving.engine:decode_step",
                     label=lambda a, t: "model.decode",
                     labels=("model.decode",), phase="decode")
ATTN_PREFILL_COUNT = Probe("attn_prefill.count",
                           "repro_torch.serving.engine:prefill",
                           count=_count_attn_prefill)
ATTN_DECODE_COUNT = Probe("attn_decode.count",
                          "repro_torch.serving.engine:decode_step",
                          count=_count_attn_decode)
ATTEND = Probe("attend", "repro_torch.models.attention:attend",
               label=_attend_label, labels=("attn_prefill", "attn_decode"))
MLA_NAIVE = Probe("mla.naive", "repro_torch.models.mla:_naive",
                  label=lambda a, t: "attn_prefill", labels=("attn_prefill",))
MLA_ABSORBED = Probe("mla.absorbed", "repro_torch.models.mla:_absorbed_decode",
                     label=lambda a, t: "attn_decode", labels=("attn_decode",))
MOE_EXPERTS = Probe("moe.experts", "repro_torch.models.moe:_routed_sorted",
                    label=_experts_label, count=_count_experts,
                    labels=("moe_experts.prefill", "moe_experts.decode"))
MOE_ROUTE = Probe("moe.route", "repro_torch.models.moe:_route",
                  label=lambda a, t: "moe_route", labels=("moe_route",))


class EngineTimers:
    """Host wall and work of the engine's prefill and decode calls over a
    window: wraps ``step`` and ``_prefill_into_slot`` on the instance;
    ``arch`` (``chipbench/arch``) counts the model operations."""

    def __init__(self, eng, cfg: dict, arch, clock: Callable[[], float]):
        self.eng = eng
        self.w = dict(steps=0, step_wall_s=0.0, decode_rows=0,
                      decode_flops=0.0, prefills=0, prefill_wall_s=0.0,
                      prompt_tokens=0, prefill_flops=0.0)
        step, prefill = eng.step, eng._prefill_into_slot

        def timed_step():
            lengths = eng.cache_mgr.lengths()
            ctx = lengths[lengths > 0] + 1
            t0 = clock()
            out = step()
            self.w["step_wall_s"] += clock() - t0
            if out:
                self.w["steps"] += 1
                self.w["decode_rows"] += len(ctx)
                self.w["decode_flops"] += arch.decode_flops(cfg, ctx.tolist())
            return out

        def timed_prefill(slot, req):
            t0 = clock()
            prefill(slot, req)
            self.w["prefill_wall_s"] += clock() - t0
            self.w["prefills"] += 1
            self.w["prompt_tokens"] += len(req.tokens)
            self.w["prefill_flops"] += arch.prefill_flops(cfg,
                                                          len(req.tokens))

        eng.step, eng._prefill_into_slot = timed_step, timed_prefill

    def remove(self) -> Dict[str, float]:
        del self.eng.step, self.eng._prefill_into_slot
        return dict(self.w)
