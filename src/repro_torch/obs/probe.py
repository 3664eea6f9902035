"""The probe proving that instrumentation adds no operation to a call.

The whole obs design rests on one invariant: spans and metrics live
strictly on the host and only record, so a call runs the same tensor
operations whether obs is enabled or not. The reference proves it on the
compiled program (a jaxpr primitive count); the port runs eagerly, so
:func:`instrumentation_probe` counts what the call dispatches instead:

1. run ``fn`` once with obs forced **off** under a
   ``TorchDispatchMode`` that counts every aten operation by name, and
   count the calls of ``torch.cuda.synchronize``;
2. run it again with obs forced **on** and count the same way;
3. any difference is a violation: an extra copy (``aten._to_copy``,
   ``aten.copy_``), an ``.item()`` (``aten._local_scalar_dense``), an
   extra reduction for a metric or a synchronization would each change
   what the path waits on.

``fn`` runs twice, so it must do the same work both times (stage the
same samples, step the same interval shape).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import trace as _trace

__all__ = ["instrumentation_probe", "ProbeReport", "AtenOpCounter"]


class AtenOpCounter(TorchDispatchMode):
    """Counts every aten operation dispatched while it is active."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


@dataclass
class ProbeReport:
    """What one :func:`instrumentation_probe` found."""
    name: str
    ok: bool
    #: aten operations (and ``torch.cuda.synchronize`` calls) with obs off
    baseline: int
    #: the same with obs on
    with_obs: int
    #: one line per operation whose count differs
    violations: List[str] = field(default_factory=list)
    #: the obs-off counts by operation
    ops: Dict[str, int] = field(default_factory=dict)


def _counted_run(fn: Callable, args: Tuple, kwargs: Dict[str, Any]
                 ) -> Dict[str, int]:
    syncs = [0]
    real_sync = torch.cuda.synchronize

    def counted_sync(*a: Any, **kw: Any) -> None:
        syncs[0] += 1
        real_sync(*a, **kw)

    torch.cuda.synchronize = counted_sync
    try:
        with AtenOpCounter() as counter:
            fn(*args, **kwargs)
    finally:
        torch.cuda.synchronize = real_sync
    counts = dict(counter.counts)
    if syncs[0]:
        counts["torch.cuda.synchronize"] = syncs[0]
    return counts


def instrumentation_probe(name: str, fn: Callable, args: Tuple = (),
                          kwargs: Optional[Dict[str, Any]] = None
                          ) -> ProbeReport:
    """Run ``fn(*args, **kwargs)`` with obs forced off, then forced on, and
    compare the aten operations each run dispatched: equal counts, op by
    op, or the report is not ``ok``."""
    kwargs = dict(kwargs or {})
    with _trace.force_disabled():
        off = _counted_run(fn, args, kwargs)
    with _trace.force_enabled():
        on = _counted_run(fn, args, kwargs)
    violations = [f"{op}: {off.get(op, 0)} -> {on.get(op, 0)}"
                  for op in sorted(set(off) | set(on))
                  if off.get(op, 0) != on.get(op, 0)]
    return ProbeReport(name=name, ok=not violations,
                       baseline=sum(off.values()), with_obs=sum(on.values()),
                       violations=violations, ops=off)
