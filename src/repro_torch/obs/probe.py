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

:func:`instrumentation_contract_probe` packages the same comparison as a
:class:`~repro_torch.analysis.contracts.ContractProbe` (its contract's
``obs_neutral`` field), the companion probe the sweep engines attach to
their registry entries. :class:`AtenOpCounter` and :func:`counting` are
also the contract checker's counter.
"""
from __future__ import annotations

import collections
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import trace as _trace

__all__ = ["instrumentation_probe", "instrumentation_contract_probe",
           "ProbeReport", "AtenOpCounter", "counting"]


class AtenOpCounter(TorchDispatchMode):
    """Counts every aten operation dispatched while it is active.

    A kernel dispatch wrapped by :meth:`kernel` is opaque: it counts as one
    operation, ``kernel.<name>``, and nothing it dispatches inside is
    counted. A subclass sees each counted aten operation and its result
    through :meth:`record`.
    """

    def __init__(self) -> None:
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()
        #: calls of each opaque kernel dispatch
        self.kernels: Dict[str, int] = collections.Counter()
        #: depth of opaque kernel dispatches in progress
        self.opaque = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.opaque:
            self.counts[str(func)] += 1
            self.record(func, args, kwargs, out)
        return out

    def record(self, func: Any, args: Tuple, kwargs: Optional[Dict],
               out: Any) -> None:
        """Called after each counted aten operation."""

    def kernel(self, name: str, real: Callable) -> Callable:
        """``real`` (a kernel dispatch) made opaque to this counter."""
        def call(*args: Any, **kwargs: Any) -> Any:
            self.opaque += 1
            try:
                return real(*args, **kwargs)
            finally:
                self.opaque -= 1
                if not self.opaque:
                    self.kernels[name] += 1
                    self.counts[f"kernel.{name}"] += 1
        return call


@contextmanager
def counting(fn: Callable, counter: Optional[AtenOpCounter] = None,
             kernels: Iterable[str] = ()
             ) -> Iterator[Tuple[AtenOpCounter, Callable]]:
    """Count what runs inside the block: yields the counter and the
    callable to call in place of ``fn``.

    Calls of ``torch.cuda.synchronize`` count as an operation of that name.
    Each dispatch of :mod:`repro_torch.kernels.ops` named in ``kernels`` is
    made opaque (:meth:`AtenOpCounter.kernel`) for the block, and so is
    ``fn`` when it is one of them.
    """
    from ..kernels import ops
    counter = counter if counter is not None else AtenOpCounter()
    real = {name: getattr(ops, name) for name in kernels}
    patched = {name: counter.kernel(name, f) for name, f in real.items()}
    for name, f in patched.items():
        setattr(ops, name, f)
    real_sync = torch.cuda.synchronize

    def counted_sync(*a: Any, **kw: Any) -> None:
        if not counter.opaque:
            counter.counts["torch.cuda.synchronize"] += 1
        real_sync(*a, **kw)

    torch.cuda.synchronize = counted_sync
    target = next((patched[n] for n, f in real.items() if f is fn), fn)
    try:
        with counter:
            yield counter, target
    finally:
        torch.cuda.synchronize = real_sync
        for name, f in real.items():
            setattr(ops, name, f)


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
    with counting(fn) as (counter, target):
        target(*args, **kwargs)
    return dict(counter.counts)


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


def instrumentation_contract_probe(name: str, fn: Callable, args: Tuple = (),
                                   kwargs: Optional[Dict[str, Any]] = None,
                                   device: str = "cpu", note: str = ""
                                   ) -> Any:
    """:func:`instrumentation_probe`'s comparison as a
    :class:`~repro_torch.analysis.contracts.ContractProbe`: its contract's
    ``obs_neutral`` field holds the operations ``fn`` dispatches with obs
    forced on equal, op by op, to those with obs forced off.

    Host syncs are not forbidden outright: the call may read its results
    back (an engine step does, once per call). A read or synchronize that
    obs adds changes the counts, so it fails ``obs_neutral``."""
    from ..analysis.contracts import CompilationContract, ContractProbe
    contract = CompilationContract(
        name=name, obs_neutral=True, forbid_host_sync=False,
        note=note or "obs instrumentation adds no operation: the aten ops "
                     "with obs on equal those with obs off, op by op")
    return ContractProbe(contract=contract, fn=fn, args=tuple(args),
                         kwargs=dict(kwargs or {}), device=device)
