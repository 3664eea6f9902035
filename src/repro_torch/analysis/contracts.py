"""Contracts: machine-checked invariants of the port's hot paths.

The sweep stack's performance rests on properties no numerical test sees:
the K2 interval and the K1 chunk must be one launch each, a hot path must
never wait on the host (an ``.item()``, a copy back, a synchronize), the
persistent state must be updated in place, a float32 path must not promote
to float64, a scenario-partitioned step must not communicate, and a kernel
library must be built once, never once per shape. Each of these can regress
while every result stays bit for bit the same.

The reference checks them on the compiled program (a jaxpr and HLO). The
port runs eagerly, so a contract is checked by running the probe's call:
once to warm up (kernels built and loaded, caches filled), then once under
:class:`repro_torch.obs.probe.AtenOpCounter` (a ``TorchDispatchMode`` that
sees every aten operation it dispatches), with
the kernel wrappers' ``.launches`` counters read before and after:

* :class:`CompilationContract` — a declarative bundle of invariants;
* :func:`check_contract` — runs a call and checks it against a contract;
* :class:`ContractProbe` — how a registry entry packages its hot-path call
  with example arguments, its state and its contract (see
  :meth:`repro_torch.core.registry.Registry.attach_contract`);
* :func:`count_loads` — the kernel libraries a workload of mixed shapes
  requests (the counterpart of the reference's trace counter).

A kernel's dispatch (:mod:`repro_torch.kernels.ops`) is opaque to the
checker: the call counts as one operation (``kernel.<name>``) and its
outputs' dtypes are read, but what runs inside is not counted. On the card
that is one launch that dispatches no aten operation of its own; on the CPU
it is the kernel's plain version, whose host reads stand in for work the
card does inside the kernel.

Imports only torch, the port's kernel modules and :mod:`repro_torch.obs`'s
counter, so every layer can declare contracts without cycles.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.utils._pytree import tree_leaves

from ..obs.probe import AtenOpCounter, counting, instrumentation_probe

__all__ = [
    "COLLECTIVE_OPS", "HOST_SYNC_OPS", "KERNEL_DISPATCHES",
    "CompilationContract", "ContractViolation", "ContractReport",
    "ContractProbe", "check_contract", "run_probe", "count_loads",
    "host_probe",
]

#: Operation-name substrings of cross-device communication: the eager
#: ``torch.distributed`` ops and their functional (traceable) forms. A
#: scenario-partitioned hot path dispatches none of them.
COLLECTIVE_OPS: Tuple[str, ...] = ("c10d.", "_c10d_functional.")

#: aten operations that wait on the device for their result on the host:
#: a scalar read, and the ops whose output shape depends on the data.
HOST_SYNC_OPS: Tuple[str, ...] = (
    "aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
    "aten.equal", "aten.nonzero", "aten.nonzero_static",
    "aten.masked_select", "aten.unique", "aten._unique", "aten._unique2",
    "aten.unique_consecutive", "aten.unique_dim",
)

#: aten indexing operations that, given a boolean mask, count its true
#: entries on the host first.
_MASK_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_",
                   "aten._index_put_impl_")

#: The kernel dispatches of :mod:`repro_torch.kernels.ops`, by name, with
#: the module and function of the wrapper whose ``.launches`` counts the
#: card's launches.
KERNEL_DISPATCHES: Dict[str, Tuple[str, str]] = {
    "fused_interval": ("fused_tick", "fused_interval"),
    "fused_tick": ("fused_tick", "fused_tick"),
    "arima_chunk": ("rls_update", "arima_chunk"),
    "rls_rank1_update": ("rls_update", "rls_rank1_update"),
    "gp_lbfgs": ("gp_fit", "gp_lbfgs"),
    "decode_attention": ("decode_attention", "decode_attention"),
    "flash_attention": ("flash_attention", "flash_attention"),
    "ssd_scan": ("ssd_scan", "ssd_scan"),
    "grouped_matmul": ("grouped_matmul", "grouped_matmul"),
    "fused_rmsnorm": ("rmsnorm", "fused_rmsnorm"),
}


@dataclass(frozen=True)
class ContractViolation:
    """One broken invariant: which contract field, and what was seen."""

    field: str
    message: str

    def __str__(self) -> str:
        return f"[{self.field}] {self.message}"


@dataclass(frozen=True)
class CompilationContract:
    """Declarative invariants of one hot-path call.

    Every field is optional; an empty contract passes trivially. Checked
    fields:

    ``forbidden_ops``
        Operation-name substrings the call must not dispatch
        (:data:`COLLECTIVE_OPS` for scenario-partitioned paths).
    ``launches``
        Kernel dispatch name -> the exact number of calls per probe call
        (``{"fused_interval": 1}``: one launch per interval). Counted as
        :mod:`repro_torch.kernels.ops` dispatches on every device, and on
        the card also as the wrappers' ``.launches`` deltas.
    ``in_place``
        Names of the probe's state tensors that the call must update in
        place: the same ``data_ptr()`` after the call, different contents.
    ``max_ops``
        Ceiling on the aten operations dispatched per call (a kernel
        dispatch counts as one).
    ``dtype_ceiling``
        ``"float32"`` forbids any float64/complex128 tensor among the
        call's inputs and the outputs of every operation; ``"float64"`` (or
        None) allows them. The float64 paths of the port are deliberate and
        say so in their contracts.
    ``forbid_host_sync``
        No :data:`HOST_SYNC_OPS`, no copy from the card to the host and no
        ``torch.cuda.synchronize`` during the call; on the card the call
        also runs once more under ``torch.cuda.set_sync_debug_mode("error")``.
    ``max_loads``
        Budget of kernel libraries requested over the probe's workload of
        mixed shapes (:func:`count_loads`). The loader caches a library by
        name, so this is structural: it fails only if a wrapper named its
        library by shape, which would build one library per shape.
    ``graph_capturable``
        On the card: the call is captured once in a CUDA graph and
        replayed, and the replay equals the eager result bit for bit
        (outputs and state). Skipped on the CPU.
    ``obs_neutral``
        With obs forced on, the call dispatches the same aten operations,
        op by op, and the same ``torch.cuda.synchronize`` calls as with obs
        forced off (:func:`repro_torch.obs.probe.instrumentation_probe`).
    """

    name: str = ""
    forbidden_ops: Tuple[str, ...] = ()
    launches: Mapping[str, int] = field(default_factory=dict)
    in_place: Tuple[str, ...] = ()
    max_ops: Optional[int] = None
    dtype_ceiling: Optional[str] = None
    forbid_host_sync: bool = True
    max_loads: Optional[int] = None
    graph_capturable: bool = False
    obs_neutral: bool = False
    #: free-text rationale surfaced in reports (why these invariants)
    note: str = ""

    def named(self, name: str) -> "CompilationContract":
        """A copy of this contract carrying ``name`` (for registry reuse)."""
        return replace(self, name=name)


@dataclass
class ContractReport:
    """Outcome of checking one call against one contract."""

    name: str
    ok: bool
    violations: List[ContractViolation] = field(default_factory=list)
    n_ops: int = 0
    dtypes: Tuple[str, ...] = ()
    #: kernel dispatch name -> calls (and, on the card, launches) per call
    launches: Dict[str, int] = field(default_factory=dict)
    n_loads: Optional[int] = None
    #: the checks that did not apply on this device
    skipped: Tuple[str, ...] = ()
    note: str = ""
    #: wall of the whole check (warm-up, measured call, extra card checks)
    seconds: float = 0.0

    def summary(self) -> str:
        head = f"{self.name}: " if self.name else ""
        if self.ok:
            extra = ""
            if self.launches:
                extra += f", launches={dict(sorted(self.launches.items()))}"
            if self.n_loads is not None:
                extra += f", loads={self.n_loads}"
            if self.skipped:
                extra += f", skipped {'/'.join(self.skipped)}"
            return (f"{head}OK ({self.n_ops} ops, "
                    f"dtypes={{{', '.join(self.dtypes)}}}{extra}, "
                    f"{self.seconds:.3f} s)")
        if not self.violations:       # a probe that failed before checking
            return f"{head}FAILED — {self.note or 'no report'}"
        lines = "\n  ".join(str(v) for v in self.violations)
        return f"{head}{len(self.violations)} violation(s)\n  {lines}"

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ok": self.ok,
                "violations": [{"field": v.field, "message": v.message}
                               for v in self.violations],
                "n_ops": self.n_ops, "dtypes": list(self.dtypes),
                "launches": dict(self.launches), "n_loads": self.n_loads,
                "skipped": list(self.skipped), "note": self.note,
                "seconds": self.seconds}


# ---------------------------------------------------------------------------
# the dispatch recorder
# ---------------------------------------------------------------------------

def _kernel_wrapper(name: str):
    """The wrapper function of kernel dispatch ``name`` (its ``.launches``
    counts the card's launches)."""
    import importlib
    module, fn = KERNEL_DISPATCHES[name]
    return getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                   fn)


def _tensors(obj: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


class _Recorder(AtenOpCounter):
    """Records what a call dispatches, counted as :class:`AtenOpCounter`
    counts it: the dtypes that the operations and the opaque kernel
    dispatches produce, and the operations that wait on the host."""

    def __init__(self) -> None:
        super().__init__()
        self.dtypes: set = set()
        self.syncs: List[str] = []

    def _note(self, out: Any) -> List[torch.Tensor]:
        outs = _tensors(out)
        for t in outs:
            self.dtypes.add(str(t.dtype).replace("torch.", ""))
        return outs

    def record(self, func, args, kwargs, out) -> None:
        outs = self._note(out)
        name = str(func)
        packet = str(func.overloadpacket)
        if packet in HOST_SYNC_OPS:
            self.syncs.append(f"`{name}` reads a device value on the host")
        elif packet in _MASK_INDEX_OPS and len(args) > 1 and any(
                t.dtype == torch.bool for t in _tensors(args[1])):
            self.syncs.append(f"`{name}` indexes by a boolean mask (its "
                              f"shape depends on the data)")
        elif any(t.device.type == "cpu" for t in outs) and any(
                t.device.type == "cuda" for t in _tensors((args, kwargs))):
            self.syncs.append(f"`{name}` copies from the card to the host")

    def kernel(self, name: str, real: Callable) -> Callable:
        counted = super().kernel(name, real)

        def call(*args: Any, **kwargs: Any) -> Any:
            out = counted(*args, **kwargs)
            if not self.opaque:
                self._note(out)
            return out
        return call


#: dtypes wider than each ceiling (the contract fails if any appear).
_OVER_CEILING = {
    "float32": ("float64", "complex128"),
    "bfloat16": ("float32", "float64", "complex64", "complex128"),
    "float64": (),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as raw bits, so that a comparison of two tensors is bit for bit
    (NaN equal to the same NaN)."""
    if t.dtype.is_floating_point:
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(_bits(a), _bits(b))


def _graph_check(fn: Callable, args: Sequence[Any],
                 kwargs: Mapping[str, Any],
                 state: Mapping[str, torch.Tensor]) -> Optional[str]:
    """Capture ``fn`` in a CUDA graph and replay it from the state it was
    called on eagerly; None when the replay equals the eager call bit for
    bit, else what differed."""
    snap = {k: t.clone() for k, t in state.items()}
    eager_out = [t.clone() for t in _tensors(fn(*args, **kwargs))]
    eager_state = {k: t.clone() for k, t in state.items()}
    for k, t in state.items():
        t.copy_(snap[k])
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            graph_out = _tensors(fn(*args, **kwargs))
    except Exception as exc:            # capture refused an operation
        return f"capture failed: {type(exc).__name__}: {exc}"
    for k, t in state.items():
        t.copy_(snap[k])
    graph.replay()
    torch.cuda.synchronize()
    if len(graph_out) != len(eager_out):
        return (f"the replay returned {len(graph_out)} tensor(s), the eager "
                f"call {len(eager_out)}")
    bad = [f"output {i}" for i, (a, b) in enumerate(zip(graph_out, eager_out))
           if not _bit_equal(a, b)]
    bad += [f"state {k!r}" for k, t in state.items()
            if not _bit_equal(t, eager_state[k])]
    return f"the replay differs from the eager call in {', '.join(bad)}" \
        if bad else None


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def check_contract(fn: Callable, args: Sequence[Any],
                   contract: CompilationContract,
                   kwargs: Optional[Mapping[str, Any]] = None,
                   state: Optional[Mapping[str, torch.Tensor]] = None,
                   device: Union[str, torch.device] = "cpu",
                   n_loads: Optional[int] = None) -> ContractReport:
    """Run ``fn(*args, **kwargs)`` (a warm-up call, then the measured one)
    and verify ``contract``.

    ``state`` maps names to the live tensors the call updates (the
    contract's ``in_place`` names are looked up in it at each read, so a
    call that rebinds an entry instead of writing into it is caught).
    ``device`` says where the call runs: the launch counters, the sync
    debug mode and the CUDA-graph replay are checked only on ``"cuda"``.
    ``n_loads`` threads a measured library-load count (see
    :func:`count_loads`) into the ``max_loads`` check.
    """
    t0 = time.perf_counter()
    kwargs = dict(kwargs or {})
    state = state if state is not None else {}
    on_card = torch.device(device).type == "cuda"
    violations: List[ContractViolation] = []
    skipped: List[str] = []

    fn(*args, **kwargs)                                   # warm-up
    missing = [n for n in contract.in_place if n not in state]
    for n in missing:
        violations.append(ContractViolation(
            "in_place", f"the probe has no state tensor named {n!r}"))
    before = {n: (state[n].data_ptr(), state[n].clone())
              for n in contract.in_place if n in state}
    wrappers = {n: _kernel_wrapper(n) for n in contract.launches}
    if on_card:
        torch.cuda.synchronize(device)
    launches0 = {n: w.launches for n, w in wrappers.items()}
    # kernel dispatches opaque (fn itself too, when it is one of them)
    with counting(fn, _Recorder(), KERNEL_DISPATCHES) as (rec, target):
        target(*args, **kwargs)
    launched = {n: w.launches - launches0[n] for n, w in wrappers.items()}

    dtypes = set(rec.dtypes)
    for t in _tensors((args, kwargs)):
        dtypes.add(str(t.dtype).replace("torch.", ""))
    n_ops = sum(rec.counts.values())
    syncs = list(rec.syncs)
    if rec.counts.get("torch.cuda.synchronize"):
        syncs.append("`torch.cuda.synchronize` called")

    for needle in contract.forbidden_ops:
        hits = sorted(op for op in rec.counts if needle in op)
        if hits:
            violations.append(ContractViolation(
                "forbidden_ops", f"the call dispatched {', '.join(hits)} "
                                 f"(matches {needle!r})"))

    counts: Dict[str, int] = {}
    for name, budget in contract.launches.items():
        calls = rec.kernels.get(name, 0)
        counts[name] = calls
        if calls != budget:
            violations.append(ContractViolation(
                "launches", f"ops.{name} dispatched {calls} time(s) per "
                            f"call, budget {budget}"))
        if on_card and launched[name] != budget:
            violations.append(ContractViolation(
                "launches", f"{name} launched {launched[name]} kernel(s) "
                            f"on the card per call, budget {budget}"))
    if contract.launches and not on_card:
        skipped.append("launch counters")

    for name, (ptr, snap) in before.items():
        now = state[name]
        if now.data_ptr() != ptr:
            violations.append(ContractViolation(
                "in_place", f"state {name!r} was reallocated, not updated "
                            f"in place (data_ptr moved)"))
        elif _bit_equal(now, snap):
            violations.append(ContractViolation(
                "in_place", f"state {name!r} was not updated: its contents "
                            f"did not change"))

    if contract.max_ops is not None and n_ops > contract.max_ops:
        top = ", ".join(f"{op}×{c}" for op, c in
                        collections.Counter(rec.counts).most_common(5))
        violations.append(ContractViolation(
            "max_ops", f"{n_ops} ops > budget {contract.max_ops} "
                       f"(top: {top})"))

    ceiling = contract.dtype_ceiling
    if ceiling is not None:
        over = set(_OVER_CEILING.get(ceiling, ())) & dtypes
        if over:
            violations.append(ContractViolation(
                "dtype_ceiling",
                f"dtypes {sorted(over)} exceed ceiling {ceiling!r}"))

    if contract.forbid_host_sync:
        for why in dict.fromkeys(syncs):
            violations.append(ContractViolation("forbid_host_sync", why))
        if on_card and not syncs:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args, **kwargs)
            except RuntimeError as exc:
                violations.append(ContractViolation(
                    "forbid_host_sync", f"the call synchronized under "
                                        f"set_sync_debug_mode('error'): "
                                        f"{exc}"))
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    if contract.max_loads is not None and n_loads is not None \
            and n_loads > contract.max_loads:
        violations.append(ContractViolation(
            "max_loads", f"{n_loads} kernel libraries requested > budget "
                         f"{contract.max_loads}: a library is named per "
                         f"shape"))

    if contract.obs_neutral:
        for line in instrumentation_probe(contract.name, fn, args,
                                          kwargs).violations:
            violations.append(ContractViolation(
                "obs_neutral", f"obs on changes an operation count: {line}"))

    if contract.graph_capturable:
        if on_card:
            with torch.cuda.device(device):
                why = _graph_check(fn, args, kwargs, state)
            if why is not None:
                violations.append(ContractViolation("graph_capturable", why))
        else:
            skipped.append("graph replay")

    if on_card:
        torch.cuda.synchronize(device)
    return ContractReport(
        name=contract.name, ok=not violations, violations=violations,
        n_ops=n_ops, dtypes=tuple(sorted(dtypes)),
        launches={n: (launched[n] if on_card else counts[n])
                  for n in contract.launches},
        n_loads=n_loads, skipped=tuple(skipped), note=contract.note,
        seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# probes: how registry entries expose their hot paths
# ---------------------------------------------------------------------------

@dataclass
class ContractProbe:
    """One checkable (call, example arguments, state, contract) bundle.

    Registry entries attach factories of ``device`` returning one of these
    (or a list of them); construction happens inside the factory, so
    importing a backend module builds no engine and places no tensor.

    ``host_only=True`` marks entries with no device hot path (the NumPy
    reference oracles): they are still enumerated — every registered
    backend must expose a contract — but pass with a note instead of a run.
    ``loads`` optionally measures the kernel-library loads of a workload of
    mixed shapes for the contract's ``max_loads`` budget (see
    :func:`count_loads`).
    """

    contract: CompilationContract
    fn: Optional[Callable] = None
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    #: the live tensors the call updates, by name (``in_place`` reads them)
    state: Mapping[str, torch.Tensor] = field(default_factory=dict)
    device: str = "cpu"
    host_only: bool = False
    note: str = ""
    loads: Optional[Callable[[], int]] = None


ProbeFactory = Callable[..., Union[ContractProbe, List[ContractProbe]]]


def host_probe(name: str, note: str) -> ContractProbe:
    """A passing probe for registry entries with no device hot path (the
    NumPy/scipy reference oracles on the host). They still must be
    enumerated, but there is nothing on a device to check."""
    return ContractProbe(contract=CompilationContract(name=name),
                         host_only=True, note=note)


def run_probe(probe: ContractProbe) -> ContractReport:
    """Check one probe; host-only probes pass with their note."""
    if probe.host_only:
        return ContractReport(name=probe.contract.name, ok=True,
                              note=probe.note or "host-only entry point "
                                                 "(no device hot path)")
    assert probe.fn is not None, "non-host probe needs an entry point"
    n_loads = probe.loads() if probe.loads is not None else None
    report = check_contract(probe.fn, probe.args, probe.contract,
                            kwargs=probe.kwargs, state=probe.state,
                            device=probe.device, n_loads=n_loads)
    if probe.note and not report.note:
        report.note = probe.note
    return report


def count_loads(fn: Callable,
                arg_sets: Sequence[Tuple[Sequence[Any], Mapping[str, Any]]]
                ) -> int:
    """The kernel libraries ``fn`` requests over ``arg_sets``: the distinct
    names it passes to :func:`repro_torch.kernels.build.load`.

    Each element of ``arg_sets`` is ``(args, kwargs)``. The loader caches a
    library by name, so this is the number of libraries the workload needs:
    one per library when kernels take their shapes at run time, one per
    shape if a wrapper named its library by shape. The loader's cache is
    left as it is. A CPU workload runs the plain versions and requests
    none.
    """
    from ..kernels import build
    names = set()
    real = build.load

    def load(name: str):
        names.add(name)
        return real(name)

    build.load = load
    try:
        for args, kwargs in arg_sets:
            fn(*args, **dict(kwargs))
    finally:
        build.load = real
    return len(names)
