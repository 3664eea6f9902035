"""Reading a ``torch.profiler`` trace of the traced window.

The device's busy time is the union of its operations' intervals (kernels,
copies and sets), and its idle share ``1 - busy / wall`` as in the
profiling of the port's earlier chip checks. A device operation belongs to
a labelled range (a probe's ``record_function``) when the host call that
launched it began inside that range: each operation is matched to its
launch by the correlation id that CUPTI gives both, else to the operator
the profiler links it to. An idle gap between two device operations is
named by the innermost range the host was in when it launched the
operation that ends the gap.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

OUTSIDE = "host outside the probed calls"
TOP = 10


def _host_ranges(events, labels: set) -> Dict[str, Tuple[list, list]]:
    spans = defaultdict(list)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU \
                and e.name() in labels:
            spans[e.name()].append((e.start_ns(), e.end_ns()))
    out = {}
    for name, iv in spans.items():
        iv.sort()
        out[name] = ([s for s, _ in iv], [t for _, t in iv])
    return out


def _inside(ranges: Tuple[list, list], t: int) -> int:
    """The start of the range of ``ranges`` that holds ``t``, or -1."""
    starts, ends = ranges                  # one label's ranges are disjoint
    i = bisect.bisect_right(starts, t) - 1
    return starts[i] if i >= 0 and ends[i] >= t else -1


def read(prof, labels: Iterable[str]) -> dict:
    """From a finished ``torch.profiler.profile``: the device's busy
    seconds, the device seconds launched inside each label's ranges, the
    operations that took most time and the longest idle gaps by what the
    host was doing, and how many operations were matched to a launch."""
    labels = set(labels)
    events = prof.profiler.kineto_results.events()
    host = _host_ranges(events, labels)
    launch_at, op_at, device = {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if _is_launch(name):
                launch_at[e.correlation_id()] = e.start_ns()
            elif name not in labels:
                op_at[e.correlation_id()] = e.start_ns()
        elif name not in labels:              # not a range's device mirror
            device.append(e)
    ops = []                                   # (start, end, name, host t)
    matched = 0
    for e in device:
        t = launch_at.get(e.correlation_id())
        if t is None:
            t = op_at.get(e.linked_correlation_id())
        matched += t is not None
        ops.append((e.start_ns(), e.end_ns(), e.name(), t))
    ops.sort()
    by_label = defaultdict(float)
    by_name = defaultdict(float)
    for s, t_end, name, t in ops:
        dur = (t_end - s) / 1e9
        by_name[name] += dur
        if t is None:
            continue
        for label, rng in host.items():
            if _inside(rng, t) >= 0:
                by_label[label] += dur
    busy, gaps = 0.0, defaultdict(float)
    cur_s = cur_e = None
    for s, t_end, _, t in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps[_innermost(host, t)] += (s - cur_e) / 1e9
                busy += (cur_e - cur_s) / 1e9
            cur_s, cur_e = s, t_end
        else:
            cur_e = max(cur_e, t_end)
    if cur_e is not None:
        busy += (cur_e - cur_s) / 1e9
    return {"busy_s": busy, "device_s": dict(by_label),
            "device_ops": _top(by_name), "idle_gaps": _top(gaps),
            "device_events": len(ops), "matched": matched}


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _innermost(host: Dict[str, Tuple[list, list]], t) -> str:
    if t is None:
        return OUTSIDE
    best, best_start = OUTSIDE, -1
    for label, rng in host.items():
        start = _inside(rng, t)
        if start > best_start:
            best, best_start = label, start
    return best


def _top(totals: Dict[str, float]) -> List[list]:
    return [[name[:120], sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
