"""One run of one cell: set-up, a measured window of closed-loop traffic
through ``repro_torch``'s serving engine, optionally a traced window, and
the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``chipbench/configs/<config>.json``, ``chipbench/traffic/<traffic>
.json``, ``chipbench/metrics/<metric>.py`` and the cell's limits in
``chipbench/checks/<workload>.json``; and each architecture, by the
``arch`` its configuration file names: ``chipbench/arch/<arch>.py`` and
its plain reference ``chipbench/reference/<arch>.py``.

The run takes its set-up from the process's start to the window's
opening: imports, the weights drawn on the device, the engine, kernel
builds from the checkout's cache, and the warm-up (the first wave and
``warmup_completions`` completions). Nothing is built inside the window.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, devtrace, probes, traffic, weights  # noqa: E402

#: top-level modules that no run may load (the reference package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "repro")


@dataclass
class Cell:
    workload: str
    cfg: dict
    mix: traffic.Mix
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[entry["config"]]["file"]).read_text())
    base = root / "chipbench"
    return Cell(workload, cfg,
                traffic.load_mix(base / "traffic" / f"{entry['traffic']}.json"),
                check.load_limits(base / "checks" / f"{workload}.json"),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def by_name(root: Path, folder: str, name: str):
    """The module ``chipbench/<folder>/<name>.py``: a per-layer metric's
    reader (``metrics``), an architecture (``arch``) or its plain
    reference (``reference``)."""
    path = root / "chipbench" / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"chipbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class Driver:
    """The closed loop: each client submits its next request as soon as
    its last one completes."""

    def __init__(self, eng, loop: traffic.ClosedLoop):
        from repro_torch.serving import Request
        self.eng, self.loop, self.request = eng, loop, Request
        self.inflight: Dict[int, object] = {}
        self.finished: List[object] = []

    def submit(self, client: int) -> None:
        prompt, out = self.loop.next(client)
        req = self.request(f"c{client}.{self.loop.count[client]}", prompt,
                           max_tokens=out, arrival_s=self.eng.clock())
        self.eng.submit(req)
        self.inflight[client] = req

    def start(self) -> None:
        for c in range(self.loop.mix.clients):
            self.submit(c)

    def tick(self) -> int:
        """Admit (prefill) what waits, one decode step, resubmit for the
        clients whose request completed; returns the tokens served."""
        served = self.eng.admit() + self.eng.step()
        for c, req in list(self.inflight.items()):
            if req.done_s is not None:
                self.finished.append(req)
                self.submit(c)
        return served

    def run(self, seconds: float) -> dict:
        """Ticks until ``seconds`` have passed on the engine's clock."""
        clock = self.eng.clock
        start = clock()
        end, tokens = start + seconds, 0
        first_done = len(self.finished)
        while True:
            tokens += self.tick()
            now = clock()
            if now >= end:
                break
        return {"start": start, "end": now, "tokens": tokens,
                "finished": self.finished[first_done:]}


def _p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None


def end_to_end(eng, win: dict, setup_s: float) -> Dict[str, float]:
    start, end = win["start"], win["end"]
    reqs = list(eng.requests.values())
    ttft = [r.first_token_s - r.arrival_s for r in reqs
            if r.first_token_s is not None and start <= r.first_token_s <= end]
    lat = [r.done_s - r.arrival_s for r in win["finished"]]
    return {"output_tokens_per_s": win["tokens"] / (end - start),
            "ttft_p95_s": _p95(ttft), "latency_p95_s": _p95(lat),
            "setup_s": setup_s}


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    loaded module), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def _first_use(eng, mix: traffic.Mix) -> None:
    """One throwaway request (a prompt of the mix's shortest length, two
    tokens) through a prefill and a decode step before any traffic, so
    that a checkout's first run builds its kernel libraries before the
    first wave is submitted, not while its requests wait."""
    from repro_torch.serving import Request
    req = Request("first-use", np.zeros(mix.prompt_tokens[0], np.int64),
                  max_tokens=2, arrival_s=eng.clock())
    eng.submit(req)
    while req.done_s is None:
        eng.admit()
        eng.step()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced_window(drv: Driver, cell: Cell, mods: dict, device) -> dict:
    """``trace_seconds`` of the same traffic under ``torch.profiler``,
    with every probe the cell's metrics declare."""
    from torch.profiler import ProfilerActivity, profile
    plist = [p for m in mods.values() for p in getattr(m, "PROBES", ())]
    tally = probes.Tally(cfg=cell.cfg)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    installed = probes.Installed(plist, tally)
    try:
        _sync(device)
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            drv.run(cell.mix.trace_seconds)
            _sync(device)
            window_s = time.monotonic() - t0
    finally:
        installed.remove()
    got = devtrace.read(prof, probes.labels_of(plist))
    got.update(window_s=window_s, work=tally.work,
               counts=tally.read_device())
    return got


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             device="cuda", chips: int = 1, root: Path = ROOT,
             t0: Optional[float] = None, control: bool = False) -> dict:
    """One run; returns ``{"result": the last line's object, "checks":
    [(name, value, limit)], "sample": the comparison's readings, "trace":
    the traced window's readings, "e2e": every end-to-end metric}``. With
    ``control`` the fp8 control takes the program's place in the
    comparison that decides ``correct`` (``chipbench/calibrate.py``; the
    benchmark's runs do not)."""
    t0 = time.monotonic() if t0 is None else t0
    from . import system
    cell = load_cell(root, workload)
    mods = ({m["name"]: by_name(root, "metrics", m["name"])
             for m in cell.per_layer} if trace_on else {})
    cfg, mix = cell.cfg, cell.mix
    arch = by_name(root, "arch", cfg["arch"])
    dtype = getattr(torch, cfg["dtype"])
    w = weights.make(arch.spec(cfg), seed, device, dtype)
    eng = system.build_engine(arch.model_config(cfg), w, slots=mix.slots,
                              max_len=mix.max_len, device=device)
    _first_use(eng, mix)
    drv = Driver(eng, traffic.ClosedLoop(mix, seed, cfg["vocab_size"]))
    drv.start()
    while len(drv.finished) < mix.warmup_completions:
        drv.tick()
    _sync(device)
    gc.collect()
    timers = (probes.EngineTimers(eng, cfg, arch, eng.clock) if trace_on
              else None)
    setup_s = eng.clock() - t0
    gc.disable()
    try:
        win = drv.run(seconds)
    finally:
        gc.enable()
    timed = timers.remove() if timers else None
    e2e = end_to_end(eng, win, setup_s)
    traced = traced_window(drv, cell, mods, device) if trace_on else None
    _sync(device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    attempted = sum(1 for r in eng.requests.values()
                    if win["start"] <= r.arrival_s <= win["end"])
    failed = sum(1 for r in win["finished"] if len(r.output) != r.max_tokens)
    finished = [(list(r.tokens), list(r.output)) for r in win["finished"]]
    del drv, eng, timers
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    seqs = check.sample(finished, seed, mix.check_requests)
    # no finished request leaves nothing to compare: no gap, not correct
    got = (check.served_gap(by_name(root, "reference", cfg["arch"]), cfg, w,
                            seqs, device, control=control) if seqs else
           {"mean_logit_gap": None, "served_tokens": 0, "requests": 0})
    gap = got["mean_logit_gap"]
    checks = [("mean_logit_gap", gap, cell.limits["mean_logit_gap"]),
              ("failed", failed, 0),
              ("finished_at_least", len(finished), 1)]
    correct = (gap is not None and gap <= cell.limits["mean_logit_gap"]
               and failed == 0)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed}
    if trace_on:
        rec = Record(cfg=cfg, window=dict(timed, seconds=win["end"]
                                          - win["start"]), trace=traced,
                     e2e=e2e)
        values = {}
        for m in cell.per_layer:
            v = mods[m["name"]].read(rec)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        result["device"] = dict(device_info(device, chips, peak),
                                busy_s=traced["busy_s"],
                                window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end
                             if e2e.get(m["name"]) is not None}
        result["device"] = device_info(device, chips, peak)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return {"result": result, "checks": checks, "sample": got,
            "trace": traced, "e2e": e2e}


@dataclass
class Record:
    """What a per-layer metric's ``read`` sees: the configuration file,
    the measured window's engine timers and end-to-end metrics and, from
    the traced window, the trace and the probes' tallies."""
    cfg: dict
    window: dict
    trace: dict
    e2e: dict
