"""A checkout root for CPU tests: the benchmark's files, plus smoke-size
cells (``smoke.moe``, ``smoke.mla``: float32 on the CPU, every kind of
layer of the full-size cell they follow) added as files alone, with limits
of their own set from smoke-size readings (``data/checks``)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

CHIPBENCH = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
REPO = CHIPBENCH.parent
#: smoke cell -> (its configuration, the full-size cell it follows)
SMOKE = {"smoke.moe": ("smoke-moe", "dsmoe16b.docqa"),
         "smoke.mla": ("smoke-mla", "dsv2lite16b.chat256")}


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(CHIPBENCH, root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind in ("configs", "traffic", "checks"):
        for f in (DATA / kind).glob("*.json"):
            shutil.copy(f, root / "chipbench" / kind / f.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (config, full) in SMOKE.items():
        bench["configs"].append({
            "name": config, "source": "chipbench/tests/data",
            "file": f"chipbench/configs/{config}.json", "reduced": [],
            "why": "a CPU test's size"})
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": "smoke", "chips": 1,
                                   "why": "a CPU test's size"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if full in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
