"""The harness's contract: cells, mixes and metrics found by name as
files, the result line's keys, the names and units, and the refusal to run
without a card."""
import json
import re
import subprocess
import sys

import pytest
import torch

from chipbench import harness, probes
from chipbench.tests.smoke_root import CHIPBENCH, REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (CHIPBENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (CHIPBENCH / "checks" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in e2e
        mod = harness.by_name(REPO, "metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
        for cell in m.get("workloads", cells):
            # a cell that reports a layer metric reports what it moves
            assert harness._applies(e2e[m["moves"]], cell)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if harness._applies(m, cell)]
        assert len(reported) >= 2
        assert any(harness._applies(m, cell) for m in BENCH["per_layer"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("chipbench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(root, trace):
    out = harness.run_cell("smoke.moe", 5, 0.5, bool(trace), device="cpu",
                           root=root)
    res = json.loads(json.dumps(out["result"]))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(res) == want + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    cell = harness.load_cell(root, "smoke.moe")
    listed = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in listed}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in listed}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert [c for c in res["checks"]][0] == "mean_logit_gap"


def test_cell_mix_and_metric_added_as_files(root, tmp_path):
    """A new mix, a new metric reader and a new cell, each a file (and an
    entry in BENCHMARK.json), run with no existing file edited."""
    before = {p: p.read_bytes() for p in (root / "chipbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    mix = json.loads((root / "chipbench/traffic/smoke.json").read_text())
    mix.update(clients=2, slots=2)
    (root / "chipbench/traffic/smoke2.json").write_text(json.dumps(mix))
    (root / "chipbench/metrics/engine.steps_seen.py").write_text(
        "LAYER = 'engine'\nUNIT = 'steps'\nMOVES = 'output_tokens_per_s'\n"
        "PROBES = ()\n\n\ndef read(rec):\n"
        "    return float(rec.window['steps']) or None\n")
    (root / "chipbench/checks/smoke.moe2.json").write_bytes(
        (root / "chipbench/checks/smoke.moe.json").read_bytes())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "smoke.moe2", "config": "smoke-moe",
                               "traffic": "smoke2", "chips": 1,
                               "why": "an added cell"})
    bench["per_layer"].append({
        "name": "engine.steps_seen", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "engine",
        "moves": "output_tokens_per_s", "workloads": ["smoke.moe2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        cell = harness.load_cell(root, "smoke.moe2")
        assert cell.mix.name == "smoke2" and cell.mix.slots == 2
        out = harness.run_cell("smoke.moe2", 6, 0.5, True, device="cpu",
                               root=root)
        assert out["result"]["metrics"]["engine.steps_seen"]["value"] > 0
        for p, data in before.items():
            assert p.read_bytes() == data, p
    finally:
        for f in ("traffic/smoke2.json", "metrics/engine.steps_seen.py",
                  "checks/smoke.moe2.json"):
            (root / "chipbench" / f).unlink()
        bench["workloads"].pop()
        bench["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_architecture_added_as_files(root):
    """A configuration of a new architecture: its file, the architecture's
    file and its plain reference's, found by the ``arch`` it names, run
    with no existing file edited."""
    before = {p: p.read_bytes() for p in (root / "chipbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cfg = json.loads((root / "chipbench/configs/smoke-moe.json").read_text())
    cfg.update(name="smoke-toy", arch="toy")
    added = {"configs/smoke-toy.json": json.dumps(cfg),
             "arch/toy.py": "from chipbench.arch.deepseek import (  # noqa\n"
                            "    decode_flops, model_config, prefill_flops,"
                            " spec)\n",
             "reference/toy.py": "from chipbench.reference.deepseek import "
                                 "served_logits  # noqa\n",
             "checks/smoke.toy.json":
                 (root / "chipbench/checks/smoke.moe.json").read_text()}
    for f, text in added.items():
        (root / "chipbench" / f).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    saved = json.dumps(bench)
    bench["configs"].append({"name": "smoke-toy", "source": "a test",
                             "file": "chipbench/configs/smoke-toy.json",
                             "reduced": [], "why": "an added architecture"})
    bench["workloads"].append({"name": "smoke.toy", "config": "smoke-toy",
                               "traffic": "smoke", "chips": 1,
                               "why": "an added architecture"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        out = harness.run_cell("smoke.toy", 12, 0.5, True, device="cpu",
                               root=root)
        assert out["result"]["correct"] is True
        assert out["result"]["metrics"]["model.mfu"]["value"] > 0
        assert {"chipbench_arch_toy", "chipbench_reference_toy"} <= \
            set(sys.modules)
        for p, data in before.items():
            assert p.read_bytes() == data, p
    finally:
        for f in added:
            (root / "chipbench" / f).unlink()
        (root / "BENCHMARK.json").write_text(saved)


def test_probes_label_and_restore(root):
    """The traced window's probes name the layers' ranges and are taken
    off after it."""
    from repro_torch.models import attention, moe
    from repro_torch.serving import engine
    originals = (attention.attend, moe._routed_sorted, engine.decode_step)
    out = harness.run_cell("smoke.moe", 8, 0.5, True, device="cpu",
                           root=root)
    assert (attention.attend, moe._routed_sorted,
            engine.decode_step) == originals
    tally_work = out["trace"]["work"]
    assert tally_work["attn_decode"][1] > 0
    assert out["trace"]["counts"]["experts.kept.decode"] > 0
    assert probes.labels_of([probes.ATTEND]) == {"attn_prefill",
                                                 "attn_decode"}


def _run(args, cwd):
    return subprocess.run([sys.executable, "chipbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(["--workload", BENCH["workloads"][0]["name"], "--seed",
                 "4000000001", "--seconds", "1", "--trace", "0"], REPO)
    assert proc.returncode != 0 and _no_result(proc)
    assert "CUDA device" in proc.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder has
    no program to run."""
    import shutil
    shutil.copytree(CHIPBENCH, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"], tmp_path)
    assert proc.returncode != 0 and _no_result(proc)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_smoke_cell_on_the_card(card, root):
    out = harness.run_cell("smoke.mla", 9, 1.0, True, device="cuda",
                           root=root)
    res = out["result"]
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert out["trace"]["matched"] == out["trace"]["device_events"]
