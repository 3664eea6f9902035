"""The import guard: a run of the harness loads no module whose top-level
name is ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``repro`` (compared
as whole names: ``repro_torch`` is the program), and the plain reference
loads nothing of the program. Each check runs in a fresh interpreter, as
the benchmark's runs do."""
import json
import subprocess
import sys

from chipbench.tests.smoke_root import REPO

SMOKE_RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
from chipbench import harness
from chipbench.tests.smoke_root import make_root
root = make_root(Path(tempfile.mkdtemp(dir={tmp!r})))
out = harness.run_cell("smoke.mla", 3, 0.5, True, device="cpu", root=root)
print(json.dumps({{"correct": out["result"]["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {repo!r})
import chipbench.reference, chipbench.check, chipbench.work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_reference_package(tmp_path):
    got = _python(SMOKE_RUN.format(repo=str(REPO), tmp=str(tmp_path)))
    assert got["correct"] is True
    assert "repro_torch" in got["tops"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "optax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _python(REFERENCE_ONLY.format(repo=str(REPO)))
    assert "repro_torch" not in tops and "repro" not in tops
    assert "torch" in tops


def test_forbidden_names_are_whole_top_level_names():
    from chipbench import harness
    assert harness.forbidden_modules(
        ["repro_torch.models", "jaxtyping", "reprox", "torch.jax"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax", "jaxlib.xla_client", "optax"]) == [
            "jax", "jaxlib", "optax", "repro"]
