"""The port's documented examples (``docs/torch/*.md``).

* ``scripts/check_docs_torch.py`` passes: every local link resolves and
  every fenced doctest runs (on the CPU) with the output the page states;
* the pages carry one prompt for each of the reference docs' fenced
  prompts (``docs/*.md``, which ``scripts/check_docs.py`` runs), so a
  prompt added there without its port counterpart shows here.

Nothing here imports ``jax`` or ``repro``.
"""
import importlib.util
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PROMPT = re.compile(r"^>>> ", re.M)


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_docs_torch", REPO / "scripts" / "check_docs_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prompts(paths, checker) -> int:
    return sum(len(PROMPT.findall(block)) for p in paths
               for block in checker.doctest_blocks(p))


def test_port_docs_pass_the_checker(capsys):
    assert _checker().main() == 0
    assert capsys.readouterr().out.startswith("docs OK: 1 files")


def test_port_docs_carry_every_reference_prompt():
    checker = _checker()
    ref = _prompts(sorted((REPO / "docs").glob("*.md")), checker)
    port = _prompts(checker.DOC_FILES, checker)
    assert ref == port == 32
    text = "".join(p.read_text() for p in checker.DOC_FILES)
    assert not re.search(r"^>>> .*\b(import|from) (jax|repro)\b", text, re.M)
