"""Documentation checks for the PyTorch port: link integrity and the
doctests of the fenced examples in ``docs/torch/*.md``.

The reference's ``scripts/check_docs.py`` checks ``README.md`` and
``docs/*.md``; this one checks the port's pages, which carry the
reference's fenced examples under the port's names. Exit code 0 when
everything passes; failures are listed on stderr. Run as::

    PYTHONPATH=src python scripts/check_docs_torch.py
"""
from __future__ import annotations

import doctest
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DOC_FILES = sorted((REPO / "docs" / "torch").glob("*.md"))

if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def check_links(path: Path) -> list[str]:
    errors = []
    for target in _LINK.findall(path.read_text()):
        if target.startswith(("http://", "https://", "mailto:", "#")):
            continue
        local = target.split("#", 1)[0]
        if local and not (path.parent / local).exists():
            errors.append(f"{path.relative_to(REPO)}: broken link -> {target}")
    return errors


def doctest_blocks(path: Path) -> list[str]:
    """The fenced ``python`` blocks of ``path`` that hold ``>>>`` prompts."""
    return [b for b in _FENCE.findall(path.read_text()) if ">>>" in b]


def check_doctests(path: Path) -> list[str]:
    errors = []
    parser = doctest.DocTestParser()
    for i, block in enumerate(doctest_blocks(path)):
        runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
        test = parser.get_doctest(block, {}, f"{path.name}[{i}]", str(path), 0)
        out: list[str] = []
        runner.run(test, out=out.append)
        if runner.failures:
            errors.append(f"{path.relative_to(REPO)}: doctest block {i} "
                          f"failed\n" + "".join(out))
    return errors


def main() -> int:
    errors: list[str] = []
    if not DOC_FILES:
        errors.append("no docs/torch/*.md page")
    for path in DOC_FILES:
        errors += check_links(path) + check_doctests(path)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        print(f"\n{len(errors)} documentation problem(s)", file=sys.stderr)
        return 1
    print(f"docs OK: {len(DOC_FILES)} files, links + fenced doctests clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
