"""Run the port's AST lint (REPRO-001..005) against its baseline.

Lints ``src/repro_torch/`` with the rules in
:mod:`repro_torch.analysis.lint` and diffs the findings against
``src/repro_torch/analysis/baseline.json``: only *new* findings fail the
run. Baseline entries that no longer fire are reported as fixed (run with
``--update-baseline`` to retire them; entries keep their ``reason``).

Exit code 0 when no new findings; 1 otherwise. Run as::

    PYTHONPATH=src python scripts/lint_repro_torch.py [--json out.json]
    PYTHONPATH=src python scripts/lint_repro_torch.py --update-baseline
    PYTHONPATH=src python scripts/lint_repro_torch.py --rules   # the catalog
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/directories to lint (default: "
                         "src/repro_torch/)")
    ap.add_argument("--json", type=Path, default=None,
                    help="write findings + baseline diff as JSON")
    ap.add_argument("--baseline", type=Path, default=BASELINE)
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from repro_torch.analysis.lint import (RULES, diff_against_baseline,
                                           lint_paths, load_baseline,
                                           save_baseline)

    if args.rules:
        for r in RULES:
            print(f"{r.code}  {r.title}\n    {r.rationale}")
        return 0

    paths = args.paths or [REPO / "src" / "repro_torch"]
    findings = lint_paths(REPO, paths)
    new, fixed = diff_against_baseline(findings, load_baseline(args.baseline))

    if args.update_baseline:
        save_baseline(args.baseline, findings)
        print(f"baseline updated: {len(findings)} finding(s) recorded in "
              f"{args.baseline.relative_to(REPO)}")
        return 0

    for f in findings:
        tag = "NEW " if f in new else "base"
        print(f"{tag} {f}")
    for entry in fixed:
        print(f"fixed (retire from baseline): {entry.get('rule')} "
              f"{entry.get('path')}: {entry.get('snippet')}")

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"ok": not new,
             "findings": [f.to_dict() for f in findings],
             "new": [f.to_dict() for f in new],
             "fixed": list(fixed)}, indent=2) + "\n")
        print(f"wrote {args.json}")

    print(f"{len(findings)} finding(s), {len(new)} new, {len(fixed)} fixed")
    return 0 if not new else 1


if __name__ == "__main__":
    sys.exit(main())
