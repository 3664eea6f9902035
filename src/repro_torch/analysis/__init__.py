"""Analysis of the port's hot paths (contracts) and source tree (lint).

Two passes:

* :mod:`repro_torch.analysis.contracts` — declarative
  :class:`~repro_torch.analysis.contracts.CompilationContract` invariants,
  checked by running each hot-path call under a dispatch recorder (aten
  operations, dtypes, host syncs, kernel launches, in-place state, CUDA
  graph replay on the card), attached to the entries of ``SIM_ENGINES`` /
  ``FIT_BACKENDS`` / ``FORECAST_BACKENDS`` / ``DETECTOR_BACKENDS`` /
  ``FLEET_BACKENDS`` and verified by ``scripts/check_contracts_torch.py``;
* :mod:`repro_torch.analysis.lint` — the port's AST rules
  (REPRO-001..005) run by ``scripts/lint_repro_torch.py`` against
  ``src/repro_torch/analysis/baseline.json``.
"""
from .contracts import (COLLECTIVE_OPS, HOST_SYNC_OPS, CompilationContract,
                        ContractProbe, ContractReport, ContractViolation,
                        check_contract, count_loads, host_probe, run_probe)
from .lint import (RULES, LintFinding, LintRule, diff_against_baseline,
                   lint_paths, lint_source, load_baseline, save_baseline)

__all__ = [
    "COLLECTIVE_OPS", "HOST_SYNC_OPS",
    "CompilationContract", "ContractProbe", "ContractReport",
    "ContractViolation", "check_contract", "count_loads", "host_probe",
    "run_probe",
    "RULES", "LintFinding", "LintRule", "lint_source", "lint_paths",
    "load_baseline", "save_baseline", "diff_against_baseline",
]
