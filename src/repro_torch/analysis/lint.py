"""The port's AST lint rules (the second pass of the contract analyzer).

Five rules encode conventions the port's hot paths depend on but no
generic linter knows about. Each has a stable code usable in a suppression
comment (``# noqa: REPRO-003``) and a one-line rationale shown by
``scripts/lint_repro_torch.py --rules``. The codes are the reference's;
the rules read ``src/repro_torch``:

========== ================================================================
REPRO-001  no host read inside a hot-path function (``.item()``,
           ``.tolist()``, ``.cpu()``, ``.numpy()`` or an ``np.*`` call in
           the functions the contracts name: each one waits on the card)
REPRO-002  no draw from torch's global generator in library code (a
           ``torch.rand*``/``randn*``/``randint``/``normal`` call or an
           in-place sampler without ``generator=``: its stream is shared
           with every other caller, so a draw is not reproducible alone)
REPRO-003  no Python ``for`` loop over the scenario/batch axis in ``dsp/``
           and ``core/`` bank code (the batched engines exist to remove
           per-scenario Python iteration)
REPRO-004  registry entries are constructed via ``Registry.register`` —
           poking ``_entries`` bypasses duplicate/override protection
REPRO-005  no ``torch.float64`` / ``.double()`` / ``dtype=float64``
           outside the float64-by-design modules (an upcast in a float32
           path doubles memory traffic; the deliberate float64 modules are
           allow-listed, each with its reason)
========== ================================================================

Findings the design needs live in ``src/repro_torch/analysis/
baseline.json``, each with a reason; a run fails only when *new* findings
appear (see :func:`diff_against_baseline`). Baseline entries match on
(rule, path, source line text), not line numbers, so unrelated edits do
not churn the baseline.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "LintFinding", "LintRule", "RULES", "HOT_PATH_FUNCTIONS",
    "F64_MODULES", "lint_source", "lint_paths", "load_baseline",
    "save_baseline", "diff_against_baseline",
]


@dataclass(frozen=True)
class LintFinding:
    """One rule violation at one source location."""

    rule: str          # "REPRO-001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int
    message: str
    snippet: str       # stripped source line (baseline matching key)

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: stable across pure line-number drift."""
        return (self.rule, self.path, self.snippet)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}


@dataclass(frozen=True)
class LintRule:
    """A registered rule: stable code + scope predicate + AST check.

    ``check`` takes the module's tree, its source and its path."""

    code: str
    title: str
    rationale: str
    check: Callable[[ast.AST, str, str], List[Tuple[int, int, str]]]
    #: None = every file; else a predicate over the repo-relative path
    applies_to: Optional[Callable[[str], bool]] = None


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains ('' else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _posix(path: str) -> str:
    return path.replace("\\", "/")


# ---------------------------------------------------------------------------
# REPRO-001: no host read inside a hot-path function
# ---------------------------------------------------------------------------

#: The hot-path functions the contracts name, by module (path suffix). A
#: host read in one of them waits on the card once per call.
HOT_PATH_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "repro_torch/dsp/fused.py": ("fused_interval_scan",),
    "repro_torch/dsp/executor.py": ("sharded_step",),
    "repro_torch/dsp/simulator.py": ("step_batch_arrays",),
    "repro_torch/core/forecast_bank.py": (
        "_ring_push", "_arima_phi", "_arima_roll", "_arima_chunk",
        "_mad_threshold", "_detector_observe"),
    "repro_torch/core/gp_bank.py": ("_fit_packed", "_posterior_packed"),
    "repro_torch/fleet/ingest.py": ("epoch_reduce",),
    "repro_torch/kernels/ops.py": ("fused_interval", "fused_tick",
                                   "arima_chunk", "rls_rank1_update",
                                   "gp_lbfgs"),
}

#: Tensor methods that copy a device value to the host.
_HOST_READS = ("item", "tolist", "cpu", "numpy")


def _hot_functions(path: str) -> Tuple[str, ...]:
    p = _posix(path)
    return next((names for mod, names in HOT_PATH_FUNCTIONS.items()
                 if p.endswith(mod)), ())


def _check_host_read(tree: ast.AST, src: str, path: str):
    hot = set(_hot_functions(path))
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or node.name not in hot:
            continue
        for inner in ast.walk(node):
            if not isinstance(inner, ast.Call):
                continue
            fn = inner.func
            dotted = _dotted(fn)
            if isinstance(fn, ast.Attribute) and fn.attr in _HOST_READS:
                what = f"`.{fn.attr}()`"
            elif dotted.startswith(("np.", "numpy.")):
                what = f"numpy call `{dotted}(...)`"
            else:
                continue
            out.append((inner.lineno, inner.col_offset,
                        f"{what} inside the hot-path function "
                        f"`{node.name}` — a host read waits on the card "
                        f"every call; keep the value on the device"))
    return out


# ---------------------------------------------------------------------------
# REPRO-002: no draw from torch's global generator
# ---------------------------------------------------------------------------

#: torch functions drawing random numbers (``generator=`` selects a stream).
_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint",
             "randint_like", "randperm", "normal", "bernoulli",
             "multinomial", "poisson"}
#: in-place tensor samplers
_INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "exponential_",
                     "geometric_", "log_normal_", "cauchy_", "random_"}


def _check_global_generator(tree: ast.AST, src: str, path: str):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if any(kw.arg == "generator" for kw in node.keywords):
            continue
        dotted = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if dotted.startswith("torch.") and dotted.split(".", 1)[1] \
                in _SAMPLERS:
            what = f"`{dotted}(...)`"
        elif attr in _INPLACE_SAMPLERS:
            what = f"`.{attr}(...)`"
        else:
            continue
        out.append((node.lineno, node.col_offset,
                    f"{what} draws from torch's global generator — pass "
                    f"generator= (a torch.Generator seeded by the caller)"))
    return out


# ---------------------------------------------------------------------------
# REPRO-003: no Python for loop over the scenario/batch axis in bank code
# ---------------------------------------------------------------------------

#: Identifiers naming the scenario/batch axis length.
_AXIS_LENGTHS = {"n_scenarios", "n_streams", "n_rows", "n_members", "S", "B"}
#: Containers whose elements are per-scenario/per-stream objects.
_AXIS_CONTAINERS = {"scenarios", "jobs", "streams"}
#: len(...) arguments that denote the scenario axis.
_AXIS_LEN_ARGS = {"seeds", "configs", "scenarios", "jobs", "streams"}


def _names_in(node: ast.AST) -> Iterable[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _iterates_scenario_axis(it: ast.expr) -> Optional[str]:
    """Why this iterable walks the scenario axis, or None."""
    call = it if isinstance(it, ast.Call) else None
    # Unwrap enumerate(...) / zip(...): any scenario-axis operand counts.
    if call is not None and _dotted(call.func) in ("enumerate", "zip"):
        for a in call.args:
            why = _iterates_scenario_axis(a)
            if why:
                return why
        return None
    if call is not None and _dotted(call.func) == "range":
        for a in call.args:
            for name in _names_in(a):
                if name in _AXIS_LENGTHS:
                    return f"range over scenario-axis length `{name}`"
            for n in ast.walk(a):
                if isinstance(n, ast.Call) and _dotted(n.func) == "len" \
                        and n.args:
                    for name in _names_in(n.args[0]):
                        if name in _AXIS_LEN_ARGS:
                            return (f"range over len of per-scenario "
                                    f"container `{name}`")
        return None
    for name in _names_in(it):
        if name in _AXIS_CONTAINERS:
            return f"iterates per-scenario container `{name}`"
    return None


def _check_scenario_loop(tree: ast.AST, src: str, path: str):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        why = _iterates_scenario_axis(node.iter)
        if why:
            out.append((node.lineno, node.col_offset,
                        f"Python for loop over the scenario/batch axis "
                        f"({why}) — batch it or mark the reference oracle "
                        f"with `# noqa: REPRO-003`"))
    return out


def _rule3_scope(path: str) -> bool:
    p = _posix(path)
    return "/dsp/" in p or ("/core/" in p and "bank" in Path(p).name)


# ---------------------------------------------------------------------------
# REPRO-004: registries are populated via Registry.register only
# ---------------------------------------------------------------------------

def _check_registry_poke(tree: ast.AST, src: str, path: str):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "_entries":
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self":
                continue                      # Registry's own methods
            out.append((node.lineno, node.col_offset,
                        f"direct `{_dotted(node) or '_entries'}` access — "
                        f"construct registry entries via Registry.register "
                        f"(duplicate/override protection, canonical errors)"))
    return out


def _rule4_scope(path: str) -> bool:
    return not _posix(path).endswith("core/registry.py")


# ---------------------------------------------------------------------------
# REPRO-005: no float64 requests outside the float64-by-design modules
# ---------------------------------------------------------------------------

#: Modules whose float64 is the design, each with its reason.
F64_MODULES: Dict[str, str] = {
    "repro_torch/core/forecast.py": "the float64 NumPy forecaster zoo, the "
                                    "reference oracle",
    "repro_torch/core/gp.py": "the scalar GP oracle hands scipy float64 "
                              "gradients",
    "repro_torch/core/acquisition.py": "the scalar EHVI oracle mirrors the "
                                       "reference's float64 NumPy",
    "repro_torch/core/rgpe.py": "RGPE's ranking weights mirror the "
                                "reference's float64 NumPy",
    "repro_torch/core/anomaly.py": "the scalar detector oracle is float64 "
                                   "NumPy",
    "repro_torch/core/forecast_bank.py": "the forecast and detector banks "
                                         "step in float64 to agree with the "
                                         "scalar zoo",
    "repro_torch/dsp/simulator.py": "the simulator steps in float64, bit "
                                    "for bit with the NumPy engine",
    "repro_torch/dsp/fused.py": "the fused engine's lag and detector state "
                                "are the simulator's float64",
    "repro_torch/dsp/executor.py": "the sharded engine's lag is the "
                                   "simulator's float64",
    "repro_torch/kernels/ref.py": "the plain versions of the float64 "
                                  "kernels K1 and K2",
    "repro_torch/kernels/fused_tick.py": "K2 takes the simulator's float64 "
                                         "state",
    "repro_torch/kernels/rls_update.py": "K1 takes the banks' float64 state",
    "repro_torch/interop.py": "carries the reference's float64 state "
                              "across",
}


def _is_f64(node: ast.AST) -> bool:
    return _dotted(node) in ("torch.float64", "torch.double") or (
        isinstance(node, ast.Constant) and node.value == "float64")


def _check_f64(tree: ast.AST, src: str, path: str):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                _dotted(node) in ("torch.float64", "torch.double"):
            out.add((node.lineno, node.col_offset,
                     f"`{_dotted(node)}` outside a float64-by-design module "
                     f"— hot paths are float32 unless the contract says "
                     f"otherwise (allow-list: analysis.lint.F64_MODULES)"))
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "double" \
                and not node.args:
            out.add((node.lineno, node.col_offset,
                     "`.double()` outside a float64-by-design module"))
        for kw in node.keywords:
            if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value == "float64":
                out.add((kw.value.lineno, kw.value.col_offset,
                         '`dtype="float64"` outside a float64-by-design '
                         "module"))
        if isinstance(fn, ast.Attribute) and fn.attr in ("to", "astype") \
                and any(isinstance(a, ast.Constant) and a.value == "float64"
                        for a in node.args):
            out.add((node.lineno, node.col_offset,
                     f'`.{fn.attr}("float64")` outside a float64-by-design '
                     f"module"))
    return sorted(out)


def _rule5_scope(path: str) -> bool:
    p = _posix(path)
    return not any(p.endswith(m) for m in F64_MODULES)


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

RULES: Tuple[LintRule, ...] = (
    LintRule("REPRO-001", "no host read inside a hot-path function",
             "An .item()/.tolist()/.cpu()/.numpy() or np.* call in a "
             "function the contracts name waits on the card every call; "
             "keep the value on the device.",
             _check_host_read),
    LintRule("REPRO-002", "no draw from torch's global generator",
             "A sampler without generator= draws from a stream every "
             "caller shares — a run's randomness then depends on what ran "
             "before it.",
             _check_global_generator),
    LintRule("REPRO-003", "no Python loop over the scenario/batch axis",
             "The batched banks/engines exist to remove per-scenario "
             "Python iteration; a stray loop brings back a call per "
             "scenario.",
             _check_scenario_loop, applies_to=_rule3_scope),
    LintRule("REPRO-004", "registries are populated via Registry.register",
             "Dict pokes bypass duplicate protection and the canonical "
             "unknown-name error contract.",
             _check_registry_poke, applies_to=_rule4_scope),
    LintRule("REPRO-005", "no float64 requests outside float64 modules",
             "A float64 upcast in a float32 path doubles memory traffic and "
             "halves the card's rate; the deliberate float64 modules are "
             "allow-listed with their reasons.",
             _check_f64, applies_to=_rule5_scope),
)

#: `# noqa: REPRO-001` or `# noqa: REPRO-001, REPRO-005` (bare `# noqa`
#: deliberately does NOT suppress — escapes must name the rule).
_NOQA = re.compile(r"#\s*noqa:\s*([A-Z0-9, -]+)")


def _suppressed(line_text: str, code: str) -> bool:
    m = _NOQA.search(line_text)
    if not m:
        return False
    return code in {c.strip() for c in m.group(1).split(",")}


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str,
                rules: Sequence[LintRule] = RULES) -> List[LintFinding]:
    """Lint one module's source; ``path`` is the repo-relative posix path
    (rule scoping and finding identity both key on it)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as exc:
        return [LintFinding("REPRO-000", path, exc.lineno or 0, 0,
                            f"syntax error: {exc.msg}", "")]
    lines = src.splitlines()
    findings: List[LintFinding] = []
    for rule in rules:
        if rule.applies_to is not None and not rule.applies_to(path):
            continue
        for line, col, message in rule.check(tree, src, path):
            text = lines[line - 1] if 0 < line <= len(lines) else ""
            if _suppressed(text, rule.code):
                continue
            findings.append(LintFinding(rule.code, path, line, col,
                                        message, text.strip()))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(root: Path, paths: Sequence[Path],
               rules: Sequence[LintRule] = RULES) -> List[LintFinding]:
    """Lint every ``*.py`` file under ``paths`` (files or directories)."""
    files: List[Path] = []
    for p in paths:
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: List[LintFinding] = []
    for f in files:
        rel = f.resolve().relative_to(root.resolve()).as_posix()
        findings.extend(lint_source(f.read_text(), rel, rules))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def _key_of(d: Dict[str, object]) -> Tuple[str, str, str]:
    return (str(d.get("rule")), str(d.get("path")),
            str(d.get("snippet", "")).strip())


def load_baseline(path: Path) -> List[Dict[str, object]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", data) if isinstance(data, dict)
                else data)


def save_baseline(path: Path, findings: Sequence[LintFinding]) -> None:
    """Write ``findings`` as the baseline, keeping the ``reason`` of every
    entry already baselined under the same (rule, path, snippet)."""
    reasons = {_key_of(e): e["reason"] for e in load_baseline(path)
               if e.get("reason")}
    entries = []
    for f in findings:
        entry = f.to_dict()
        entry["reason"] = reasons.get(f.key(), "")
        entries.append(entry)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"findings": entries}
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def diff_against_baseline(findings: Sequence[LintFinding],
                          baseline: Sequence[Dict[str, object]]
                          ) -> Tuple[List[LintFinding],
                                     List[Dict[str, object]]]:
    """(new findings, fixed baseline entries). Matching is by
    (rule, path, snippet) with multiplicity — two identical loops in one
    file need two baseline entries."""
    remaining: Dict[Tuple[str, str, str], int] = {}
    for entry in baseline:
        k = _key_of(entry)
        remaining[k] = remaining.get(k, 0) + 1

    new: List[LintFinding] = []
    for f in findings:
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            new.append(f)
    fixed = []
    for entry in baseline:
        k = _key_of(entry)
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            fixed.append(entry)
    return new, fixed
