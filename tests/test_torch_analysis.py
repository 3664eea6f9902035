"""The port's contract analyzer and lint (a port of ``tests/test_analysis.py``
under the port's names).

Three layers, class by class as in the reference's file:

* contract fields — a known-good and a known-bad call per
  :class:`~repro_torch.analysis.contracts.CompilationContract` field, run
  here on the CPU (the launch counters, the sync debug mode and the CUDA
  graph replay are card checks: ``tests/test_torch_cuda.py``);
* probes and registries — every entry of the port's five registries has a
  contract that holds on the CPU, and the contract names are the
  reference's;
* lint rules — a firing and a non-firing snippet per REPRO-00x rule, plus
  noqa/scoping/baseline mechanics, and the scripts as a user runs them.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.analysis.contracts import (  # noqa: E402
    COLLECTIVE_OPS, KERNEL_DISPATCHES, CompilationContract, ContractProbe,
    check_contract, count_loads, host_probe, run_probe)
from repro_torch.analysis.lint import (  # noqa: E402
    F64_MODULES, HOT_PATH_FUNCTIONS, RULES, LintFinding,
    diff_against_baseline, lint_source, load_baseline, save_baseline)
from repro_torch.core.registry import Registry  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _violating_fields(report):
    return {v.field for v in report.violations}


def _registries(pkg):
    """The five registries of ``pkg`` ("repro" or "repro_torch"), populated."""
    import importlib
    for mod in ("core.anomaly", "core.demeter", "core.forecast_bank",
                "dsp.executor", "dsp.fused", "fleet.api"):
        importlib.import_module(f"{pkg}.{mod}")
    reg = importlib.import_module(f"{pkg}.core.registry")
    return (reg.SIM_ENGINES, reg.FIT_BACKENDS, reg.FORECAST_BACKENDS,
            reg.DETECTOR_BACKENDS, reg.FLEET_BACKENDS)


def _probes(factory, *args):
    probes = factory(*args)
    return probes if isinstance(probes, list) else [probes]


# ---------------------------------------------------------------------------
# contract fields: one good + one bad call each
# ---------------------------------------------------------------------------

class TestContractFields:
    def test_empty_contract_passes_trivially(self):
        rep = check_contract(lambda x: x + 1.0, (torch.ones(4),),
                             CompilationContract())
        assert rep.ok and rep.n_ops >= 1

    def test_forbidden_ops(self):
        fn = lambda a: a @ a                              # noqa: E731
        args = (torch.ones((8, 8)),)
        bad = check_contract(fn, args,
                             CompilationContract(forbidden_ops=("aten.mm",)))
        good = check_contract(fn, args,
                              CompilationContract(forbidden_ops=("c10d.",)))
        assert not bad.ok and _violating_fields(bad) == {"forbidden_ops"}
        assert good.ok

    def test_collectives_are_forbidden_ops(self):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            rep = check_contract(
                lambda x: dist.all_reduce(x), (torch.ones(4),),
                CompilationContract(forbidden_ops=COLLECTIVE_OPS,
                                    forbid_host_sync=False))
        finally:
            dist.destroy_process_group()
        assert not rep.ok and _violating_fields(rep) == {"forbidden_ops"}
        assert "c10d.allreduce_" in str(rep.violations[0])

    def test_launches_count_kernel_dispatches(self):
        n = 3
        args = (torch.zeros(n, dtype=torch.float64),
                torch.zeros(n, dtype=torch.float64),
                torch.full((n,), 5e4, dtype=torch.float64),
                torch.full((n,), 4e4, dtype=torch.float64),
                torch.zeros(n, dtype=torch.bool),
                torch.zeros((n, 2), dtype=torch.float64),
                torch.eye(2, dtype=torch.float64).repeat(n, 1, 1),
                torch.zeros(n, dtype=torch.float64), 0.995, 3.0, 5.0)

        def twice(*a):
            ops.fused_tick(*a)
            return ops.fused_tick(*a)

        good = check_contract(twice, args, CompilationContract(
            launches={"fused_tick": 2, "fused_interval": 0}))
        bad = check_contract(twice, args, CompilationContract(
            launches={"fused_tick": 1}))
        assert good.ok and good.launches == {"fused_tick": 2,
                                             "fused_interval": 0}
        assert "launch counters" in good.skipped          # no card here
        assert not bad.ok and _violating_fields(bad) == {"launches"}
        # a kernel dispatch is one operation: its plain version is opaque
        assert good.n_ops == 2

    def test_every_kernel_dispatch_has_a_counted_wrapper(self):
        from repro_torch.analysis.contracts import _kernel_wrapper
        for name in KERNEL_DISPATCHES:
            assert callable(getattr(ops, name))
            assert isinstance(_kernel_wrapper(name).launches, int)

    def test_in_place(self):
        state = {"acc": torch.zeros(4)}

        def good_step(x):
            state["acc"].add_(x)

        def rebinding_step(x):
            state["acc"] = state["acc"] + x

        contract = CompilationContract(in_place=("acc",))
        assert check_contract(good_step, (torch.ones(4),), contract,
                              state=state).ok
        bad = check_contract(rebinding_step, (torch.ones(4),), contract,
                             state=state)
        assert not bad.ok and _violating_fields(bad) == {"in_place"}
        assert "data_ptr moved" in str(bad.violations[0])
        idle = check_contract(lambda x: x * 2, (torch.ones(4),), contract,
                              state=state)
        assert not idle.ok and "did not change" in str(idle.violations[0])
        missing = check_contract(good_step, (torch.ones(4),),
                                 CompilationContract(in_place=("nope",)),
                                 state=state)
        assert not missing.ok and "no state tensor" in str(
            missing.violations[0])

    def test_max_ops(self):
        fn = lambda x: x * 2 + 1 - x / 3                  # noqa: E731
        args = (torch.ones(4),)
        assert check_contract(fn, args, CompilationContract(max_ops=32)).ok
        bad = check_contract(fn, args, CompilationContract(max_ops=1))
        assert not bad.ok and _violating_fields(bad) == {"max_ops"}
        assert "ops > budget" in str(bad.violations[0])
        assert bad.n_ops == 4

    def test_dtype_ceiling(self):
        fn = lambda x: x.to(torch.float64) * 2.0          # noqa: E731
        args = (torch.ones(4, dtype=torch.float32),)
        bad = check_contract(fn, args,
                             CompilationContract(dtype_ceiling="float32"))
        good = check_contract(fn, args,
                              CompilationContract(dtype_ceiling="float64"))
        assert not bad.ok and _violating_fields(bad) == {"dtype_ceiling"}
        assert good.ok and "float64" in good.dtypes
        # an input above the ceiling counts too
        assert not check_contract(
            lambda x: x, (torch.ones(2, dtype=torch.float64),),
            CompilationContract(dtype_ceiling="float32")).ok

    @pytest.mark.parametrize("read", [
        lambda x: x.sum().item(),
        lambda x: torch.nonzero(x),
        lambda x: x[x > 0.5],
        lambda x: torch.nn.functional.one_hot(x.long(), 4),
    ], ids=["item", "nonzero", "mask-index", "one_hot"])
    def test_forbid_host_sync(self, read):
        args = (torch.ones(4),)
        bad = check_contract(read, args,
                             CompilationContract(forbid_host_sync=True))
        ok = check_contract(read, args,
                            CompilationContract(forbid_host_sync=False))
        assert not bad.ok and _violating_fields(bad) == {"forbid_host_sync"}
        assert "host" in str(bad.violations[0])
        assert ok.ok

    def test_max_loads(self, monkeypatch):
        # a loader that builds one library per shape, against one that
        # builds one library for every shape
        fake = functools.lru_cache(maxsize=None)(lambda name: name)
        monkeypatch.setattr(build, "load", fake)
        shapes = [((n,), {}) for n in (2, 3, 3, 4)]
        per_shape = count_loads(lambda n: build.load(f"lib{n}"), shapes)
        shared = count_loads(lambda n: build.load("lib"), shapes)
        assert (per_shape, shared) == (3, 1)
        fn, args = (lambda x: x * 2.0), (torch.ones(2),)
        bad = check_contract(fn, args, CompilationContract(max_loads=1),
                             n_loads=per_shape)
        good = check_contract(fn, args, CompilationContract(max_loads=1),
                              n_loads=shared)
        assert not bad.ok and _violating_fields(bad) == {"max_loads"}
        assert good.ok and good.n_loads == 1

    def test_count_loads_keeps_earlier_load_walls(self, monkeypatch):
        fake = functools.lru_cache(maxsize=None)(lambda n: n)
        monkeypatch.setattr(build, "load", fake)
        monkeypatch.setattr(build, "load_wall_s", {"lib": 12.5})
        fake("other")
        assert count_loads(lambda: build.load("lib"), [((), {})]) == 1
        assert build.load_wall_s == {"lib": 12.5}
        # the loader's cache is left as it is, and the loader restored
        assert fake.cache_info().currsize == 2 and build.load is fake

    def test_graph_capturable_is_a_card_check(self):
        rep = check_contract(lambda x: x + 1.0, (torch.ones(4),),
                             CompilationContract(graph_capturable=True))
        assert rep.ok and rep.skipped == ("graph replay",)

    def test_cpu_plain_versions_are_opaque(self):
        # lbfgs_batched reads the host every line-search trial; on the card
        # the same call is one kernel launch, so the checker does not look
        # inside the dispatch
        from repro_torch.kernels.ref import gp_lbfgs_ref
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.random((1, 4, 2)), dtype=torch.float32)
        y = torch.as_tensor(rng.standard_normal((1, 4)), dtype=torch.float32)
        m = torch.ones((1, 4))
        t0 = torch.zeros((1, 4))
        raw = check_contract(gp_lbfgs_ref, (x, y, m, t0, 1, 3),
                             CompilationContract())
        via_ops = check_contract(ops.gp_lbfgs, (x, y, m, t0),
                                 CompilationContract(),
                                 kwargs=dict(restarts=1, max_iter=3))
        assert not raw.ok and _violating_fields(raw) == {"forbid_host_sync"}
        assert via_ops.ok and via_ops.n_ops == 1


# ---------------------------------------------------------------------------
# probes + registry attachment
# ---------------------------------------------------------------------------

#: Contract probes the port adds beyond the reference's: the GP fit is plain
#: JAX in the reference and a hand-written kernel here, which gets its own
#: probe (the one whose CUDA-graph replay is checked).
PORT_ONLY_CONTRACTS = {("fit backend", "bank"): {"kernel:gp-lbfgs"}}


class TestProbesAndRegistry:
    def test_host_probe_passes_with_note(self):
        rep = run_probe(host_probe("x:y", "numpy oracle"))
        assert rep.ok and "numpy oracle" in rep.note

    def test_run_probe_checks_contract(self):
        probe = ContractProbe(
            contract=CompilationContract(name="t", max_ops=1),
            fn=lambda x: x * 2 + 1, args=(torch.ones(2),))
        rep = run_probe(probe)
        assert not rep.ok and rep.name == "t"

    def test_attach_requires_registered_name(self):
        reg = Registry("widget")
        with pytest.raises(ValueError, match="unknown widget"):
            reg.attach_contract("nope", lambda device="cpu": None)

    def test_contract_for_missing_raises(self):
        reg = Registry("widget")
        reg.register("a", object())
        with pytest.raises(ValueError, match="no attached compilation"):
            reg.contract_for("a")
        assert not reg.has_contract("a")

    def test_unregister_and_override_pop_contract(self):
        reg = Registry("widget")
        reg.register("a", object())
        reg.attach_contract("a", lambda device="cpu": host_probe("a", ""))
        assert reg.has_contract("a")
        reg.register("a", object(), override=True)
        assert not reg.has_contract("a")      # stale contract dropped
        reg.attach_contract("a", lambda device="cpu": host_probe("a", ""))
        reg.unregister("a")
        reg.register("a", object())
        assert not reg.has_contract("a")

    def test_every_registered_backend_has_a_passing_contract(self):
        for reg in _registries("repro_torch"):
            assert len(reg)
            for name in reg:
                assert reg.has_contract(name), \
                    f"{reg.kind}:{name} registered without a contract"
                for p in _probes(reg.contract_for(name), "cpu"):
                    rep = run_probe(p)
                    assert rep.ok, rep.summary()

    def test_contract_names_are_the_references(self):
        port = {(r.kind, n): {p.contract.name
                              for p in _probes(r.contract_for(n), "cpu")}
                for r in _registries("repro_torch") for n in r}
        ref = {(r.kind, n): {p.contract.name
                             for p in _probes(r.contract_for(n))}
               for r in _registries("repro") for n in r}
        assert set(port) == set(ref)
        for key, names in ref.items():
            assert port[key] == names | PORT_ONLY_CONTRACTS.get(key, set()), \
                key

    def test_kernel_probes_pin_launches_and_graph_replay(self):
        """K2's interval, K1's chunk and the GP fit kernel carry the launch
        budgets and the CUDA-graph check; the per-tick kernels run on no
        path of the engines and banks."""
        contracts = {p.contract.name: p.contract
                     for r in _registries("repro_torch") for n in r
                     for p in _probes(r.contract_for(n), "cpu")}
        assert dict(contracts["engine:fused"].launches) == \
            {"fused_interval": 1, "fused_tick": 0}
        assert dict(contracts["forecast backend:bank"].launches) == \
            {"arima_chunk": 1, "rls_rank1_update": 0}
        assert dict(contracts["detector backend:bank"].launches) == \
            {"arima_chunk": 1}
        assert dict(contracts["fit backend:bank"].launches) == \
            {"gp_lbfgs": 1}
        assert {n for n, c in contracts.items() if c.graph_capturable} == \
            {"engine:fused", "forecast backend:bank", "kernel:gp-lbfgs"}
        assert contracts["fit backend:bank"].dtype_ceiling == "float32"
        assert contracts["fleet backend:ingest"].dtype_ceiling == "float32"
        for name in ("engine:fused", "engine:sharded",
                     "forecast backend:bank", "detector backend:bank"):
            assert contracts[name].dtype_ceiling == "float64"

    def test_sharded_contract_forbids_collectives_and_pins_lag(self):
        from repro_torch.dsp.executor import SHARDED_STEP_CONTRACT
        assert set(COLLECTIVE_OPS) <= set(SHARDED_STEP_CONTRACT.forbidden_ops)
        assert SHARDED_STEP_CONTRACT.in_place == ("lag",)
        assert SHARDED_STEP_CONTRACT.forbid_host_sync

    def test_obs_companion_probe_catches_an_added_op(self):
        from repro_torch import obs

        def leaky(x):
            y = x * 2.0
            if obs.enabled():
                obs.set_gauge("leak", float(y.sum()))     # an extra op
            return y

        probe = obs.probe.instrumentation_contract_probe(
            "test:leaky", leaky, (torch.ones(3),))
        rep = run_probe(probe)
        assert not rep.ok and _violating_fields(rep) == {"obs_neutral"}
        assert "aten." in str(rep.violations[0])
        clean = obs.probe.instrumentation_contract_probe(
            "test:clean", lambda x: x * 2.0, (torch.ones(3),))
        assert run_probe(clean).ok


# ---------------------------------------------------------------------------
# lint rules: firing + non-firing snippet per rule
# ---------------------------------------------------------------------------

def _codes(findings):
    return [f.rule for f in findings]


class TestLintRules:
    @pytest.mark.parametrize("read", ["x.item()", "x.tolist()", "x.cpu()",
                                      "x.numpy()", "np.asarray(x)"])
    def test_rule_001_host_read_in_hot_path(self, read):
        bad = ("import numpy as np\n"
               "def fused_interval_scan(x):\n"
               f"    return {read}\n")
        path = "src/repro_torch/dsp/fused.py"
        assert _codes(lint_source(bad, path)) == ["REPRO-001"]
        # the same read outside a hot-path function is not this rule's
        assert lint_source(bad.replace("fused_interval_scan", "report"),
                           path) == []
        good = bad.replace(read, "x * 2")
        assert lint_source(good, path) == []

    def test_rule_001_table_names_real_functions(self):
        import ast
        for mod, names in HOT_PATH_FUNCTIONS.items():
            tree = ast.parse((REPO / "src" / mod).read_text())
            defined = {n.name for n in ast.walk(tree)
                       if isinstance(n, ast.FunctionDef)}
            assert set(names) <= defined, (mod, set(names) - defined)

    def test_rule_002_global_generator(self):
        bad = ("import torch\n"
               "def f():\n"
               "    a = torch.randn(3)\n"
               "    return a.normal_()\n")
        good = ("import torch\n"
                "def f(g):\n"
                "    a = torch.randn(3, generator=g)\n"
                "    return a.normal_(generator=g)\n")
        path = "src/repro_torch/models/m.py"
        assert _codes(lint_source(bad, path)) == ["REPRO-002", "REPRO-002"]
        assert lint_source(good, path) == []

    def test_rule_003_scenario_loop_in_bank_code(self):
        bad = ("def step(self, rates):\n"
               "    for i in range(self.n_scenarios):\n"
               "        self.one(i)\n")
        # Same code outside dsp/ or core/*bank* files: out of scope.
        assert _codes(lint_source(bad, "src/repro_torch/dsp/engine.py")) \
            == ["REPRO-003"]
        assert lint_source(bad, "src/repro_torch/core/demeter.py") == []
        good = ("def step(self, rates):\n"
                "    for i in range(self.n_retries):\n"
                "        self.one(i)\n")
        assert lint_source(good, "src/repro_torch/dsp/engine.py") == []

    def test_rule_003_zip_over_jobs(self):
        bad = ("def step(self, rates):\n"
               "    for job, r in zip(self.jobs, rates):\n"
               "        job.step(r)\n")
        assert _codes(lint_source(bad, "src/repro_torch/dsp/engine.py")) \
            == ["REPRO-003"]

    def test_rule_004_registry_poke(self):
        bad = "CONTROLLERS._entries['mine'] = Thing()\n"
        good = "CONTROLLERS.register('mine', Thing())\n"
        assert _codes(lint_source(bad, "src/repro_torch/dsp/plugin.py")) \
            == ["REPRO-004"]
        assert lint_source(good, "src/repro_torch/dsp/plugin.py") == []
        # Registry's own implementation is exempt.
        assert lint_source(bad, "src/repro_torch/core/registry.py") == []

    @pytest.mark.parametrize("expr", ["x.to(torch.float64)", "x.double()",
                                      "torch.zeros(3, dtype='float64')",
                                      "x.to('float64')",
                                      "x.to(dtype=torch.double)"])
    def test_rule_005_f64_outside_allow_list(self, expr):
        bad = ("import torch\n"
               "def f(x):\n"
               f"    return {expr}\n")
        assert _codes(lint_source(bad, "src/repro_torch/core/gp_bank.py")) \
            == ["REPRO-005"]
        # Allow-listed float64-by-design module: deliberate f64.
        assert lint_source(bad, "src/repro_torch/core/gp.py") == []
        assert lint_source(bad.replace("64", "32").replace("double", "float"),
                           "src/repro_torch/core/gp_bank.py") == []

    def test_rule_005_allow_list_has_reasons_and_real_modules(self):
        for mod, reason in F64_MODULES.items():
            assert (REPO / "src" / mod).is_file(), mod
            assert len(reason) > 10, mod

    def test_noqa_with_code_suppresses(self):
        src = ("import torch\n"
               "def f(x):\n"
               "    return x.to(torch.float64)  # noqa: REPRO-005\n")
        assert lint_source(src, "src/repro_torch/core/gp_bank.py") == []

    def test_bare_noqa_does_not_suppress(self):
        src = ("import torch\n"
               "def f(x):\n"
               "    return x.to(torch.float64)  # noqa\n")
        assert _codes(lint_source(src, "src/repro_torch/core/gp_bank.py")) \
            == ["REPRO-005"]

    def test_syntax_error_reports_repro_000(self):
        assert _codes(lint_source("def f(:\n", "src/x.py")) == ["REPRO-000"]

    def test_rules_table_is_complete(self):
        assert [r.code for r in RULES] == [
            "REPRO-001", "REPRO-002", "REPRO-003", "REPRO-004", "REPRO-005"]
        assert all(r.title and r.rationale for r in RULES)


class TestBaseline:
    def _finding(self, rule="REPRO-005", path="a.py", line=3,
                 snippet="x.to(torch.float64)"):
        return LintFinding(rule, path, line, 0, "msg", snippet)

    def test_baselined_finding_is_not_new(self):
        f = self._finding()
        new, fixed = diff_against_baseline([f], [f.to_dict()])
        assert new == [] and fixed == []

    def test_line_drift_does_not_churn(self):
        f = self._finding(line=3)
        base = self._finding(line=99).to_dict()
        new, fixed = diff_against_baseline([f], [base])
        assert new == [] and fixed == []

    def test_new_and_fixed(self):
        cur = self._finding(snippet="b")
        base = self._finding(snippet="a").to_dict()
        new, fixed = diff_against_baseline([cur], [base])
        assert [f.snippet for f in new] == ["b"]
        assert [e["snippet"] for e in fixed] == ["a"]

    def test_multiplicity(self):
        f = self._finding()
        new, _ = diff_against_baseline([f, f], [f.to_dict()])
        assert len(new) == 1       # second occurrence is genuinely new

    def test_save_keeps_reasons(self, tmp_path):
        path = tmp_path / "baseline.json"
        f = self._finding()
        path.write_text(json.dumps({"findings": [
            {**f.to_dict(), "reason": "the design needs it"}]}))
        save_baseline(path, [self._finding(line=7), self._finding(
            snippet="other")])
        reasons = [e["reason"] for e in load_baseline(path)]
        assert reasons == ["the design needs it", ""]

    def test_port_baseline_entries_have_reasons(self):
        for entry in load_baseline(
                REPO / "src" / "repro_torch" / "analysis" / "baseline.json"):
            assert entry.get("reason"), entry


# ---------------------------------------------------------------------------
# the scripts (subprocess: what a user runs)
# ---------------------------------------------------------------------------

def _run(script, *argv):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / script), *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)


class TestScripts:
    def test_seeded_violation_turns_red(self, tmp_path):
        out = tmp_path / "contracts.json"
        res = _run("check_contracts_torch.py", "--device", "cpu",
                   "--seed-violation", "--only", "seeded-violation",
                   "--json", str(out))
        assert res.returncode == 1, res.stdout + res.stderr
        payload = json.loads(out.read_text())
        assert payload["ok"] is False
        fields = {v["field"] for r in payload["reports"]
                  for v in r["violations"]}
        assert fields == {"forbid_host_sync", "dtype_ceiling", "in_place"}

    def test_host_only_entries_pass_quickly(self):
        res = _run("check_contracts_torch.py", "--device", "cpu", "--only",
                   "engine:batched")
        assert res.returncode == 0, res.stdout + res.stderr
        assert "1/1 contracts hold" in res.stdout

    def test_every_registry_entry_is_checked_on_the_cpu(self, tmp_path):
        out = tmp_path / "contracts.json"
        res = _run("check_contracts_torch.py", "--device", "cpu", "--json",
                   str(out))
        assert res.returncode == 0, res.stdout + res.stderr
        names = {r["name"] for r in json.loads(out.read_text())["reports"]}
        want = {p.contract.name for r in _registries("repro_torch")
                for n in r for p in _probes(r.contract_for(n), "cpu")}
        assert names == want and len(names) == 17

    def test_cuda_without_a_card_refuses(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        res = _run("check_contracts_torch.py", "--only", "engine:batched")
        assert res.returncode == 1 and "--device cpu" in res.stdout

    def test_lint_runner_is_clean_against_baseline(self, tmp_path):
        out = tmp_path / "lint.json"
        res = _run("lint_repro_torch.py", "--json", str(out))
        assert res.returncode == 0, res.stdout + res.stderr
        payload = json.loads(out.read_text())
        assert payload["ok"] is True and payload["new"] == []

    def test_lint_paths_flags_a_new_finding(self, tmp_path):
        from repro_torch.analysis.lint import lint_paths
        pkg = tmp_path / "src" / "repro_torch" / "models"
        pkg.mkdir(parents=True)
        (pkg / "bad.py").write_text("import torch\nx = torch.rand(3)\n")
        findings = lint_paths(tmp_path, [tmp_path / "src"])
        assert [(f.rule, f.path) for f in findings] == [
            ("REPRO-002", "src/repro_torch/models/bad.py")]
        new, fixed = diff_against_baseline(findings, [])
        assert new == findings and fixed == []

    def test_rules_listing(self):
        res = _run("lint_repro_torch.py", "--rules")
        assert res.returncode == 0
        for code in ("REPRO-001", "REPRO-005"):
            assert code in res.stdout
