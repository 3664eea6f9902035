"""The port's standing rules.

* ``repro_torch`` imports neither ``jax`` nor ``repro``, at run time or in
  its source text (nor do ``chip_smoke.py`` and the port's examples,
  ``examples/*_torch.py``);
* ``chip_smoke.py`` refuses to run without a CUDA device and prints no
  result, also from a directory holding nothing else of the repo;
* the port keeps registries of its own: the reference's registries gain
  no entries from it;
* every entry point that places tensors (the sweep stack's, the serving
  stack's and the examples' ``main``) defaults to the card and raises
  without one, instead of running on the CPU unasked.
"""
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
#: the port's examples, beside the reference's
EXAMPLES = sorted(p.relative_to(REPO).as_posix()
                  for p in (REPO / "examples").glob("*_torch.py"))
IMPORT_RE = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")


def _env():
    import os
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    return env


@pytest.mark.parametrize("module", ["repro_torch", "repro_torch.dsp",
                                    "repro_torch.core",
                                    "repro_torch.interop",
                                    "repro_torch.dsp.runner",
                                    "repro_torch.kernels.flash_attention",
                                    "repro_torch.kernels.grouped_matmul",
                                    "repro_torch.kernels.rmsnorm",
                                    "repro_torch.kernels.gp_fit",
                                    "repro_torch.models",
                                    "repro_torch.models.moe",
                                    "repro_torch.models.mla",
                                    "repro_torch.configs",
                                    "repro_torch.serving",
                                    "repro_torch.launch.serve",
                                    "repro_torch.obs",
                                    "repro_torch.fleet",
                                    "repro_torch.fleet.loadgen",
                                    "repro_torch.training",
                                    "repro_torch.distributed",
                                    "repro_torch.launch.train",
                                    *EXAMPLES])
def test_port_imports_neither_jax_nor_reference(module):
    """Each module, or each example file (loaded by path), imported in a
    fresh interpreter leaves no ``jax`` or ``repro`` module loaded."""
    load = (f"import {module}" if not module.endswith(".py") else
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"{str(REPO / module)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
    code = (f"import sys\n{load}\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print('clean')")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_no_jax_or_reference_import_lines():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] \
        + [REPO / e for e in EXAMPLES]
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if IMPORT_RE.match(line)]
    assert not hits, hits


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_the_card(where, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], env=_env(),
                          cwd=str(script.parent), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_registries_are_its_own():
    from repro_torch.core.registry import (CONTROLLERS, DETECTOR_BACKENDS,
                                           FIT_BACKENDS, FLEET_BACKENDS,
                                           FORECAST_BACKENDS, FORECASTERS,
                                           SIM_ENGINES)
    from repro_torch.core import EngineConfig
    EngineConfig(device="cpu")           # registers every built-in
    assert SIM_ENGINES.available() == ("batched", "fused", "scalar",
                                      "sharded")
    assert CONTROLLERS.available() == ("demeter", "ds2", "reactive", "static")
    assert FORECASTERS.available() == ("arima", "holt", "seasonal")
    assert FIT_BACKENDS.available() == ("bank", "scalar")
    assert FORECAST_BACKENDS.available() == ("bank", "scalar")
    assert DETECTOR_BACKENDS.available() == ("bank", "scalar")
    assert FLEET_BACKENDS.available() == ("serving", "sim")
    assert "repro.core.registry" not in sys.modules or \
        "torch" not in sys.modules["repro.core.registry"].SIM_ENGINES


def _builders():
    """Each entry point that places tensors, called without ``device=``."""
    import numpy as np
    from repro_torch.core import (DemeterController, DetectorBank,
                                  ForecastBank, GP, GPBank, ModelBank,
                                  RecoveryTracker, SegmentStore,
                                  batched_posterior, paper_flink_space)
    from repro_torch.dsp import (BatchedSweepExecutor, ClusterModel,
                                 FusedSweepExecutor, JobConfig,
                                 ScalarSweepExecutor, profile_one,
                                 run_experiment, ysb_like)
    x = np.random.default_rng(0).uniform(0, 1, (4, 2))
    y = np.array([0.0, 1.0, 0.5, 2.0])
    gp = GP(x=x, y_mean=0.0, y_std=1.0, theta=np.zeros(4, np.float32),
            chol=np.eye(4, dtype=np.float32), alpha=np.zeros(4, np.float32))

    class Executor:
        def allocated_cost(self, c):
            return 1.0

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import run_engine
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, calibrate
    cfg = smoke_config("qwen2_7b")
    serve_args = types.SimpleNamespace(requests=1, rate=10.0, prompt_len=4,
                                       max_tokens=2, slots=1)

    executor_args = (ClusterModel(), [JobConfig()] * 2, [0, 1])
    from repro_torch.fleet import (FleetAPI, FleetConfig, FleetController,
                                   SoakConfig, run_soak)
    from repro_torch.fleet.api import main as fleet_main
    from repro_torch.fleet.loadgen import main as loadgen_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.training import (CheckpointManager, DataConfig,
                                      ElasticTrainer, FTConfig, TrainConfig)
    import shutil
    import tempfile
    # the trainer and the launcher raise before they create this directory
    ckpt_dir = str(Path(tempfile.gettempdir()) / "not_created")

    def restore():
        d = tempfile.mkdtemp()
        try:
            mgr = CheckpointManager(d)
            mgr.save(1, {"w": np.zeros(2)}, blocking=True)
            return mgr.restore(like={"w": np.zeros(2)})
        finally:
            shutil.rmtree(d)
    train_cfg = cfg.scaled(attention_impl="reference")

    def example(path):
        import importlib.util
        spec = importlib.util.spec_from_file_location("ex", REPO / path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return lambda: mod.main([])
    return {
        **{e: example(e) for e in EXAMPLES},
        "ElasticTrainer": lambda: ElasticTrainer(
            train_cfg, TrainConfig(), DataConfig(1, 8),
            FTConfig(checkpoint_dir=ckpt_dir)),
        "CheckpointManager.restore": restore,
        "python -m repro_torch.launch.train": lambda: train_main(
            ["--arch", "qwen2_7b", "--smoke", "--steps", "1",
             "--ckpt-dir", ckpt_dir]),
        "FleetController": lambda: FleetController(
            fleet=FleetConfig(capacity=2)),
        "FleetAPI": lambda: FleetAPI(fleet=FleetConfig(capacity=2)),
        "run_soak": lambda: run_soak(SoakConfig(n_jobs=2, epochs=1)),
        "python -m repro_torch.fleet": lambda: fleet_main(
            ["--capacity", "2"]),
        "python -m repro_torch.fleet.loadgen": lambda: loadgen_main(
            ["--jobs", "2", "--epochs", "1"]),
        "ServingEngine": lambda: ServingEngine(
            cfg, init_params(cfg, device="cpu"), n_slots=1, max_len=8),
        "init_params": lambda: init_params(cfg),
        "calibrate": lambda: calibrate(cfg),
        "launch.serve.run_engine": lambda: run_engine(cfg, serve_args),
        "FusedSweepExecutor": lambda: FusedSweepExecutor(
            *executor_args, dt=5.0, n_steps=4),
        "BatchedSweepExecutor": lambda: BatchedSweepExecutor(
            *executor_args, dt=5.0, n_steps=4),
        "ScalarSweepExecutor": lambda: ScalarSweepExecutor(
            *executor_args, dt=5.0, n_steps=4),
        "DetectorBank": lambda: DetectorBank(2),
        "RecoveryTracker(bank)": lambda: RecoveryTracker(
            detector_backend="bank"),
        "profile_one(bank)": lambda: profile_one(
            ClusterModel(), JobConfig(), JobConfig(), 4e4, 5.0, seed=0,
            detector_backend="bank"),
        "run_experiment": lambda: run_experiment(
            ysb_like(duration_s=600.0), "static"),
        "ForecastBank": lambda: ForecastBank(["arima", "holt"]),
        "GPBank.fit": lambda: GPBank.fit([(x, y)]),
        "batched_posterior": lambda: batched_posterior([gp], x),
        "ModelBank": lambda: ModelBank(SegmentStore(10_000.0)),
        "DemeterController": lambda: DemeterController(paper_flink_space(),
                                                       Executor()),
    }


@pytest.mark.parametrize("entry", sorted(
    ["FusedSweepExecutor", "BatchedSweepExecutor", "ScalarSweepExecutor",
     "DetectorBank", "RecoveryTracker(bank)", "profile_one(bank)",
     "run_experiment", "ForecastBank",
     "GPBank.fit", "batched_posterior", "ModelBank", "DemeterController",
     "ServingEngine", "init_params", "calibrate",
     "launch.serve.run_engine", "FleetController", "FleetAPI", "run_soak",
     "python -m repro_torch.fleet", "python -m repro_torch.fleet.loadgen",
     "ElasticTrainer", "CheckpointManager.restore",
     "python -m repro_torch.launch.train", *EXAMPLES]))
def test_entry_points_default_to_the_card(entry):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _builders()[entry]()

