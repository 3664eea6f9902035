"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Each smoke config runs all four shapes at the single-pod (data=16,
model=16) mesh through the CLI's ``--smoke`` (``lower_cell`` on a fake
256-rank process group, the cells on the ``meta`` device), in a process
of its own: the fake group is process state. The records:

* ``skipped`` exactly where the reference's ``cell_supported`` says so;
* every ``ok`` cell has ``flops > 0`` and ``memory.argument_bytes`` equal
  to the specs' own reckoning (each parameter, moment, input and cache
  leaf's shard under its sanitized spec), ``train_4k`` moves bytes in
  collectives, and the fields the port cannot give are ``None``;
* every cell that is not skipped is ``ok``, in every family.

The collective census counts one all-gather of known bytes on a matmul of
two DTensors; the CLI writes a full-size cell's record and skips it once
cached.
"""
import concurrent.futures
import json
import math
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

import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.launch.specs import cell_supported as ref_cell_supported  # noqa: E402,E501
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.distributed import (cache_shardings,  # noqa: E402
                                     param_shardings)
from repro_torch.launch.specs import (SHAPE_KIND, SHAPES,  # noqa: E402
                                      input_specs)

SRC = Path(__file__).parent.parent / "src"
MESH = {"data": 16, "model": 16}


def _run(args, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], env=env, check=True,
                          timeout=timeout, capture_output=True, text=True)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every smoke config's four cells, 2 processes at a time."""
    out = tmp_path_factory.mktemp("dryrun")

    def cells(arch):
        path = out / f"{arch}.json"
        _run(["-m", "repro_torch.launch.dryrun", "--smoke", "--mesh",
              "single", "--arch", arch, "--out", str(path)])
        recs = json.loads(path.read_text())
        return arch, {shape: recs[f"{arch}/{shape}/single/smoke"]
                      for shape in SHAPES}
    slow_first = sorted(ARCH_IDS, key=lambda a: get_config(a).family
                        not in ("ssm", "hybrid"))   # the SSD scan's loop
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(pool.map(cells, slow_first))


def _shard_bytes(t, sharding) -> int:
    """One rank's bytes of ``t`` under ``sharding``'s spec on ``MESH``."""
    n = 1
    for dim, entry in zip(t.shape, sharding.spec + (None,) * t.ndim):
        ways = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            ways *= MESH.get(a, 1) if a else 1
        n *= dim // ways
    return n * t.element_size()


def _argument_bytes(cfg, shape) -> int:
    spec = input_specs(cfg.scaled(attention_impl="reference"), shape)
    params = dict(spec["params"].named_parameters())
    sh = param_shardings(MESH, params)
    total = sum(_shard_bytes(p, sh[k]) for k, p in params.items())
    if spec["kind"] == "train":
        # float32 moments under the parameters' specs, and the int32 step
        total += sum(2 * _shard_bytes(p.float(), sh[k])
                     for k, p in params.items()) + 4
    for t in spec["inputs"].values():
        lead = t.shape[0]
        split = lead % MESH["data"] == 0 and lead >= MESH["data"]
        total += t.numel() * t.element_size() // (MESH["data"] if split
                                                  else 1)
    cache = spec.get("cache") or {}
    csh = cache_shardings(MESH, cache)
    total += sum(_shard_bytes(t, csh[k]) for k, t in cache.items()
                 if isinstance(t, torch.Tensor))
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells(records, arch):
    cfg, ref_cfg = smoke_config(arch), ref_smoke_config(arch)
    for shape, rec in records[arch].items():
        ok, reason = ref_cell_supported(ref_cfg, shape)
        if not ok:
            assert rec == {"arch": arch, "shape": shape, "mesh": "single",
                           "status": "skipped", "reason": reason}
            continue
        assert rec["status"] == "ok", (shape, rec.get("error"))
        assert rec["devices"] == 256 and rec["flops"] > 0
        assert rec["memory"]["argument_bytes"] == _argument_bytes(cfg, shape)
        assert rec["collective_total"] == sum(rec["collective_bytes"].values())
        if SHAPE_KIND[shape] == "train":
            assert rec["collective_total"] > 0
        assert rec["bytes_accessed"] is None
        assert all(rec["memory"][k] is None
                   for k in ("output_bytes", "temp_bytes", "peak_bytes"))


def test_census_counts_one_all_gather_of_a_matmul():
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.dryrun import CellCensus
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((4,), ("model",), device="cpu")
        a = distribute_tensor(torch.ones(8, 16, device="meta"), mesh,
                              [Shard(0)])
        b = distribute_tensor(torch.ones(16, 32, device="meta"), mesh,
                              [Shard(1)])
        with CellCensus() as census:
            y = a @ b
    finally:
        dist.destroy_process_group()
    # DTensor gathers the smaller operand (a, 8 x 16 float32) and each rank
    # multiplies it by its 8 columns of b
    assert y.placements == (Shard(1),)
    assert census.collective_bytes == {
        "all-gather": 8 * 16 * 4, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert census.flops == 2 * 8 * 16 * (32 // 4)


def test_cli_writes_a_full_size_record_and_skips_it_cached(tmp_path):
    out = tmp_path / "dryrun.json"
    args = ["-m", "repro_torch.launch.dryrun", "--arch", "deepseek_7b",
            "--shape", "decode_32k", "--mesh", "single", "--out", str(out)]
    first = _run(args)
    rec = json.loads(out.read_text())["deepseek_7b/decode_32k/single"]
    assert rec["status"] == "ok" and rec["devices"] == 256, first.stdout
    assert rec["memory"]["argument_bytes"] == \
        _argument_bytes(get_config("deepseek_7b"), "decode_32k")
    # the KV cache dominates: 2 x 30 layers x 128 x 32768 x 32 heads x 128
    # bf16 values, batch over 16 ranks and heads over 16
    cache = 2 * 30 * 128 * 32768 * 32 * 128 * 2 // 256
    assert rec["memory"]["argument_bytes"] > cache
    assert math.isfinite(rec["flops"]) and rec["collective_total"] > 0
    again = _run(args)
    assert "[skip cached] deepseek_7b/decode_32k/single" in again.stdout
