"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` at first
use into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` in the checkout, and loaded with
:mod:`ctypes`. A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels.
#: ``--fmad=false``: nvcc would otherwise contract ``a*b + c`` into an FMA,
#: which rounds differently from PyTorch's separate multiply and add.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_C = ctypes.c_void_p
_D = ctypes.c_double
#: ctypes signature of each source's C entry point (every pointer and the
#: stream as c_void_p, so ctypes does not cut them to 32 bits).
SIGNATURES = {
    "fused_tick": ("fused_tick_launch",
                   [_C] * 8 + [_D, _D, _D, ctypes.c_int64] + [_C] * 6),
    "rls_update": ("rls_update_launch",
                   [_C] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                   + [_C] * 3),
    "decode_attention": ("decode_attention_launch",
                         [_C] * 6 + [ctypes.c_int64, ctypes.c_int64]
                         + [ctypes.c_int] * 6 + [_C]),
    "flash_attention": ("flash_attention_launch",
                        [_C] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 5
                        + [_C]),
    "ssd_scan": ("ssd_scan_launch",
                 [_C] * 7 + [ctypes.c_int64, ctypes.c_int64]
                 + [ctypes.c_int] * 6 + [_C]),
    "grouped_matmul": ("grouped_matmul_launch",
                       [_C] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4
                       + [_C]),
    "rmsnorm": ("fused_rmsnorm_launch",
                [_C] * 5 + [ctypes.c_int64, ctypes.c_int, _D, ctypes.c_int,
                            ctypes.c_int, _C]),
}

#: Wall spent building (where needed) and loading each library in this
#: process, by source name; set once, at the library's first use. The
#: sweep reports a kernel's share as its layer's first-use compile wall.
load_wall_s: Dict[str, float] = {}


def find_nvcc() -> str:
    """The ``nvcc`` on ``PATH``, else the toolkit's default location."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def nvcc_command(nvcc: str, source: Path, out: Path) -> List[str]:
    """The command that compiles ``source`` into the shared library ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by its content and flags."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. The compiler's output (``-Xptxas -v``:
    registers, spills) is kept beside the library as ``<lib>.log``."""
    return build_all([name])[name]


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together; returns each library's path. Raises after every
    compiler has finished if any of them failed."""
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(nvcc, CSRC_DIR / f"{name}.cu", tmp)
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (cmd, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu ({' '.join(cmd)}):\n"
                          f"{stdout}\n{stderr}")
            continue
        out[name].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out[name])   # atomic: concurrent builders both succeed
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its entry point typed."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    load_wall_s[name] = time.perf_counter() - t0
    return lib

