"""Wrapper of the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/ssd_scan.py::ssd_scan``: Mamba2's chunked scan from a
zero state, the intra-chunk dual form, the readout of the carried state and
the state update. Every mamba layer's prefill launches it once. The kernel
runs the chunked algorithm in three passes that each spread over the card
(every chunk's own state; the states passed from chunk to chunk, in
order; every chunk's output), counted as one launch; the wrapper
allocates their float32 scratch, the chunks' cumulative log-decay and
states. In bfloat16 at the configs' shapes every product runs on the
tensor cores, a float32 operand as three bfloat16 parts that keep its
float32 accuracy; other shapes and float32 run the products with a
float32 operand on the CUDA cores (:func:`design`). The kernel takes CUDA
tensors only;
:func:`repro_torch.kernels.ops.ssd_scan` routes CPU tensors to the plain
version (:func:`repro_torch.kernels.ref.ssd_scan_ref`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: dtype code of the C entry point (x, b, c and y)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims and state widths the kernel is built for
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
#: the bfloat16 shapes that take the tensor-core body
TC_HEAD_DIMS = (64,)
TC_STATE_DIMS = (32, 64, 128)
#: the grid's limit on the batch, the heads and the chunks
MAX_GRID = 65535


def design(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """Which body runs for ``dtype`` at head dim ``P``, state width ``N``
    and chunk ``chunk``; both run the three-pass chunked algorithm.
    ``"tensor-cores"`` (bfloat16 at P in :data:`TC_HEAD_DIMS` and N in
    :data:`TC_STATE_DIMS`, the configs' shapes): every product on
    ``mma.sync``, each float32 operand as three bfloat16 parts.
    ``"cuda-cores"`` (every other shape, and float32): the products with a
    float32 operand on the CUDA cores in float32, the scores ``C·Bᵀ`` on
    ``mma.sync`` in bfloat16. Any chunk that divides S; raises for a shape
    the kernel does not take."""
    if P not in HEAD_DIMS or N not in STATE_DIMS or chunk < 1:
        raise ValueError(f"the ssd_scan kernel takes head dims {HEAD_DIMS} "
                         f"and state widths {STATE_DIMS}, got P = {P}, "
                         f"N = {N}")
    if dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and P in TC_HEAD_DIMS and N in TC_STATE_DIMS:
        return "tensor-cores"
    return "cuda-cores"


def _check(x, dt, a_log, b, c, chunk: int):
    """Validate the operands; returns ``(B, S, H, P, G, N)``."""
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (B, S, H, P) tensor, got "
                         f"shape {tuple(x.shape)}")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H):
        raise ValueError(f"dt must have shape ({B}, {S}, {H}), got "
                         f"{tuple(dt.shape)}")
    if tuple(a_log.shape) != (H,):
        raise ValueError(f"a_log must have shape ({H},), got "
                         f"{tuple(a_log.shape)}")
    if b.dim() != 4 or tuple(b.shape[:2]) != (B, S) or b.shape[2] < 1:
        raise ValueError(f"b must be (B={B}, S={S}, G, N), got shape "
                         f"{tuple(b.shape)}")
    if tuple(c.shape) != tuple(b.shape):
        raise ValueError(f"c must have b's shape {tuple(b.shape)}, got "
                         f"{tuple(c.shape)}")
    G, N = b.shape[2], b.shape[3]
    if H % G:
        raise ValueError(f"H = {H} heads do not split over G = {G} groups")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"the ssd_scan kernel takes head dims {HEAD_DIMS} "
                         f"and state widths {STATE_DIMS}, got P = {P}, "
                         f"N = {N}")
    if not 1 <= chunk or S % chunk:
        raise ValueError(f"the chunk {chunk} must divide the sequence "
                         f"length {S}")
    if max(B, H, S // chunk) > MAX_GRID:
        raise ValueError(f"the ssd_scan kernel takes at most {MAX_GRID} "
                         f"batch rows, heads and chunks, got B = {B}, "
                         f"H = {H}, {S // chunk} chunks")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, dtype in (("x", x, x.dtype), ("dt", dt, torch.float32),
                           ("a_log", a_log, torch.float32),
                           ("b", b, x.dtype), ("c", c, x.dtype)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the ssd_scan kernel "
                             f"takes tensors on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, H, P, G, N


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P) float32 or bfloat16; dt: (B, S, H) float32; a_log:
    (H,) float32; b, c: (B, S, G, N) in x's dtype; all contiguous on one
    CUDA device; ``chunk`` divides S.

    Returns ``(y (B, S, H, P) in x's dtype, final_state (B, H, P, N)
    float32)``, launched on the current stream without a sync.
    """
    B, S, H, P, G, N = _check(x, dt, a_log, b, c, chunk)
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # the passes' scratch: each chunk's cumulative log-decay, and each
    # chunk's own state (P x N, in the order its body keeps it),
    # overwritten by the state that enters the chunk
    cum = torch.empty((B, H, S), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, S // chunk, P * N), dtype=torch.float32,
                         device=x.device)
    fn = build.load("ssd_scan").ssd_scan_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(x), ptr(dt), ptr(a_log), ptr(b), ptr(c), ptr(y),
                ptr(final), ptr(cum), ptr(states), B, S, H, G, P, N, chunk,
                _DTYPES[x.dtype], ctypes.c_void_p(stream))
    if rc == -2:
        raise ValueError(f"a chunk of {chunk} does not fit the ssd_scan "
                         f"kernel's shared memory at N = {N}, P = {P}")
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, final


#: Kernel launches since the process started (or the caller last reset it).
ssd_scan.launches = 0  # type: ignore[attr-defined]
