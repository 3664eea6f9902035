"""Wrapper of the grouped-matmul CUDA kernel (``csrc/grouped_matmul.cu``),
and the sorting of MoE assignments by expert that feeds it.

Replaces the reference's Pallas kernel
``src/repro/kernels/grouped_matmul.py::grouped_matmul``: ``out[i] = lhs[i]
@ rhs[tile_expert[i // blk_m]]`` over tokens sorted by expert, each
expert's group padded to a multiple of ``blk_m`` rows, with float32 sums
and the output in lhs's dtype. Every MoE layer's expert FFN launches it
three times (gate, up and down) on the kernel route of
:func:`repro_torch.models.moe.moe_apply`. In bfloat16 at the M-tiles that
prompts take (``blk_m`` 64 and 128) a persistent, warp-specialised body
runs ``wgmma`` fed by TMA loads; at the decode tiles (16 and 32) a body on
``mma.sync``; float32 runs on the CUDA cores (:func:`design`). The kernel
takes CUDA tensors only; :func:`repro_torch.kernels.ops.grouped_matmul` routes CPU tensors to
the plain version (:func:`repro_torch.kernels.ref.grouped_matmul_ref`).

:func:`sort_assignments` builds the sorted buffer: sized statically for
the worst case, ``round_up(A + E (blk_m - 1), blk_m)`` rows for A
assignments, so a layer never waits on the host (the reference's helper
``sort_tokens_for_experts`` sizes it to the data, reading the group sizes
on the host); tiles past the last group carry expert id -1 (zeros, no
weights read), and assignments that capacity dropped get no row.
:func:`sort_tokens_for_experts` is the reference's helper on top of it,
cut to the data's size on the host.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the M-tiles the kernel is built for
BLOCK_MS = (16, 32, 64, 128)
#: the bfloat16 M-tiles that take the wgmma/TMA body
WGMMA_BLOCK_MS = (64, 128)


def design(blk_m: int, dtype: torch.dtype) -> str:
    """Which of the kernel's bodies runs for M-tiles of ``blk_m`` rows in
    ``dtype``: ``"wgmma-tma"`` (bfloat16 at ``blk_m`` in
    :data:`WGMMA_BLOCK_MS`), ``"mma.sync"`` (bfloat16 otherwise) or
    ``"cuda-cores"`` (float32)."""
    if dtype == torch.float32:
        return "cuda-cores"
    return "wgmma-tma" if blk_m in WGMMA_BLOCK_MS else "mma.sync"


def _check(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor,
           blk_m: int) -> Tuple[int, int, int]:
    """Validate the operands; returns ``(M, K, N)``."""
    if blk_m not in BLOCK_MS:
        raise ValueError(f"the grouped_matmul kernel takes blk_m in "
                         f"{BLOCK_MS}, got {blk_m}")
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"lhs must be (M, K) and rhs (E, K, N) with one K, "
                         f"got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, K = lhs.shape
    N = rhs.shape[2]
    if M < blk_m or M % blk_m or K < 16 or K % 16 or N < 16 or N % 16:
        raise ValueError(f"the grouped_matmul kernel takes M a multiple of "
                         f"blk_m = {blk_m} and K, N multiples of 16, got "
                         f"M = {M}, K = {K}, N = {N}")
    if tile_expert.dim() != 1 or tile_expert.numel() != M // blk_m:
        raise ValueError(f"tile_expert must be ({M // blk_m},), got shape "
                         f"{tuple(tile_expert.shape)}")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"tile_expert must be int32, got {tile_expert.dtype}")
    if lhs.dtype not in _DTYPES:
        raise TypeError(f"lhs must be float32 or bfloat16, got {lhs.dtype}")
    for name, t in (("lhs", lhs), ("rhs", rhs), ("tile_expert", tile_expert)):
        if t.device != lhs.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the grouped_matmul "
                             f"kernel takes tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if rhs.dtype != lhs.dtype:
        raise TypeError(f"rhs must be {lhs.dtype} like lhs, got {rhs.dtype}")
    return M, K, N


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor,
            blk_m: int) -> torch.Tensor:
    M, K, N = _check(lhs, rhs, tile_expert, blk_m)
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    fn = build.load("grouped_matmul").grouped_matmul_launch
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(lhs), ptr(rhs), ptr(tile_expert), ptr(out), M, K, N,
                rhs.shape[0], blk_m, _DTYPES[lhs.dtype],
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    grouped_matmul.launches += 1
    return out


class _Forward(torch.autograd.Function):
    """The kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, blk_m):
        return _launch(lhs, rhs, tile_expert, blk_m)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "grouped_matmul (kernel K6) has no backward kernel, as the "
            "reference's Pallas kernel has none; use attention_impl="
            "'reference' (the capacity buffer's einsums) to differentiate "
            "an MoE layer")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   tile_expert: torch.Tensor, *, blk_m: int) -> torch.Tensor:
    """lhs: (M, K) rows sorted by expert, every ``blk_m`` rows one expert's;
    rhs: (E, K, N); tile_expert: (M / blk_m,) int32 expert ids below E
    (negative: a tile of zeros); one dtype (float32 or bfloat16),
    contiguous, on one CUDA device; K and N multiples of 16, blk_m one of
    :data:`BLOCK_MS`. Expert ids are not range-checked on the device.

    Returns ``out (M, N)`` in lhs's dtype, launched on the current stream
    without a sync. Where autograd records the call (an input requires
    grad), the output's backward raises ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _Forward.apply(lhs, rhs, tile_expert, blk_m)
    return _launch(lhs, rhs, tile_expert, blk_m)


#: Kernel launches since the process started (or the caller last reset it).
grouped_matmul.launches = 0  # type: ignore[attr-defined]


class ExpertSort(NamedTuple):
    """Where each assignment's row lies in a statically sized buffer
    sorted by expert (:func:`sort_assignments`)."""
    #: (A,) int64: each kept assignment's row, ``rows`` for a dropped one
    dest: torch.Tensor
    #: (rows / blk_m,) int32: each tile's expert, -1 past the last group
    tile_expert: torch.Tensor
    #: the buffer's rows, ``round_up(A + E (blk_m - 1), blk_m)``
    rows: int


def sort_assignments(expert_ids: torch.Tensor, keep: torch.Tensor,
                     n_experts: int, blk_m: int) -> ExpertSort:
    """Sort A assignments (``expert_ids`` (A,), ``keep`` (A,) bool) by
    expert, stably, into a buffer of a size fixed by A, E and ``blk_m``
    alone, each expert's kept assignments padded to a multiple of
    ``blk_m`` rows: every operation stays on the tensors' device, with no
    host sync. Within a group the assignments keep their order, as the
    reference's helper keeps it."""
    a = expert_ids.numel()
    dev = expert_ids.device
    rows = -(-(a + n_experts * (blk_m - 1)) // blk_m) * blk_m
    key = torch.where(keep, expert_ids.long(), n_experts)
    sorted_key, order = torch.sort(key, stable=True)
    counts = torch.zeros(n_experts + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    padded = (counts + blk_m - 1) // blk_m * blk_m
    padded[n_experts] = 0                     # dropped: no rows
    ends = torch.cumsum(padded, 0)
    offs = ends - padded
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(a, device=dev) - starts[sorted_key]
    dest_sorted = torch.where(sorted_key < n_experts,
                              offs[sorted_key] + rank, rows)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    tile_start = torch.arange(0, rows, blk_m, device=dev)
    tile = torch.searchsorted(ends[:n_experts].contiguous(), tile_start,
                              right=True)
    tile_expert = torch.where(tile < n_experts, tile, -1).to(torch.int32)
    return ExpertSort(dest, tile_expert, rows)


def sort_tokens_for_experts(x, expert_ids, n_experts: int, blk_m: int = 128):
    """The reference's host helper: the rows of ``x`` (N, K) sorted by
    ``expert_ids`` (N,), stably, each expert's group padded with zero rows
    to a multiple of ``blk_m``. Returns ``(lhs (M, K), tile_expert
    (M / blk_m,) int32, inv (M,) int64: each row's source row or -1,
    valid (M,) bool)``, M the data's padded size (``blk_m`` when there is
    no row), as the reference's does. It sorts with
    :func:`sort_assignments` and reads the group sizes on the host to cut
    its buffer to M rows; the MoE path keeps the static buffer."""
    x = torch.as_tensor(x)
    ids = torch.as_tensor(expert_ids, device=x.device).long()
    s = sort_assignments(ids, torch.ones_like(ids, dtype=torch.bool),
                         n_experts, blk_m)
    sizes = torch.bincount(ids, minlength=n_experts)
    total = int(((sizes + blk_m - 1) // blk_m * blk_m).sum()) or blk_m
    rows = max(s.rows, total)
    lhs = x.new_zeros((rows, x.shape[1]))
    inv = torch.full((rows,), -1, dtype=torch.int64, device=x.device)
    lhs[s.dest] = x
    inv[s.dest] = torch.arange(ids.numel(), device=x.device)
    tile_expert = torch.zeros(rows // blk_m, dtype=torch.int32,
                              device=x.device)
    tile_expert[:s.tile_expert.numel()] = s.tile_expert
    # within the data's rows a tile is -1 only when no row came (the
    # reference's zeros then)
    tile_expert = tile_expert[:total // blk_m].clamp_min(0)
    return lhs[:total], tile_expert, inv[:total], inv[:total] >= 0
