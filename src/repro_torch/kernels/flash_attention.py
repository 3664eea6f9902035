"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/flash_attention.py::flash_attention``: attention without
a cache, causal (top-left aligned) or not, with an online softmax in
float32 and grouped-query attention by index (query head ``h`` reads KV
head ``h // G``). Every attention layer of ``encode`` and ``train_loss``
launches it once. It reads q, k and v in place, in the layout the model
keeps them, ``(B, S, H, D)``. The kernel takes CUDA tensors only;
:func:`repro_torch.kernels.ops.flash_attention` routes CPU tensors to the
plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`).

In bfloat16 both products run on the tensor cores, and the softmax weights
P are rounded to bfloat16 before P·V (the plain version rounds them too):
at the head dims every configuration but gemma's uses (64, 80, 128) on
``wgmma`` with TMA loads, at the others on ``mma.sync`` (:func:`design`).
float32 runs on the CUDA cores in full float32, with no TF32 and no
rounding of P. The kernel has no backward: where autograd would need one,
the output's backward raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim (the kernel pads D inside to 16, 32, 64, 80, 128 or
#: 256) and the grid's limit on the batch and on the query heads
MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535
#: bfloat16 head dims that take the wgmma/TMA kernel
WGMMA_HEAD_DIMS = (64, 80, 128)
#: the widths the mma.sync and CUDA-core kernels pad a head dim to
PADDED_HEAD_DIMS = (16, 32, 64, 80, 128, 256)


def design(D: int, dtype: torch.dtype) -> str:
    """Which of the kernel's bodies runs for head dim ``D`` in ``dtype``:
    ``"wgmma-tma"`` (bfloat16 at D in :data:`WGMMA_HEAD_DIMS`),
    ``"mma.sync"`` (bfloat16 otherwise) or ``"cuda-cores"`` (float32)."""
    if dtype == torch.float32:
        return "cuda-cores"
    return "wgmma-tma" if D in WGMMA_HEAD_DIMS else "mma.sync"


def padded_head_dim(D: int) -> int:
    """The width the mma.sync and CUDA-core bodies pad ``D`` to."""
    return next(p for p in PADDED_HEAD_DIMS if D <= p)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> Tuple[int, int, int, int, int, int]:
    """Validate the operands; returns ``(B, Sq, Skv, Hq, Hkv, D)``."""
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q must be a non-empty (B, Sq, Hq, D) tensor, got "
                         f"shape {tuple(q.shape)}")
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 \
            or k.shape[2] < 1:
        raise ValueError(f"k must be (B={B}, Skv, Hkv, D={D}), got shape "
                         f"{tuple(k.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must have k's shape {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq = {Hq} query heads do not group over "
                         f"Hkv = {Hkv} KV heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if B > MAX_GRID_YZ or Hq > MAX_GRID_YZ:
        raise ValueError(f"the flash_attention kernel takes at most "
                         f"{MAX_GRID_YZ} batch rows and query heads, got "
                         f"B = {B}, Hq = {Hq}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the flash_attention "
                             f"kernel takes tensors on one CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, Sq, Skv, Hq, Hkv, D


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    B, Sq, Skv, Hq, Hkv, D = _check(q, k, v)
    out = torch.empty_like(q)
    fn = build.load("flash_attention").flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Skv, Hq, Hkv, D,
                int(bool(causal)), _DTYPES[q.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


class _Forward(torch.autograd.Function):
    """The kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention (kernel K4) has no backward kernel, as the "
            "reference's Pallas kernel has none; gradients come with the "
            "training slice (ROADMAP.md, 'Next': training). Use "
            "attention_impl='reference' to differentiate")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq a multiple of Hkv,
    one dtype (float32 or bfloat16), contiguous, on one CUDA device; any
    Sq, Skv >= 1 and D <= 256. ``causal``: query row i sees key columns
    j <= i.

    Returns ``out (B, Sq, Hq, D)`` in q's dtype, launched on the current
    stream without a sync. Where autograd records the call (an input
    requires grad), the output's backward raises ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Forward.apply(q, k, v, causal)
    return _launch(q, k, v, causal)


#: Kernel launches since the process started (or the caller last reset it).
flash_attention.launches = 0  # type: ignore[attr-defined]
