"""Wrapper of the fused residual-add and RMSNorm CUDA kernel
(``csrc/rmsnorm.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/rmsnorm.py::fused_rmsnorm``: ``s = x + res`` in
float32, ``y = s · rsqrt(mean(s²) + eps) · (1 + scale)``, both returned in
x's dtype. No model calls it, in the reference or here: the models'
``rmsnorm`` rounds in the input dtype after each operation
(``layers.rmsnorm``), and a route through this kernel, which rounds once,
would change their bf16 results. The kernel takes CUDA tensors only;
:func:`repro_torch.kernels.ops.fused_rmsnorm` routes CPU tensors to the
plain version (:func:`repro_torch.kernels.ref.fused_rmsnorm_ref`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (..., d) tensor, got shape "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if tuple(res.shape) != tuple(x.shape):
        raise ValueError(f"res must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(res.shape)}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("res", res), ("scale", scale)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the fused_rmsnorm "
                             f"kernel takes tensors on one CUDA device")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y, s = torch.empty_like(x), torch.empty_like(x)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, res, scale, y, s))
    fn = build.load("rmsnorm").fused_rmsnorm_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(x), ptr(res), ptr(scale), ptr(y), ptr(s), x.numel() // d,
                d, float(eps), _DTYPES[x.dtype], int(vec),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_rmsnorm kernel launch failed: CUDA error "
                           f"{rc}")
    fused_rmsnorm.launches += 1
    return y, s


class _Forward(torch.autograd.Function):
    """The kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, x, res, scale, eps):
        return _launch(x, res, scale, eps)

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        raise NotImplementedError(
            "fused_rmsnorm (kernel K7) has no backward kernel, as the "
            "reference's Pallas kernel has none")


def fused_rmsnorm(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                  *, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, res: (..., d); scale: (d,); one dtype (float32 or bfloat16),
    contiguous, on one CUDA device; any d >= 1 and any number of rows.

    Returns ``(y, s)`` in x's shape and dtype, launched on the current
    stream without a sync. Where autograd records the call (an input
    requires grad), the outputs' backward raises ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, res, scale)):
        return _Forward.apply(x, res, scale, eps)
    return _launch(x, res, scale, eps)


#: Kernel launches since the process started (or the caller last reset it).
fused_rmsnorm.launches = 0  # type: ignore[attr-defined]
