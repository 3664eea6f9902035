"""Wrapper of the batched RLS kernel (``csrc/rls_update.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/rls_update.py::rls_rank1_update``: one rank-1
recursive-least-squares step per row, ``g = Pφ / (λ + φᵀPφ)`` and
``P' = (P − g(Pφ)ᵀ) / λ``. The forecast bank's ARIMA family calls it on
every tick of every chunk it replays. The kernel takes CUDA tensors only;
:func:`repro_torch.kernels.ops.rls_rank1_update` routes CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float64: 0, torch.float32: 1}
#: largest order the kernel takes (``kMaxK`` in the source)
MAX_K = 64


def _check(P: torch.Tensor, phi: torch.Tensor, lam: torch.Tensor) -> tuple:
    """Validate the operands; returns ``(B, k)``."""
    if P.dim() != 3 or P.shape[1] != P.shape[2] or P.shape[0] < 1:
        raise ValueError(f"P must be a non-empty (B, k, k) tensor, got shape "
                         f"{tuple(P.shape)}")
    B, k = P.shape[0], P.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the rls_update kernel takes 1 <= k <= {MAX_K}, "
                         f"got k = {k}")
    if P.dtype not in _DTYPES:
        raise TypeError(f"P must be float64 or float32, got {P.dtype}")
    for name, t, want in (("P", P, (B, k, k)), ("phi", phi, (B, k)),
                          ("lam", lam, (B,))):
        if t.device != P.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the rls_update kernel "
                             f"takes tensors on one CUDA device")
        if t.dtype != P.dtype:
            raise TypeError(f"{name} must be {P.dtype} like P, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, k


def rls_rank1_update(P: torch.Tensor, phi: torch.Tensor, lam: torch.Tensor):
    """P: (B, k, k); phi: (B, k); lam: (B,); one dtype (float64 or float32),
    contiguous, on one CUDA device.

    Returns ``(gain (B, k), P' (B, k, k))``, launched on the current stream
    without a sync.
    """
    B, k = _check(P, phi, lam)
    gain = torch.empty_like(phi)
    P_out = torch.empty_like(P)
    fn = build.load("rls_update").rls_update_launch
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(P), ptr(phi), ptr(lam), B, k, _DTYPES[P.dtype],
                ptr(gain), ptr(P_out), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rls_update kernel launch failed: CUDA error {rc}")
    rls_rank1_update.launches += 1
    return gain, P_out


#: Kernel launches since the process started (or the caller last reset it).
rls_rank1_update.launches = 0  # type: ignore[attr-defined]
