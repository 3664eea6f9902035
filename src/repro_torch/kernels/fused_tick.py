"""Wrapper of the fused-tick CUDA kernel (``csrc/fused_tick.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/fused_tick.py::fused_tick``: one fused-engine tick per
scenario row — consumer-lag update, AR(1)+bias detector observe on
``log1p(lag)``, rank-1 RLS update of ``w`` and ``P``. The kernel takes
CUDA tensors only; :func:`repro_torch.kernels.ops.fused_tick` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build


def _check(lag, lag_add, rates, cap, down_pre, w, P, y_prev) -> int:
    """Validate the operands; returns the row count B."""
    if lag.dim() != 1 or lag.shape[0] < 1:
        raise ValueError(f"lag must be a non-empty (B,) tensor, got shape "
                         f"{tuple(lag.shape)}")
    B = lag.shape[0]
    named = {"lag": lag, "lag_add": lag_add, "rates": rates, "cap": cap,
             "down_pre": down_pre, "w": w, "P": P, "y_prev": y_prev}
    shapes = {"w": (B, 2), "P": (B, 2, 2)}
    for name, t in named.items():
        if t.device != lag.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the fused_tick kernel "
                             f"takes tensors on one CUDA device")
        want_dtype = torch.bool if name == "down_pre" else torch.float64
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        want = shapes.get(name, (B,))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B


def fused_tick(lag: torch.Tensor, lag_add: torch.Tensor, rates: torch.Tensor,
               cap: torch.Tensor, down_pre: torch.Tensor, w: torch.Tensor,
               P: torch.Tensor, y_prev: torch.Tensor, lam: float,
               thresh: float, dt: float):
    """lag/lag_add/rates/cap/y_prev: (B,) float64; down_pre: (B,) bool;
    w: (B, 2); P: (B, 2, 2) float64, all contiguous on one CUDA device.

    Returns ``(new_lag (B,), w' (B, 2), P' (B, 2, 2), err (B,),
    flag (B,) bool)``, launched on the current stream without a sync.
    """
    B = _check(lag, lag_add, rates, cap, down_pre, w, P, y_prev)
    new_lag = torch.empty_like(lag)
    w2 = torch.empty_like(w)
    P2 = torch.empty_like(P)
    err = torch.empty_like(lag)
    flag = torch.empty_like(down_pre)
    fn = build.load("fused_tick").fused_tick_launch
    with torch.cuda.device(lag.device):
        stream = torch.cuda.current_stream(lag.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(lag), ptr(lag_add), ptr(rates), ptr(cap), ptr(down_pre),
                ptr(w), ptr(P), ptr(y_prev), float(lam), float(thresh),
                float(dt), B, ptr(new_lag), ptr(w2), ptr(P2), ptr(err),
                ptr(flag), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_tick kernel launch failed: CUDA error {rc}")
    fused_tick.launches += 1
    return new_lag, w2, P2, err, flag


#: Kernel launches since the process started (or the caller last reset it).
fused_tick.launches = 0  # type: ignore[attr-defined]
