"""Wrappers of the forecast bank's ARIMA kernels (``csrc/rls_update.cu``).

Replace the reference's Pallas kernel
``src/repro/kernels/rls_update.py::rls_rank1_update`` and the ``lax.scan``
the forecast bank runs it in:

* :func:`rls_rank1_update`: one rank-1 recursive-least-squares step per
  row, ``g = Pφ / (λ + φᵀPφ)`` and ``P' = (P − g(Pφ)ᵀ) / λ``; the direct
  counterpart of the Pallas kernel.
* :func:`arima_chunk`: a whole flush of the ARIMA family, every queued
  tick of every stream in one launch (the bank's path).

The kernels take CUDA tensors only; :mod:`repro_torch.kernels.ops` routes
CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float64: 0, torch.float32: 1}
#: largest order the kernels take (``kMaxK`` in the source)
MAX_K = 64
#: largest differencing depth ``d_max`` arima_chunk takes (``kMaxD``)
MAX_D = 32


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


def arima_chunk(w: torch.Tensor, P: torch.Tensor, lags: torch.Tensor,
                tails: torch.Tensor, count: torch.Tensor, last: torch.Tensor,
                p: torch.Tensor, d: torch.Tensor, lam: torch.Tensor,
                ridge: torch.Tensor, cap: torch.Tensor, vals: torch.Tensor):
    """T ticks of the ARIMA family's masked online step for B streams.

    State ``w (B, k)``, ``P (B, k, k)``, ``lags (B, k - 1)``, ``tails
    (B, d_max)``, ``count (B,)`` int64 and ``last (B,)`` is updated in
    place; ``p``, ``d`` (int64), ``lam``, ``ridge`` and the trace cap
    ``cap`` are ``(B,)``; ``vals (T, B)`` holds the ticks, NaN where a
    stream has none. float64 but the int64 ones, contiguous, on one CUDA
    device; ``1 <= k <= 64``, ``d_max <= 32``.

    Returns ``(resid (T, B) float64, do_rls (T, B) bool)``, launched on the
    current stream without a sync.
    """
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be a non-empty (B, k) tensor, got shape "
                         f"{tuple(w.shape)}")
    B, k = w.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the arima_chunk kernel takes 1 <= k <= {MAX_K}, "
                         f"got k = {k}")
    if tails.dim() != 2 or tails.shape[1] > MAX_D:
        raise ValueError(f"tails must be (B, d_max) with d_max <= {MAX_D}, "
                         f"got shape {tuple(tails.shape)}")
    if vals.dim() != 2 or vals.shape[0] < 1:
        raise ValueError(f"vals must be a (T, B) tensor with T >= 1, got "
                         f"shape {tuple(vals.shape)}")
    T, d_max = vals.shape[0], tails.shape[1]
    f64, i64 = torch.float64, torch.int64
    for name, t, want, dtype in (
            ("w", w, (B, k), f64), ("P", P, (B, k, k), f64),
            ("lags", lags, (B, k - 1), f64), ("tails", tails, (B, d_max), f64),
            ("count", count, (B,), i64), ("last", last, (B,), f64),
            ("p", p, (B,), i64), ("d", d, (B,), i64), ("lam", lam, (B,), f64),
            ("ridge", ridge, (B,), f64), ("cap", cap, (B,), f64),
            ("vals", vals, (T, B), f64)):
        if t.device != w.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the arima_chunk "
                             f"kernel takes tensors on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    resid = torch.empty_like(vals)
    do_rls = torch.empty((T, B), dtype=torch.bool, device=w.device)
    fn = build.load("rls_update").arima_chunk_launch
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(*(ptr(t) for t in (w, P, lags, tails, count, last, p, d,
                                   lam, ridge, cap, vals)),
                T, B, k, d_max, ptr(resid), ptr(do_rls),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"arima_chunk kernel launch failed: CUDA error "
                           f"{rc}")
    arima_chunk.launches += 1
    return resid, do_rls


#: Kernel launches since the process started (or the caller last reset it).
arima_chunk.launches = 0  # type: ignore[attr-defined]
