"""Dispatch of the port's kernels by where the tensors lie.

A CPU tensor goes to the kernel's plain version (:mod:`.ref`), a CUDA
tensor to the hand-written kernel, and any other device raises. A CUDA
tensor never falls back to the plain version: if the kernel fails to build
or launch, the call raises.
"""
from __future__ import annotations

import torch

from . import decode_attention as _decode_attention
from . import flash_attention as _flash_attention
from . import fused_tick as _fused_tick
from . import gp_fit as _gp_fit
from . import grouped_matmul as _grouped_matmul
from . import rls_update as _rls_update
from . import rmsnorm as _rmsnorm
from . import ssd_scan as _ssd_scan
from .ref import (arima_chunk_ref, decode_attention_ref,
                  flash_attention_ref, fused_interval_ref, fused_rmsnorm_ref,
                  fused_tick_ref, gp_lbfgs_ref, grouped_matmul_ref,
                  rls_rank1_update_ref, ssd_scan_ref)


def rls_rank1_update(P: torch.Tensor, phi: torch.Tensor, lam: torch.Tensor):
    """One batched rank-1 RLS step; see
    :func:`repro_torch.kernels.ref.rls_rank1_update_ref` for the function
    and the shapes."""
    if P.device.type == "cpu":
        return rls_rank1_update_ref(P, phi, lam)
    if P.device.type == "cuda":
        return _rls_update.rls_rank1_update(P, phi, lam)
    raise ValueError(f"rls_rank1_update takes CPU or CUDA tensors, got a "
                     f"tensor on {P.device}")


def fused_tick(lag: torch.Tensor, lag_add: torch.Tensor, rates: torch.Tensor,
               cap: torch.Tensor, down_pre: torch.Tensor, w: torch.Tensor,
               P: torch.Tensor, y_prev: torch.Tensor, lam: float,
               thresh: float, dt: float):
    """One fused-engine tick; see :func:`repro_torch.kernels.ref.fused_tick_ref`
    for the function and the shapes."""
    args = (lag, lag_add, rates, cap, down_pre, w, P, y_prev, lam, thresh, dt)
    if lag.device.type == "cpu":
        return fused_tick_ref(*args)
    if lag.device.type == "cuda":
        return _fused_tick.fused_tick(*args)
    raise ValueError(f"fused_tick takes CPU or CUDA tensors, got a tensor "
                     f"on {lag.device}")


def arima_chunk(w: torch.Tensor, P: torch.Tensor, lags: torch.Tensor,
                tails: torch.Tensor, count: torch.Tensor, last: torch.Tensor,
                p: torch.Tensor, d: torch.Tensor, lam: torch.Tensor,
                ridge: torch.Tensor, cap: torch.Tensor, vals: torch.Tensor):
    """A chunk of the forecast bank's ARIMA ticks, state updated in place;
    see :func:`repro_torch.kernels.ref.arima_chunk_ref` for the function
    and the shapes."""
    args = (w, P, lags, tails, count, last, p, d, lam, ridge, cap, vals)
    if w.device.type == "cpu":
        return arima_chunk_ref(*args)
    if w.device.type == "cuda":
        return _rls_update.arima_chunk(*args)
    raise ValueError(f"arima_chunk takes CPU or CUDA tensors, got a tensor "
                     f"on {w.device}")


def fused_interval(model, lag: torch.Tensor, det_w: torch.Tensor,
                   det_p: torch.Tensor, det_y: torch.Tensor,
                   det_trig: torch.Tensor, rates: torch.Tensor,
                   lag_add: torch.Tensor, down_pre: torch.Tensor,
                   down_post: torch.Tensor, z1: torch.Tensor,
                   z2: torch.Tensor, workers: torch.Tensor,
                   cpu_cores: torch.Tensor, memory_mb: torch.Tensor,
                   task_slots: torch.Tensor, cap_base: torch.Tensor,
                   det_lam: float, det_thresh: float, dt: float):
    """One fused-engine decision interval, state updated in place; see
    :func:`repro_torch.kernels.ref.fused_interval_ref` for the function and
    the shapes."""
    args = (model, lag, det_w, det_p, det_y, det_trig, rates, lag_add,
            down_pre, down_post, z1, z2, workers, cpu_cores, memory_mb,
            task_slots, cap_base, det_lam, det_thresh, dt)
    if lag.device.type == "cpu":
        return fused_interval_ref(*args)
    if lag.device.type == "cuda":
        return _fused_tick.fused_interval(*args)
    raise ValueError(f"fused_interval takes CPU or CUDA tensors, got a "
                     f"tensor on {lag.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths):
    """One-token grouped-query attention over each row's first
    ``lengths[b]`` cache entries; see
    :func:`repro_torch.kernels.ref.decode_attention_ref` for the function
    and the shapes."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type == "cuda":
        return _decode_attention.decode_attention(q, k, v, lengths)
    raise ValueError(f"decode_attention takes CPU or CUDA tensors, got a "
                     f"tensor on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool):
    """Grouped-query attention without a cache, causal or not; see
    :func:`repro_torch.kernels.ref.flash_attention_ref` for the function
    and the shapes."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return _flash_attention.flash_attention(q, k, v, causal=causal)
    raise ValueError(f"flash_attention takes CPU or CUDA tensors, got a "
                     f"tensor on {q.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """Mamba2's chunked SSD scan from a zero state; see
    :func:`repro_torch.kernels.ref.ssd_scan_ref` for the function and the
    shapes."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a_log, b, c, chunk)
    if x.device.type == "cuda":
        return _ssd_scan.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
    raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got a tensor on "
                     f"{x.device}")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   tile_expert: torch.Tensor, *, blk_m: int):
    """Expert-grouped matmul over rows sorted by expert; see
    :func:`repro_torch.kernels.ref.grouped_matmul_ref` for the function and
    the shapes."""
    if lhs.device.type == "cpu":
        return grouped_matmul_ref(lhs, rhs, tile_expert, blk_m)
    if lhs.device.type == "cuda":
        return _grouped_matmul.grouped_matmul(lhs, rhs, tile_expert,
                                              blk_m=blk_m)
    raise ValueError(f"grouped_matmul takes CPU or CUDA tensors, got a "
                     f"tensor on {lhs.device}")


def fused_rmsnorm(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                  *, eps: float = 1e-6):
    """Fused residual add and RMSNorm; see
    :func:`repro_torch.kernels.ref.fused_rmsnorm_ref` for the function and
    the shapes."""
    if x.device.type == "cpu":
        return fused_rmsnorm_ref(x, res, scale, eps)
    if x.device.type == "cuda":
        return _rmsnorm.fused_rmsnorm(x, res, scale, eps=eps)
    raise ValueError(f"fused_rmsnorm takes CPU or CUDA tensors, got a "
                     f"tensor on {x.device}")


def gp_lbfgs(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             t0: torch.Tensor, *, restarts: int, max_iter: int):
    """The GP bank's batched fit, a row per (member, restart); see
    :func:`repro_torch.kernels.ref.gp_lbfgs_ref` for the function and the
    shapes. Returns the fitted thetas and each row's iteration count."""
    if x.device.type == "cpu":
        return gp_lbfgs_ref(x, y, mask, t0, restarts, max_iter)
    if x.device.type == "cuda":
        theta, counts, _ = _gp_fit.gp_lbfgs(x, y, mask, t0,
                                            restarts=restarts,
                                            max_iter=max_iter)
        return theta, counts
    raise ValueError(f"gp_lbfgs takes CPU or CUDA tensors, got a tensor on "
                     f"{x.device}")
