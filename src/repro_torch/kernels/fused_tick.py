"""Wrappers of the fused-tick CUDA kernels (``csrc/fused_tick.cu``).

Replace the reference's Pallas kernel
``src/repro/kernels/fused_tick.py::fused_tick`` and the ``lax.scan`` the
fused engine runs it in:

* :func:`fused_tick`: one fused-engine tick per scenario row — consumer-lag
  update, AR(1)+bias detector observe on ``log1p(lag)``, rank-1 RLS update
  of ``w`` and ``P``; the direct counterpart of the Pallas kernel.
* :func:`fused_interval`: a whole decision interval of K ticks in one
  launch, each tick also computing
  :func:`~repro_torch.dsp.simulator.step_batch_arrays`' metrics; the fused
  engine's path.

The kernels take CUDA tensors only; :mod:`repro_torch.kernels.ops` routes
CPU tensors to the plain versions.
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


def _check_interval(lag, det_w, det_p, det_y, det_trig, planes, configs
                    ) -> tuple:
    """Validate the interval's operands; returns ``(K, S)``."""
    if lag.dim() != 1 or lag.shape[0] < 1:
        raise ValueError(f"lag must be a non-empty (S,) tensor, got shape "
                         f"{tuple(lag.shape)}")
    S = lag.shape[0]
    rates = planes["rates"]
    if rates.dim() != 2 or rates.shape[0] < 1:
        raise ValueError(f"rates must be a (K, S) tensor with K >= 1, got "
                         f"shape {tuple(rates.shape)}")
    K = rates.shape[0]
    operands = [("lag", lag, (S,), torch.float64),
                ("det_w", det_w, (S, 2), torch.float64),
                ("det_p", det_p, (S, 2, 2), torch.float64),
                ("det_y", det_y, (S,), torch.float64),
                ("det_trig", det_trig, (S,), torch.int64)]
    operands += [(name, t, (K, S),
                  torch.bool if name.startswith("down") else torch.float64)
                 for name, t in planes.items()]
    operands += [(name, t, (S,), torch.float64)
                 for name, t in configs.items()]
    for name, t, want, dtype in operands:
        if t.device != lag.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the fused_interval "
                             f"kernel takes tensors on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K, S


def fused_interval(model, lag: torch.Tensor, det_w: torch.Tensor,
                   det_p: torch.Tensor, det_y: torch.Tensor,
                   det_trig: torch.Tensor, rates: torch.Tensor,
                   lag_add: torch.Tensor, down_pre: torch.Tensor,
                   down_post: torch.Tensor, z1: torch.Tensor,
                   z2: torch.Tensor, workers: torch.Tensor,
                   cpu_cores: torch.Tensor, memory_mb: torch.Tensor,
                   task_slots: torch.Tensor, cap_base: torch.Tensor,
                   det_lam: float, det_thresh: float,
                   dt: float) -> torch.Tensor:
    """K fused-engine ticks of every scenario row in one launch.

    ``model`` is the :class:`~repro_torch.dsp.simulator.ClusterModel`
    whose constants the metrics read. State ``lag``, ``det_w (S, 2)``,
    ``det_p (S, 2, 2)``, ``det_y`` and ``det_trig`` (int64) is updated in
    place; the ``(K, S)`` planes ``rates``/``lag_add``/``z1``/``z2``
    (float64) and ``down_pre``/``down_post`` (bool) and the ``(S,)``
    config operands are read. All contiguous on one CUDA device.

    Returns the metrics as ``(9, K, S)`` float64 in ``METRIC_KEYS`` order
    (``down`` as 0/1), launched on the current stream without a sync.
    """
    planes = {"rates": rates, "lag_add": lag_add, "down_pre": down_pre,
              "down_post": down_post, "z1": z1, "z2": z2}
    configs = {"workers": workers, "cpu_cores": cpu_cores,
               "memory_mb": memory_mb, "task_slots": task_slots,
               "cap_base": cap_base}
    K, S = _check_interval(lag, det_w, det_p, det_y, det_trig, planes,
                           configs)
    out = torch.empty((9, K, S), dtype=torch.float64, device=lag.device)
    fn = build.load("fused_tick").fused_interval_launch
    with torch.cuda.device(lag.device):
        stream = torch.cuda.current_stream(lag.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(*(ptr(t) for t in (lag, det_w, det_p, det_y, det_trig)),
                *(ptr(t) for t in planes.values()),
                *(ptr(t) for t in configs.values()),
                float(model.noise), float(model.base_latency_s),
                float(model.queue_gamma), float(model.latency_cap_s),
                float(model.cpu_idle_frac), float(model.state_per_krate_mb),
                float(det_lam), float(det_thresh), float(dt), K, S, ptr(out),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_interval kernel launch failed: CUDA "
                           f"error {rc}")
    fused_interval.launches += 1
    return out


#: Kernel launches since the process started (or the caller last reset it).
fused_interval.launches = 0  # type: ignore[attr-defined]
