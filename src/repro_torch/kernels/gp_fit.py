"""Wrapper of the GP bank's fit kernel (``csrc/gp_fit.cu``).

One launch fits a whole batch of padded GPs: a CTA per (member, restart)
row runs optax's L-BFGS with the zoom line search to its end on the card,
as the plain version
(:func:`repro_torch.core.gp_bank.lbfgs_batched` over
:func:`repro_torch.core.gp.neg_mll_and_grad`) does row by row with a host
read for every line-search trial. The reference's fit is plain JAX
(``src/repro/core/gp_bank.py::_lbfgs_minimize``: ``optax.lbfgs()`` in a
``lax.while_loop``), not a Pallas kernel. The kernel takes CUDA tensors
only; :func:`repro_torch.core.gp_bank._fit_packed` routes CPU tensors to
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: n x n buffers above this many points live in a global scratch buffer
SHARED_N = 128
#: the kernel's largest d + 2
MAX_PARAMS = 18


def gp_lbfgs(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             t0: torch.Tensor, *, restarts: int, max_iter: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit B padded GPs from ``restarts`` starts each: x (B, n, d), y and
    mask (B, n), t0 (B * restarts, d + 2), float32 on one CUDA device.
    Returns the fitted thetas (B * restarts, d + 2), each row's iteration
    count and its objective evaluations (int32)."""
    if x.dim() != 3 or y.shape != x.shape[:2] or mask.shape != x.shape[:2]:
        raise ValueError(f"x must be (B, n, d) with y and mask (B, n), got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(mask.shape)}")
    B, n, d = x.shape
    if restarts < 1 or tuple(t0.shape) != (B * restarts, d + 2):
        raise ValueError(f"t0 must be ({B * restarts}, {d + 2}), got "
                         f"{tuple(t0.shape)}")
    if d + 2 > MAX_PARAMS:
        raise ValueError(f"at most {MAX_PARAMS - 2} input dimensions, got {d}")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    for name, t in (("x", x), ("y", y), ("mask", mask), ("t0", t0)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the gp_lbfgs kernel "
                             f"takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    x, y, mask, t0 = (t.contiguous() for t in (x, y, mask, t0))
    rows = B * restarts
    theta = torch.empty_like(t0)
    counts = torch.empty(rows, dtype=torch.int32, device=x.device)
    evals = torch.empty_like(counts)
    scratch = (torch.empty((rows, 2, n, n), dtype=torch.float32,
                           device=x.device) if n > SHARED_N else None)
    fn = build.load("gp_fit").gp_lbfgs_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(  # noqa: E731
            None if t is None else t.data_ptr())
        rc = fn(ptr(x), ptr(y), ptr(mask), ptr(t0), ptr(theta), ptr(counts),
                ptr(evals), ptr(scratch), rows, n, d, restarts, max_iter,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gp_lbfgs kernel launch failed: CUDA error {rc}")
    gp_lbfgs.launches += 1
    return theta, counts, evals


gp_lbfgs.launches = 0  # type: ignore[attr-defined]
