"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attention.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/decode_attention.py::decode_attention``: one-token
grouped-query attention over each row's first ``lengths[b]`` cache entries,
with an online softmax in float32. The serving path's ``decode_step``
launches it once per layer. It reads the cache in place, in the layout the
model keeps it, ``(B, S_max, Hkv, D)``. The kernel takes CUDA tensors only;
:func:`repro_torch.kernels.ops.decode_attention` routes CPU tensors to the
plain version (:func:`repro_torch.kernels.ref.decode_attention_ref`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for, and the largest group it takes
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> Tuple[int, int, int, int, int]:
    """Validate the operands; returns ``(B, S_max, Hkv, G, D)``."""
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[0] < 1:
        raise ValueError(f"q must be a non-empty (B, 1, Hq, D) tensor, got "
                         f"shape {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1:
        raise ValueError(f"k must be (B={B}, S_max, Hkv, D={D}), got shape "
                         f"{tuple(k.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must have k's shape {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} query heads do not group over "
                         f"Hkv = {Hkv} KV heads")
    G = Hq // Hkv
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"the decode_attention kernel takes groups of 1 to "
                         f"{MAX_GROUP} query heads per KV head, got {G}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the decode_attention "
                             f"kernel takes tensors on one CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, S, Hkv, G, D


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B, 1, Hq, D); k, v: (B, S_max, Hkv, D), one dtype (float32 or
    bfloat16), contiguous, on one CUDA device; lengths: an int, a 0-d
    tensor or (B,) integers, clamped to [0, S_max] by the kernel.

    Returns ``out (B, 1, Hq, D)`` in q's dtype (zeros for a row of length
    0), launched on the current stream without a sync.
    """
    B, S, Hkv, G, D = _check(q, k, v)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.numel() not in (1, B) or lengths.dim() > 1:
        raise ValueError(f"lengths must be a scalar or ({B},), got shape "
                         f"{tuple(lengths.shape)}")
    lengths = lengths.reshape(-1).expand(B).contiguous()
    out = torch.empty_like(q)
    fn = build.load("decode_attention").decode_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(lengths), ptr(out), B, S, Hkv, G,
                D, _DTYPES[q.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


#: Kernel launches since the process started (or the caller last reset it).
decode_attention.launches = 0  # type: ignore[attr-defined]
