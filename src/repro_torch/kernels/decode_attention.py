"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attention.cu``).

Replaces the reference's Pallas kernel
``src/repro/kernels/decode_attention.py::decode_attention``: one-token
grouped-query attention over each row's first ``lengths[b]`` cache entries,
with an online softmax in float32. The serving path's ``decode_step``
launches it once per layer. It reads the cache in place, in the layout the
model keeps it, ``(B, S_max, Hkv, D)``, at the head dims it is built for
(:data:`HEAD_DIMS`); a narrower head (the reduced configs', 14 for
qwen2-7b's) is zero-padded to the next of them in a copy, which adds
nothing to a score and gives zero output columns, cut off after the
launch, and the scores keep its own ``1/sqrt(D)``. The kernel takes CUDA tensors only;
:func:`repro_torch.kernels.ops.decode_attention` routes CPU tensors to the
plain version (:func:`repro_torch.kernels.ref.decode_attention_ref`).

Each call is two launches: pass 1 splits every (row, KV head) over CTAs
in chunks of positions (:func:`split_plan`, from the shapes alone, so the
wrapper never reads ``lengths`` and never syncs), pass 2 merges the
chunks' partial softmax states in chunk order. The float32 partials
(``B·Hq·n_split·(D+2)`` values) are allocated here; the kernel allocates
nothing. :func:`repro_torch.kernels.ref.decode_attention_split_ref` is the
same algorithm in plain torch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from . import build

#: dtype code of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for (a narrower head is zero-padded to the
#: next), and the largest group it takes
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16
#: a chunk is a power of two of at least 64 positions (four warps of
#: 16-position tiles): it starts at BASE_CHUNK and stays within these bounds
MIN_CHUNK, BASE_CHUNK, MAX_CHUNK = 64, 512, 2048
#: pass 1 grows its chunks only while it keeps this many CTAs per SM
CTAS_PER_SM = 4


def split_plan(B: int, S_max: int, Hkv: int, n_sm: int) -> Tuple[int, int]:
    """``(chunk, n_split)`` of pass 1: each (row, KV head) is cut into
    ``n_split = ceil(S_max / chunk)`` chunks of ``chunk`` positions, chunk
    ``i`` covering ``[i·chunk, (i+1)·chunk)``, one CTA each.

    The chunk starts at ``BASE_CHUNK``; it halves (down to ``MIN_CHUNK``)
    while the ``B·Hkv·n_split`` CTAs would not fill the ``n_sm`` SMs once,
    and doubles (up to ``MAX_CHUNK``) while the larger chunk still leaves
    ``CTAS_PER_SM`` CTAs an SM: every CTA and the merge have a fixed cost,
    so chunks are as large as filling the card allows. The plan depends on
    the shapes only, never on the lengths, so choosing it costs no device
    sync and a CUDA graph can capture it.
    """
    if min(B, S_max, Hkv, n_sm) < 1:
        raise ValueError(f"split_plan takes positive shapes, got B={B}, "
                         f"S_max={S_max}, Hkv={Hkv}, n_sm={n_sm}")

    def ctas(chunk: int) -> int:
        return B * Hkv * -(-S_max // chunk)
    chunk = BASE_CHUNK
    while chunk > MIN_CHUNK and ctas(chunk) < n_sm:
        chunk //= 2
    while chunk < MAX_CHUNK and ctas(2 * chunk) >= CTAS_PER_SM * n_sm:
        chunk *= 2
    return chunk, -(-S_max // chunk)


def padded_head_dim(D: int) -> int:
    """The head dim of :data:`HEAD_DIMS` the kernel runs ``D`` at."""
    return next(p for p in HEAD_DIMS if D <= p)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if not 1 <= D <= HEAD_DIMS[-1]:
        raise ValueError(f"the decode_attention kernel takes head dims up to "
                         f"{HEAD_DIMS[-1]}, got {D}")
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
    """q: (B, 1, Hq, D); k, v: (B, S_max, Hkv, D), D up to 256, one dtype
    (float32 or bfloat16), contiguous, on one CUDA device; lengths: an int, a 0-d
    tensor or (B,) integers, clamped to [0, S_max] by the kernel.

    Returns ``out (B, 1, Hq, D)`` in q's dtype (zeros for a row of length
    0), launched on the current stream without a sync. Both passes count
    as one launch of ``decode_attention.launches``.
    """
    B, S, Hkv, G, D = _check(q, k, v)
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.numel() not in (1, B) or lengths.dim() > 1:
        raise ValueError(f"lengths must be a scalar or ({B},), got shape "
                         f"{tuple(lengths.shape)}")
    lengths = lengths.reshape(-1).expand(B).contiguous()
    chunk, n_split = split_plan(B, S, Hkv, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = torch.empty(B * Hkv * G * n_split * (Dp + 2), dtype=torch.float32,
                       device=q.device)
    fn = build.load("decode_attention").decode_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(lengths), ptr(out), ptr(part), B,
                S, Hkv, G, Dp, D, _DTYPES[q.dtype], chunk, n_split,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out if Dp == D else out[..., :D].contiguous()


#: Kernel launches since the process started (or the caller last reset it).
decode_attention.launches = 0  # type: ignore[attr-defined]
