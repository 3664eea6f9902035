"""Shape stand-ins for every dry-run cell: tensors on the ``meta`` device
(shapes and dtypes, no storage), the counterpart of the reference's
``jax.ShapeDtypeStruct`` and ``jax.eval_shape``.

The assigned input-shape set:
  train_4k     seq 4096   global_batch 256   (train_step)
  prefill_32k  seq 32768  global_batch 32    (prefill / encoder forward)
  decode_32k   seq 32768  global_batch 128   (serve_step: 1 token + KV cache)
  long_500k    seq 524288 global_batch 1     (long-context decode)

Cells excluded by the assignment rules (encoder-only decode, long_500k for
full-attention archs) are enumerated in :func:`cell_supported`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import init_cache, init_params
from ..models.config import ModelConfig

SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

#: which step a shape lowers
SHAPE_KIND = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode"}

META = torch.device("meta")


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Assignment rules for skipped cells."""
    kind = SHAPE_KIND[shape]
    if kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k assigned to SSM/hybrid"
    return True, ""


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                       device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *,
                training: bool) -> Dict[str, torch.Tensor]:
    """Model-input structs for one forward/train step."""
    b: Dict[str, torch.Tensor] = {}
    if cfg.frontend is not None and cfg.frontend.kind == "audio":
        b["frames"] = _struct((batch, seq, cfg.frontend.d_in), cfg.dtype)
        if training:
            b["labels"] = _struct((batch, seq), "int32")
            b["loss_mask"] = _struct((batch, seq), "float32")
        return b
    b["tokens"] = _struct((batch, seq), "int32")
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        b["patches"] = _struct((batch, cfg.frontend.prefix_len,
                                cfg.frontend.d_in), cfg.dtype)
    if training:
        b["labels"] = _struct((batch, seq), "int32")
    return b


def param_structs(cfg: ModelConfig):
    """The model of ``cfg`` on the meta device: every parameter's shape and
    dtype, nothing drawn or allocated."""
    return init_params(cfg, device=META)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache of ``cfg`` on the meta device."""
    return init_cache(cfg, batch, max_len, device=META)


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, object]:
    """All structs needed to run the cell's step function."""
    seq, batch = SHAPES[shape]
    kind = SHAPE_KIND[shape]
    out: Dict[str, object] = {"kind": kind, "seq": seq, "batch": batch}
    out["params"] = param_structs(cfg)
    if kind == "train":
        out["inputs"] = batch_specs(cfg, batch, seq, training=True)
    elif kind == "prefill":
        out["inputs"] = batch_specs(cfg, batch, seq, training=False)
        if cfg.supports_decode:
            out["cache"] = cache_structs(cfg, batch, seq)
    else:  # decode: one new token against a seq-length cache
        out["inputs"] = {"tokens": _struct((batch, 1), "int32")}
        out["cache"] = cache_structs(cfg, batch, seq)
    return out
