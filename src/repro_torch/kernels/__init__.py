"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch
versions (:mod:`.ref`), dispatched by device in :mod:`.ops`.

The package exports the reference's names (``repro/kernels/__init__.py``):
:mod:`.ops`, :mod:`.ref`, the dispatching wrappers of :mod:`.ops` and
:func:`sort_tokens_for_experts`; and, as the port's own, the wrappers of
the kernels the reference runs as per-tick loops or in plain JAX
(:func:`arima_chunk`, :func:`fused_interval`, :func:`gp_lbfgs`). A
wrapper's name shadows its submodule's, so reach a kernel's module with
``importlib.import_module("repro_torch.kernels.<name>")``. Building a
kernel happens at its first launch, never at import."""
from . import ops, ref
from .grouped_matmul import sort_tokens_for_experts
from .ops import (arima_chunk, decode_attention, flash_attention,
                  fused_interval, fused_rmsnorm, gp_lbfgs, grouped_matmul,
                  rls_rank1_update, ssd_scan)

__all__ = ["ops", "ref", "flash_attention", "decode_attention", "ssd_scan",
           "grouped_matmul", "sort_tokens_for_experts", "fused_rmsnorm",
           "rls_rank1_update",
           # the port's own
           "arima_chunk", "fused_interval", "gp_lbfgs"]
