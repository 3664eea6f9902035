"""Where two runs of a compressed train step may part, and by how much.

The step quantizes each gradient to int8 codes per block of 256 with the
block's scale as its quantum (``repro_torch.distributed.compression``).
Two runs whose float32 gradients differ in the last bits give the same
codes, except where a value lies within those bits of a rounding tie: there
one run may take the neighbouring code. :func:`assert_only_ties_part` holds
two runs' error feedback and parameters to exactly that.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Sequence

import torch

from repro_torch.distributed import compression
from repro_torch.training import train as train_mod

#: how far from a whole number of quanta an error-feedback difference, and
#: from a tie a value whose code parted, may lie (the runs' float32
#: gradients differ in their last bits, a few 1e-7 of the block's largest)
TIE_SLACK = 1e-3


@contextlib.contextmanager
def compression_inputs():
    """Record what each train step hands to its compression: a list of
    ``(grads, ef, stacks)``, float32 on the CPU."""
    calls: List[tuple] = []
    real = train_mod.compress_decompress

    def spy(grads, ef_state, stacks=None):
        calls.append(({n: g.detach().float().cpu() for n, g in grads.items()},
                      {n: e.detach().cpu() for n, e in ef_state.items()},
                      stacks))
        return real(grads, ef_state, stacks)
    train_mod.compress_decompress = spy
    try:
        yield calls
    finally:
        train_mod.compress_decompress = real


def quanta(grads: Mapping[str, torch.Tensor], ef: Mapping[str, torch.Tensor],
           stacks) -> Dict[str, torch.Tensor]:
    """Each element's quantum (its block's scale), through the compression's
    own grouping into blocks: every code read as 1."""
    real = compression._quantize_leaf

    def unit_codes(g):
        q, scale = real(g)
        return torch.ones_like(q), scale
    compression._quantize_leaf = unit_codes
    try:
        return compression.compress_decompress(grads, ef, stacks)[0]
    finally:
        compression._quantize_leaf = real


def assert_only_ties_part(call, ef_a: Mapping[str, torch.Tensor],
                          ef_b: Mapping[str, torch.Tensor],
                          params_a: Mapping[str, torch.Tensor],
                          params_b: Mapping[str, torch.Tensor], *,
                          lr: float, bar: float, names: Sequence[str]
                          ) -> int:
    """Two runs of one compressed first step (``call`` is one run's
    :func:`compression_inputs` record): every error-feedback difference is
    a whole number of quanta, 0 or 1; where it is 1 the value was within
    ``TIE_SLACK`` of a rounding tie; and a parameter off by more than
    ``bar`` of its tensor's scale is one whose code parted, off by at most
    2 lr (Adam's first update is below lr in size). Returns how many codes
    parted."""
    grads, ef_in, stacks = call
    scale = quanta(grads, ef_in, stacks)
    parted = 0
    for n in names:
        s = scale[n]
        # an all-zero block has no quantum: its residuals are zero in both
        diff = ef_a[n].cpu() - ef_b[n].cpu()
        k = torch.where(s > 0, diff / s.clamp_min(1e-30), diff)
        assert ((k - k.round()).abs() <= TIE_SLACK).all(), n
        assert (k.round().abs() <= 1).all(), n
        flip = k.round() != 0
        frac = ((grads[n] + ef_in[n]) / s.clamp_min(1e-30)).abs().frac()
        assert ((frac[flip] - 0.5).abs() <= TIE_SLACK).all(), n
        pa, pb = params_a[n].detach().cpu(), params_b[n].detach().cpu()
        d = (pa - pb).abs()
        off = d > bar * pb.abs().max()
        assert not (off & ~flip).any(), n
        assert (d[off] <= 2 * lr * (1 + TIE_SLACK)).all(), n
        parted += int(flip.sum())
    return parted
