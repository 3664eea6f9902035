"""The operation and byte counts of ``chipbench/work.py`` against counts
made by hand from the published shapes."""
import json
from pathlib import Path

import pytest

from chipbench import weights, work
from chipbench.arch import deepseek as arch

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def load(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


MOE = load("deepseek-moe-16b")
MLA = load("deepseek-v2-lite-16b")


def test_cache_bytes_a_token():
    # 28 layers x (K and V) x 16 heads x 128 x 2 bytes
    assert work.kv_bytes_per_token(MOE) == 28 * 2 * 16 * 128 * 2 == 229_376
    # 27 layers x (512 latent + 64 RoPE key) x 2 bytes
    assert work.kv_bytes_per_token(MLA) == 27 * (512 + 64) * 2 == 31_104


def test_active_parameters_by_hand():
    attn = 4 * 2048 * 2048
    dense = 3 * 2048 * 10_944
    moe = (6 + 2) * 3 * 2048 * 1408 + 2048 * 64
    assert work.active_params(MOE) == 28 * attn + dense + 27 * moe
    assert round(work.active_params(MOE) / 1e9, 2) == 2.41
    mla = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)
    assert work.active_params(MLA) == 27 * mla + dense + 26 * moe
    assert round(work.active_params(MLA) / 1e9, 2) == 2.24


@pytest.mark.parametrize("cfg,billions", [(MOE, 16.37), (MLA, 15.70)])
def test_total_parameters_match_the_weights_drawn(cfg, billions):
    drawn = sum(weights.numel(shape) for _, shape, _ in arch.spec(cfg))
    assert work.total_params(cfg) == drawn
    assert billions <= drawn / 1e9 < billions + 0.01


def test_prefill_and_decode_flops():
    n = 2048
    pairs = n * (n + 1) // 2
    want = (2 * work.active_params(MOE) * n + 28 * 4 * 16 * 128 * pairs
            + 2 * 2048 * 102_400)
    assert work.prefill_flops(MOE, n) == want
    ctx = [10, 300, 4000]
    want = (3 * (2 * work.active_params(MOE) + 2 * 2048 * 102_400)
            + 28 * 4 * 16 * 128 * sum(ctx))
    assert work.decode_flops(MOE, ctx) == want


def test_attention_work():
    n = 1000
    pairs = n * (n + 1) // 2
    assert work.attn_prefill_work(MOE, n) == (4 * 16 * 128 * pairs,
                                              4 * n * 16 * 128 * 2)
    flops, nbytes = work.attn_prefill_work(MLA, n)
    assert flops == 2 * n * 512 * 16 * 256 + (2 * 16 * 192 + 2 * 16 * 128) \
        * pairs
    assert nbytes == 2 * (n * 576 + 512 * 16 * 256 + n * 16 * 192
                          + n * 16 * 128)
    ctx = [100, 900]
    assert work.attn_decode_work(MOE, ctx) == (
        4 * 16 * 128 * 1000, 2 * (1000 * 2 * 16 * 128 + 2 * 2 * 16 * 128))
    flops, nbytes = work.attn_decode_work(MLA, ctx)
    assert flops == 2 * 2 * 16 * 512 * 256 + 1000 * (2 * 16 * 576
                                                      + 2 * 16 * 512)
    assert nbytes == 2 * (1000 * 576 + 512 * 16 * 256 + 2 * 16 * 320)


def test_experts_work_and_roofline():
    flops, nbytes = work.experts_work(MOE, kept=96, reached=47)
    assert flops == 96 * 6 * 2048 * 1408
    assert nbytes == 2 * (47 * 3 * 2048 * 1408 + 96 * 2 * 2048)
    # 96 decode assignments are bound by the weights' bytes
    assert work.roofline_s(flops, nbytes) == nbytes / work.PEAK_HBM_BYTES
    assert work.roofline_s(1e15, 1.0) == 1e15 / work.PEAK_BF16_FLOPS
