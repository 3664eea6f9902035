"""K3's split over positions, on the CPU.

The decode-attention kernel (``csrc/decode_attention.cu``) cuts every
(row, KV head) into chunks of positions, one CTA each, and merges the
chunks' softmax states in a second pass. What can be checked without a
card:

* the planner (``kernels/decode_attention.py::split_plan``) covers every
  position of ``[0, S_max)`` exactly once, for S_max = 1, a chunk and one
  either side of it, and 4 096, B from 1 to 16; it takes shapes only, and
  gives the same plan for the same shapes;
* the algorithm in plain torch (``kernels/ref.py::
  decode_attention_split_ref``) against K3's plain version
  (``decode_attention_ref``) and the reference's Pallas
  ``decode_attention`` in interpret mode, from the same seeded NumPy
  inputs, at lengths 0, 1, a chunk boundary and one either side of it,
  and S_max; groups of 1, 4, 7 and 16; head dims 64 and 128. float32 at
  atol 2e-6, the bar the plain version already meets against the Pallas
  kernel (``tests/test_torch_models.py``). At length 0 the answer is
  zeros, as the Pallas kernel gives (the reference's oracle
  ``ref.decode_attention_ref`` gives the mean of V there, a known
  difference; it is not used here).
"""
import importlib
import inspect

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     decode_attention_split_ref)
#: the kernels' modules (each wrapper of the package shadows its own)
kmod = importlib.import_module("repro_torch.kernels.decode_attention")

ATOL = 2e-6        # float32, the plain version's bar against Pallas
H100_SMS = 132


def _positions(chunk: int, n_split: int, S: int) -> np.ndarray:
    """How many chunks cover each position of [0, S)."""
    seen = np.zeros(S, np.int64)
    for i in range(n_split):
        seen[i * chunk:min((i + 1) * chunk, S)] += 1
    return seen


@pytest.mark.parametrize("S", [1, kmod.MIN_CHUNK - 1, kmod.MIN_CHUNK,
                               kmod.MIN_CHUNK + 1, kmod.BASE_CHUNK - 1,
                               kmod.BASE_CHUNK, kmod.BASE_CHUNK + 1,
                               kmod.MAX_CHUNK - 1, kmod.MAX_CHUNK,
                               kmod.MAX_CHUNK + 1, 4096, 32_768])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 16])
def test_split_plan_covers_every_position_once(B, S):
    for Hkv in (1, 4, 16):
        for n_sm in (1, 16, H100_SMS):
            chunk, n_split = kmod.split_plan(B, S, Hkv, n_sm)
            assert kmod.MIN_CHUNK <= chunk <= kmod.MAX_CHUNK
            assert chunk % 64 == 0          # four warps of 16 positions
            assert n_split == -(-S // chunk)
            assert (_positions(chunk, n_split, S) == 1).all()
            ctas = B * Hkv * n_split
            # the grid fills the card once, unless the chunk is already
            # the smallest ...
            assert chunk == kmod.MIN_CHUNK or ctas >= n_sm
            # ... and a chunk above the base keeps CTAS_PER_SM an SM
            assert chunk <= kmod.BASE_CHUNK \
                or ctas >= kmod.CTAS_PER_SM * n_sm
            # no larger chunk would have done: it would fall below the
            # same marks
            if chunk < kmod.MAX_CHUNK:
                bigger = B * Hkv * -(-S // (2 * chunk))
                assert bigger < (n_sm if chunk < kmod.BASE_CHUNK
                                 else kmod.CTAS_PER_SM * n_sm)


def test_split_plan_depends_on_shapes_only():
    params = list(inspect.signature(kmod.split_plan).parameters)
    assert params == ["B", "S_max", "Hkv", "n_sm"]
    # qwen2-7b's serving shape, deepseek-moe-16b's, one long row, and a
    # short single row that needs small chunks to reach many SMs
    assert kmod.split_plan(16, 4096, 4, H100_SMS) == (512, 8)
    assert kmod.split_plan(16, 4096, 16, H100_SMS) == (1024, 4)
    assert kmod.split_plan(1, 32_768, 4, H100_SMS) == (512, 64)
    assert kmod.split_plan(1, 2048, 4, H100_SMS) == (64, 32)
    with pytest.raises(ValueError, match="positive"):
        kmod.split_plan(0, 4096, 4, H100_SMS)


def _operands(G: int, D: int, lengths, S: int, Hkv: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed + 100 * G + D)
    B = len(lengths)
    q = rng.normal(0, 1.0, (B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.normal(0, 1.0, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1.0, (B, S, Hkv, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _pallas(q, k, v, lengths):
    return np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths),
                                       interpret=True))


#: S_max 512 is a multiple of the Pallas kernel's block of 256; with 4
#: chunks of 128, the lengths sit at 0, 1, a chunk boundary +- 1 and S_max
S_MAX, N_SPLIT = 512, 4
CHUNK = S_MAX // N_SPLIT
LENGTHS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK, S_MAX]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 16])
def test_split_ref_matches_plain_version_and_pallas(G, D):
    q, k, v, lengths = _operands(G, D, LENGTHS, S_MAX)
    want = _pallas(q, k, v, lengths)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lengths))
    plain = decode_attention_ref(tq, tk, tv, tl).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=ATOL)
    for n_split in (1, N_SPLIT, S_MAX // kmod.MIN_CHUNK):
        got = decode_attention_split_ref(tq, tk, tv, tl, n_split).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
        assert not got[0].any()              # length 0: zeros, as Pallas
        assert np.isfinite(got).all()


@pytest.mark.parametrize("G,D", [(7, 128), (1, 128), (16, 64)])
def test_split_ref_at_the_planners_split(G, D):
    """The split the kernel takes on the card, at a ragged cache length of
    600 (no multiple of the chunk): every chunk past a row's length is
    empty and merges as nothing."""
    S = 600
    lengths = [0, 1, 63, 64, 65, 127, 128, 129, 511, 512, 513, S]
    q, k, v, tl = map(torch.from_numpy, _operands(G, D, lengths, S))
    chunk, n_split = kmod.split_plan(len(lengths), S, 2, H100_SMS)
    assert chunk == kmod.MIN_CHUNK and n_split == -(-S // chunk)
    got = decode_attention_split_ref(q, k, v, tl, n_split)
    torch.testing.assert_close(got, decode_attention_ref(q, k, v, tl),
                               rtol=0, atol=ATOL)
    assert not got[0].any()


def test_split_ref_scalar_length_and_bf16():
    """A scalar length broadcasts to every row; bf16 operands come back in
    bf16, within one bf16 rounding of the float32 answer."""
    q, k, v, _ = map(torch.from_numpy, _operands(4, 64, [0, 0, 0], 256))
    got = decode_attention_split_ref(q, k, v, 100, 4)
    want = decode_attention_ref(q, k, v, 100)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    half = decode_attention_split_ref(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), 100, 4)
    assert half.dtype == torch.bfloat16
    ref = decode_attention_split_ref(
        *(t.bfloat16().float() for t in (q, k, v)), 100, 4)
    torch.testing.assert_close(half.float(), ref, rtol=2 ** -8, atol=1e-6)
