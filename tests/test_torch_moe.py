"""The port's MoE and MLA slice against the reference's.

The same seeded NumPy inputs, and the reference's own parameters carried
across by ``repro_torch.interop``, go through the reference (JAX on the
CPU) and the port (torch on the CPU):

* K6's plain version (``kernels/ref.py::grouped_matmul_ref``, through
  ``ops``) against the reference's Pallas ``grouped_matmul`` in interpret
  mode at ``TestGroupedMatmul``'s three shapes and its per-token routing
  case, at 1e-5 of the output's scale in float32; the package's
  ``sort_tokens_for_experts`` equal to the reference's, and the model
  path's statically sized sort (``sort_assignments``, tiles of -1 past the
  last group) giving every kept assignment its own product;
* K7's plain version against the Pallas ``fused_rmsnorm`` in interpret
  mode at ``TestFusedRMSNorm``'s shapes: 1e-5 in float32, one bfloat16 ulp
  of each element in bf16;
* ``moe_apply`` on both expert routes (the capacity buffer and the sorted
  grouped matmul) against the reference's, drop-free or not, with a
  capacity that drops assignments and with router logits built to tie
  (resolved as ``jax.lax.top_k`` resolves them), and its aux and z losses:
  float32 at 1e-5 of the output's scale, bfloat16 within one ulp;
* ``mla_apply`` without a cache, prefill at cursor 0 and > 0 and a ragged
  absorbed decode step, with and without query compression; the absorbed
  step against the naive path from the same cache;
* the whole slice at both smoke configs: ``forward`` logits, ``train_loss``
  (ce and aux), ``prefill`` and ``decode_step`` and the serving engine
  against the reference engine token for token (4 requests of mixed
  lengths over 2 slots, so slots are reused); the parameter tree with its
  list of dense first blocks carried across and back.

bfloat16 model results are held at one ulp against the reference run
operation by operation (``jax.disable_jit``): compiled, its layers keep
some bfloat16 intermediates in float32 (ROADMAP.md §3).
"""
import dataclasses
import importlib
import math

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

from repro import models as ref_models  # noqa: E402
from repro import serving as ref_serving  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul as ref_grouped_matmul,
    sort_tokens_for_experts as ref_sort_tokens)
from repro.kernels.rmsnorm import fused_rmsnorm  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.interop import (_flatten, load_reference_params,  # noqa: E402
                                 model_config_from_dict,
                                 model_params_from_reference)
from repro_torch.kernels import ops, sort_tokens_for_experts  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    BLOCK_MS, sort_assignments)
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_cache, logits_from_hidden, prefill,
                                train_loss)
from repro_torch.models import mla, moe, transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
#: the kernels' modules (each wrapper of the package shadows its own)
gmm_mod = importlib.import_module("repro_torch.kernels.grouped_matmul")

SLICE = ["deepseek_moe_16b", "deepseek_v2_lite_16b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROUTES = ["reference", "kernel"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor operations run fastest on one thread; several test
    workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _ulp(want: np.ndarray) -> float:
    """The spacing of bfloat16 values just below the largest magnitude."""
    return 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)


def _close(got: torch.Tensor, want, dtype: str):
    """float32: 1e-5 of the output's scale; bfloat16: one bfloat16 ulp at
    the output's scale."""
    want = _np(want)
    got = got.detach().float().numpy()
    atol = (1e-5 * max(np.abs(want).max(), 1.0) if dtype == "float32"
            else _ulp(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _cfgs(arch: str, impl: str = "kernel", **moe_overrides):
    """The reference's smoke config (with ``moe_overrides``) and the
    port's, on route ``impl``."""
    ref_cfg = ref_smoke_config(arch)
    if moe_overrides:
        ref_cfg = ref_cfg.scaled(moe=dataclasses.replace(ref_cfg.moe,
                                                         **moe_overrides))
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    return ref_cfg, dataclasses.replace(cfg, attention_impl=impl)


# ---------------------------------------------------------------------------
# K6's plain version and the sorts against the reference
# ---------------------------------------------------------------------------

#: tests/test_kernels.py::TestGroupedMatmul's shapes (tokens, E, K, N)
GMM_SHAPES = [(300, 4, 128, 256), (1000, 8, 256, 128), (64, 2, 128, 128)]


@pytest.mark.parametrize("n_tok,e,k,n", GMM_SHAPES)
def test_plain_grouped_matmul_matches_pallas_kernel(n_tok, e, k, n):
    rng = np.random.default_rng(n_tok + e)
    x = rng.normal(size=(n_tok, k)).astype(np.float32)
    eids = rng.integers(0, e, n_tok)
    lhs, tiles, _, _ = ref_sort_tokens(x, eids, e, 128)
    rhs = rng.normal(size=(e, k, n)).astype(np.float32)
    want = np.asarray(ref_grouped_matmul(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(tiles),
        interpret=True))
    got = ops.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                             torch.from_numpy(tiles), blk_m=128)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_plain_grouped_matmul_per_token_expert_routing():
    """Gathered back, each row is its token's x @ W[expert] (the reference's
    per-token routing case), and the Pallas kernel's row."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(100, 128)).astype(np.float32)
    eids = rng.integers(0, 4, 100)
    rhs = rng.normal(size=(4, 128, 64)).astype(np.float32)
    lhs, tiles, inv, valid = sort_tokens_for_experts(
        torch.from_numpy(x), torch.from_numpy(eids), 4, 128)
    got = ops.grouped_matmul(lhs, torch.from_numpy(rhs), tiles, blk_m=128)
    want = np.asarray(ref_grouped_matmul(
        jnp.asarray(lhs.numpy()), jnp.asarray(rhs),
        jnp.asarray(tiles.numpy()), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for row, src in zip(got[valid].numpy(), inv[valid].numpy()):
        np.testing.assert_allclose(row, x[src] @ rhs[eids[src]], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("n_tok,e,blk", [(300, 4, 128), (1000, 8, 128),
                                         (64, 2, 128), (37, 8, 16),
                                         (5, 6, 32)])
def test_sort_tokens_for_experts_matches_reference(n_tok, e, blk):
    """The same (lhs, tile_expert, inv, valid) as the reference's helper,
    exactly; (5, 6) leaves experts empty."""
    rng = np.random.default_rng(n_tok * e)
    x = rng.normal(size=(n_tok, 16)).astype(np.float32)
    eids = rng.integers(0, e, n_tok)
    want = ref_sort_tokens(x, eids, e, blk)
    got = sort_tokens_for_experts(torch.from_numpy(x),
                                  torch.from_numpy(eids), e, blk)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("blk", BLOCK_MS)
def test_sort_assignments_gives_each_kept_assignment_its_product(blk):
    """The static sort: ``rows = round_up(A + E (blk - 1), blk)``; tiles past
    the last group carry -1 (zeros in the plain version); every kept
    assignment's row holds its token's product with its expert's weights
    (the reference helper's row for it), and dropped ones get no row."""
    rng = np.random.default_rng(blk)
    n_exp, a, k = 8, 90, 32
    x = rng.normal(size=(a, k)).astype(np.float32)
    eids = torch.from_numpy(rng.integers(0, n_exp, a))
    keep = torch.from_numpy(rng.random(a) < 0.8)
    rhs = torch.from_numpy(rng.normal(size=(n_exp, k, 16)).astype(np.float32))
    srt = sort_assignments(eids, keep, n_exp, blk)
    assert srt.rows == -(-(a + n_exp * (blk - 1)) // blk) * blk
    assert srt.tile_expert.shape == (srt.rows // blk,)
    assert bool((srt.dest[~keep] == srt.rows).all())
    kept_dest = srt.dest[keep]
    assert len(set(kept_dest.tolist())) == int(keep.sum())
    lhs = torch.zeros(srt.rows + 1, k)
    lhs[srt.dest] = torch.from_numpy(x)
    out = ops.grouped_matmul(lhs[:srt.rows], rhs, srt.tile_expert, blk_m=blk)
    # each tile's expert is its rows' expert; the rest are -1 and zeros
    te = srt.tile_expert.long()
    assert bool((te[kept_dest // blk] == eids[keep]).all())
    assert not out.view(-1, blk, 16)[te < 0].any()
    want = torch.einsum("ak,akn->an", torch.from_numpy(x)[keep],
                        rhs[eids[keep]])
    np.testing.assert_allclose(out[kept_dest].numpy(), want.numpy(),
                               rtol=0, atol=1e-5)
    # the same rows as the reference's data-sized helper on the kept ones
    ref_lhs, ref_tiles, ref_inv, ref_valid = ref_sort_tokens(
        x[keep.numpy()], eids[keep].numpy(), n_exp, blk)
    ref_out = np.asarray(ref_grouped_matmul(
        jnp.asarray(ref_lhs), jnp.asarray(rhs.numpy()),
        jnp.asarray(ref_tiles), blk_m=blk, blk_n=16, blk_k=32,
        interpret=True))
    rows = np.empty((int(keep.sum()), 16), np.float32)
    rows[ref_inv[ref_valid]] = ref_out[ref_valid]
    np.testing.assert_allclose(out[kept_dest].numpy(), rows, rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# K7's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 37, 512), (2, 256, 128), (7, 64)])
def test_plain_fused_rmsnorm_matches_pallas_kernel(shape, dtype):
    """tests/test_kernels.py::TestFusedRMSNorm's shapes: y and s within
    1e-5 in float32, one bfloat16 ulp of each element in bf16."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = rng.normal(size=shape)
    res = rng.normal(size=shape)
    sc = rng.normal(size=shape[-1:]) * 0.1
    want = fused_rmsnorm(jnp.asarray(x, jd), jnp.asarray(res, jd),
                         jnp.asarray(sc, jd), interpret=True)
    got = ops.fused_rmsnorm(_t(x, td), _t(res, td), _t(sc, td))
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=0))
    for g, w in zip(got, want):
        assert g.dtype == td and g.shape == shape
        np.testing.assert_allclose(g.float().numpy(), _np(w), **tol)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_pair(cfg_pair, dtype: str, tie: bool = False):
    ref_cfg, cfg = cfg_pair
    jd, td = DTYPES[dtype]
    p = ref_moe.moe_init(jax.random.PRNGKey(4), ref_cfg, dtype=jd)
    if tie:     # router columns in equal pairs: every token's logits tie
        w = p["router"]["w"]
        p["router"]["w"] = jnp.repeat(w[:, ::2], 2, axis=1)
    mod = moe.MoE(cfg, generator=torch.Generator(), dtype=td, device="cpu")
    load_reference_params(mod, jax.tree.map(np.asarray, p))
    return p, mod


#: (capacity_factor, drop_free): the smoke configs' drop-free capacity,
#: a capacity of 1.0 that drops assignments, and that capacity with
#: drop_free (the decode steps'), which overrides it
MOE_CASES = {"capacity": (4.0, False), "dropping": (1.0, False),
             "drop_free": (1.0, True), "ties": (1.0, False)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", ROUTES)
def test_moe_apply_matches_reference(impl, dtype, case):
    cf, drop_free = MOE_CASES[case]
    ref_cfg, cfg = _cfgs("deepseek_moe_16b", impl, capacity_factor=cf)
    jd, td = DTYPES[dtype]
    p, mod = _moe_pair((ref_cfg, cfg), dtype, tie=case == "ties")
    x = np.random.default_rng(5).normal(0, 1.0, (2, 24, ref_cfg.d_model))
    want, want_aux = ref_moe.moe_apply(p, ref_cfg, jnp.asarray(x, jd),
                                       drop_free=drop_free)
    with torch.no_grad():
        got, aux = moe.moe_apply(mod, cfg, _t(x, td), drop_free=drop_free)
    assert got.dtype == td and got.shape == x.shape
    _close(got, want, dtype)
    with torch.no_grad():       # serving's call: the same y, no losses
        bare, none = moe.moe_apply(mod, cfg, _t(x, td), drop_free=drop_free,
                                   with_aux=False)
    assert none is None and torch.equal(bare, got)
    for key in ("moe_aux_loss", "moe_z_loss"):
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-5)
    if case == "dropping":      # the capacity really drops assignments
        e = ref_cfg.moe
        n = x.shape[0] * x.shape[1]
        capacity = max(math.ceil(n * e.top_k * cf / e.n_routed), e.top_k)
        logits = _t(x, td).reshape(n, -1) @ mod.router.w
        _, top_i = moe.top_k(torch.softmax(logits.float(), -1), e.top_k)
        assert int(torch.bincount(top_i.flatten()).max()) > capacity


def test_top_k_resolves_ties_as_jax():
    """Tied probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(6)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4.0
    want_w, want_i = jax.lax.top_k(jnp.asarray(probs), 6)
    got_w, got_i = moe.top_k(torch.from_numpy(probs), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("blk", BLOCK_MS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_design_names_the_c_dispatch(dtype, blk):
    """bf16 at blk_m 64 and 128 (prompts) takes the wgmma/TMA body, at 16
    and 32 (decode, short prompts) the mma.sync body, float32 the CUDA
    cores: the wrapper's ``design`` names what the C entry point's
    dispatch launches."""
    from repro_torch.kernels import build
    name = gmm_mod.design(blk, dtype)
    want = ("cuda-cores" if dtype == torch.float32 else
            "wgmma-tma" if blk in (64, 128) else "mma.sync")
    assert name == want
    source = (build.CSRC_DIR / "grouped_matmul.cu").read_text()
    dispatch = " ".join(
        source[source.index('extern "C" int grouped_matmul_launch'):]
        .split())
    code = 1 if dtype == torch.bfloat16 else 0
    for body, launcher in (("wgmma-tma", "launch_wgmma"),
                           ("mma.sync", "launch_mma")):
        branch = (f"if (dtype == {code} && blk_m == {blk}) "
                  f"return {launcher}<{blk}>")
        assert (branch in dispatch) == (name == body)
    # float32 falls through to the CUDA-core switch, which has every blk_m
    assert f"case {blk}: return launch_f32<{blk}>" in dispatch


def test_block_m_follows_the_mean_group():
    assert moe.block_m(16 * 6, 64) == 16         # a decode step
    assert moe.block_m(256 * 6, 64) == 32
    assert moe.block_m(2048 * 6, 64) == 128      # a 2048-token prompt
    assert moe.block_m(10 ** 6, 8) == 128


# ---------------------------------------------------------------------------
# mla_apply
# ---------------------------------------------------------------------------

def _mla_pair(dtype: str, q_lora: int):
    ref_cfg = ref_smoke_config("deepseek_v2_lite_16b")
    ref_cfg = ref_cfg.scaled(mla=dataclasses.replace(ref_cfg.mla,
                                                     q_lora_rank=q_lora))
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    jd, td = DTYPES[dtype]
    p = ref_mla.mla_init(jax.random.PRNGKey(7), ref_cfg, dtype=jd)
    mod = mla.MLA(cfg, generator=torch.Generator(), dtype=td, device="cpu")
    load_reference_params(mod, jax.tree.map(np.asarray, p))
    return ref_cfg, cfg, p, mod


@pytest.mark.parametrize("q_lora", [0, 24])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_apply_matches_reference(dtype, q_lora):
    """Without a cache; then into a 2-row cache: a prefill at cursor 0, a
    second chunk at cursor 9, and a ragged absorbed decode step (row 1
    overwrites position 4); outputs and the latent cache against the
    reference's with its cache threaded through."""
    ref_cfg, cfg, p, mod = _mla_pair(dtype, q_lora)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(8)
    b, smax = 2, 24
    x = rng.normal(0, 1.0, (b, 9, cfg.d_model))
    pos = np.broadcast_to(np.arange(9), (b, 9)).copy()
    with torch.no_grad():
        got = mla.mla_apply(mod, cfg, _t(x, td), torch.from_numpy(pos))
    want, _ = ref_mla.mla_apply(p, ref_cfg, jnp.asarray(x, jd),
                                jnp.asarray(pos))
    _close(got, want, dtype)

    ref_cache = {k: v[0] for k, v in ref_mla.init_mla_cache(
        ref_cfg, b, smax, dtype=jd, n_layers=1).items()}
    cache = mla.init_mla_cache(cfg, b, smax, dtype=td, device="cpu",
                               n_layers=1)
    layer = (cache["c_kv"][0], cache["k_rope"][0])
    x2 = rng.normal(0, 1.0, (b, 5, cfg.d_model))
    ages = np.array([14, 4], np.int32)
    x3 = rng.normal(0, 1.0, (b, 1, cfg.d_model))
    steps = ((x, pos, 0), (x2, pos[:, :5] + 9, 9),
             (x3, ages[:, None], ages))
    for xs, ps, idx in steps:
        with torch.no_grad():
            got = mla.mla_apply(
                mod, cfg, _t(xs, td), torch.from_numpy(ps.astype(np.int64)),
                cache=layer, cache_index=(torch.from_numpy(idx)
                                          if isinstance(idx, np.ndarray)
                                          else idx))
        want, ref_cache = ref_mla.mla_apply(
            p, ref_cfg, jnp.asarray(xs, jd), jnp.asarray(ps), cache=ref_cache,
            cache_index=jnp.asarray(idx))
        _close(got, want, dtype)
        _close(layer[0], ref_cache["c_kv"], dtype)
        _close(layer[1], ref_cache["k_rope"], dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_absorbed_decode_matches_naive_path(dtype):
    """One ragged step through the absorbed form against the naive path
    from the same cache: float32 at 1e-5 of the output's scale, bf16 at
    2e-2 (the two round at different places)."""
    _, cfg, _, mod = _mla_pair(dtype, 0)
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(9)
    b, smax = 3, 20
    cache = mla.init_mla_cache(cfg, b, smax, dtype=td, device="cpu",
                               n_layers=1)
    cc, cr = cache["c_kv"][0], cache["k_rope"][0]
    cc.copy_(_t(rng.normal(0, 1.0, cc.shape), td))
    cr.copy_(_t(rng.normal(0, 1.0, cr.shape), td))
    ages = torch.tensor([19, 0, 7])
    x = _t(rng.normal(0, 1.0, (b, 1, cfg.d_model)), td)
    with torch.no_grad():
        q_nope, q_rope = mla._queries(mod, cfg, x, ages[:, None])
        got = mla._absorbed_decode(mod, cfg, q_nope, q_rope, cc, cr,
                                   ages + 1)
        want = mla._naive(mod, cfg, q_nope, q_rope, cc, cr,
                          q_positions=ages[:, None], kv_valid_len=ages + 1)
    want = want.float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _model_pair(arch: str, dtype: str, impl: str):
    ref_cfg, cfg = _cfgs(arch, impl)
    jd = DTYPES[dtype][0]
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg, dtype=jd)
    model = model_params_from_reference(cfg, jax.tree.map(np.asarray,
                                                          params),
                                        device="cpu")
    return ref_cfg, params, cfg, model


def _reference(dtype: str, fn):
    """``fn()`` as the reference runs it: compiled in float32, operation by
    operation in bfloat16 (see the module docstring)."""
    if dtype == "float32":
        return fn()
    with jax.disable_jit():
        return fn()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("arch", SLICE)
def test_forward_logits_match_reference(arch, impl, dtype):
    ref_cfg, params, cfg, model = _model_pair(arch, dtype, impl)
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)

    def ref_fn():
        h, _, _ = ref_models.forward(params, ref_cfg,
                                     {"tokens": jnp.asarray(toks)})
        return ref_models.logits_from_hidden(params, ref_cfg, h)
    with torch.no_grad():
        got = logits_from_hidden(model, forward(
            model, torch.from_numpy(toks).long()))
    _close(got, _reference(dtype, ref_fn), dtype)


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("arch", SLICE)
def test_train_loss_matches_reference(arch, impl):
    """The loss, its ce and its aux (every MoE layer's aux and z losses)
    at 1e-5 in float32, on a masked batch."""
    ref_cfg, params, cfg, model = _model_pair(arch, "float32", impl)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    want, want_parts = ref_models.train_loss(
        params, ref_cfg, {"tokens": jnp.asarray(tokens),
                          "labels": jnp.asarray(labels),
                          "loss_mask": jnp.asarray(mask)})
    loss, parts = train_loss(model, {"tokens": torch.from_numpy(tokens),
                                     "labels": torch.from_numpy(labels),
                                     "loss_mask": torch.from_numpy(mask)})
    assert float(want_parts["aux"]) > 0.0
    for g, w in ((loss, want), (parts["ce"], want_parts["ce"]),
                 (parts["aux"], want_parts["aux"])):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    if impl == "reference":     # the capacity buffer's route differentiates
        loss.backward()
        grad = model.blocks[1].ffn.experts.down.w.grad
        assert grad is not None and bool(grad.isfinite().all())
        assert float(grad.abs().max()) > 0.0


@pytest.mark.parametrize("arch", SLICE)
def test_only_train_loss_computes_the_aux_losses(arch, monkeypatch):
    """``forward``, ``prefill`` and ``decode_step`` call every MoE layer
    with ``with_aux=False`` (no loss launches while serving);
    ``train_loss`` with ``with_aux=True``, once per MoE layer."""
    _, _, cfg, model = _model_pair(arch, "float32", "kernel")
    calls = []

    def spy(*args, with_aux=True, **kw):
        calls.append(with_aux)
        return moe.moe_apply(*args, with_aux=with_aux, **kw)
    monkeypatch.setattr(transformer, "moe_apply", spy)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 8)))
    moe_layers = cfg.n_layers - cfg.moe.first_dense_layers
    with torch.no_grad():
        forward(model, toks)
        cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        prefill(model, toks, cache)
        decode_step(model, toks[:, :1], cache)
    assert calls == [False] * 3 * moe_layers
    calls.clear()
    _, parts = train_loss(model, {"tokens": toks, "labels": toks})
    assert calls == [True] * moe_layers and float(parts["aux"]) > 0.0


@pytest.mark.parametrize("dtype,impl", [("float32", "reference"),
                                        ("float32", "kernel"),
                                        ("bfloat16", "kernel")])
@pytest.mark.parametrize("arch", SLICE)
def test_prefill_and_decode_match_reference(arch, impl, dtype):
    """A prompt of 11, a uniform step, then a ragged one at per-row ages:
    logits and the cache against the reference's. The port stacks all L
    layers' caches; the reference keeps the dense first layers' in a list
    beside its stack."""
    ref_cfg, params, cfg, model = _model_pair(arch, dtype, impl)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)

    def ref_fn():
        outs = []
        c = ref_models.init_cache(ref_cfg, 2, 32, dtype=jd)
        logits, c = ref_models.prefill(
            params, ref_cfg, {"tokens": jnp.asarray(prompt)}, c)
        outs.append(logits)
        for i, lens in enumerate((None, lengths)):
            logits, c = ref_models.decode_step(
                params, ref_cfg, jnp.asarray(toks[:, i:i + 1]), c,
                None if lens is None else jnp.asarray(lens))
            outs.append(logits)
        return outs, c
    want, ref_cache = _reference(dtype, ref_fn)
    cache = init_cache(cfg, 2, 32, dtype=td, device="cpu")
    got = [prefill(model, torch.from_numpy(prompt).long(), cache)[0]]
    for i, lens in enumerate((None, lengths)):
        got.append(decode_step(model, torch.from_numpy(toks[:, i:i + 1]),
                               cache, None if lens is None
                               else torch.from_numpy(lens))[0])
    for g, w in zip(got, want):
        _close(g, w, dtype)
    assert cache["index"] == int(ref_cache["index"]) == 13
    keys = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
    for key in keys:
        want_leaf = np.concatenate(
            [_np(ref_cache["prefix"][0][key])[None],
             _np(ref_cache["layers"][key])])
        _close(cache[key], want_leaf, dtype)


@pytest.mark.parametrize("arch", SLICE)
def test_engine_matches_reference_engine(arch):
    """4 requests of 5-14 prompt tokens through 2 slots (the second pair
    reuses them), 6 new tokens each, float32: the same tokens as the
    reference engine (compiled, its capacity buffer)."""
    ref_cfg = ref_smoke_config(arch)
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg,
                                    dtype=jnp.float32)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, ref_cfg.vocab_size, n) for n in (9, 14, 5,
                                                                11)]

    def serve(eng, request_cls):
        for i, pr in enumerate(prompts):
            eng.submit(request_cls(f"r{i}", pr, max_tokens=6, arrival_s=0.0))
        for _ in range(40):
            eng.admit()
            if eng.step() == 0 and not eng.queue:
                break
        return [eng.requests[f"r{i}"].output for i in range(len(prompts))]
    ref_eng = ref_serving.ServingEngine(ref_cfg, params, n_slots=2,
                                        max_len=32)
    want = serve(ref_eng, ref_serving.Request)
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    model = model_params_from_reference(cfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu")
    eng = ServingEngine(cfg, model, n_slots=2, max_len=32, device="cpu")
    got = serve(eng, Request)
    assert got == want
    assert all(len(o) == 6 for o in got)
    assert eng.metrics.completed == ref_eng.metrics.completed == 4
    assert eng.metrics.decode_steps == ref_eng.metrics.decode_steps


@pytest.mark.parametrize("arch", SLICE)
def test_parameters_carry_across_with_the_prefix_list(arch):
    """The reference's tree (a list of dense first blocks, the rest stacked)
    flattens with the list's items named by index, and every leaf lands
    in the port's block of the same layer."""
    ref_cfg, params, cfg, model = _model_pair(arch, "float32", "kernel")
    flat = dict(_flatten(jax.tree.map(np.asarray, params)))
    n_prefix = ref_cfg.moe.first_dense_layers
    assert {n.split(".")[1] for n in flat if n.startswith("prefix.")} \
        == {str(i) for i in range(n_prefix)}
    state = model.state_dict()
    assert len(state) == (len([n for n in flat if not n.startswith("stack")])
                          + (cfg.n_layers - n_prefix)
                          * len([n for n in flat if n.startswith("stack")]))
    for name, a in flat.items():
        if name.startswith("prefix."):
            np.testing.assert_array_equal(
                state[f"blocks.{name[len('prefix.'):]}"].numpy(), a)
        elif name.startswith("stack."):
            for i in range(cfg.n_layers - n_prefix):
                np.testing.assert_array_equal(
                    state[f"blocks.{n_prefix + i}.{name[len('stack.'):]}"]
                    .numpy(), a[i])
        else:
            np.testing.assert_array_equal(state[name].numpy(), a)
    assert isinstance(model.blocks[0].ffn, torch.nn.Module)
    assert not isinstance(model.blocks[0].ffn, moe.MoE)
    assert all(isinstance(b.ffn, moe.MoE) for b in model.blocks[n_prefix:])
    assert isinstance(model.blocks[0].mixer, mla.MLA) == (cfg.mla is not None)
