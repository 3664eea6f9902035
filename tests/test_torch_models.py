"""The port's dense decoders against the reference's.

The same seeded NumPy inputs, and the reference's own parameters carried
across by ``repro_torch.interop``, go through the reference (JAX on the
CPU) and the port (torch on the CPU):

* layers: ``rmsnorm``, ``apply_rope``, the three ``mlp`` kinds,
  ``attention_apply`` (prefill and ragged decode) and ``cache_update``,
  float32 at atol 1e-5 and bfloat16 at one bfloat16 ulp of the output's
  scale;
* the plain decode attention (``decode_attention_ref``, K3's plain version)
  against the reference's Pallas kernel in interpret mode at atol 2e-6 in
  float32, with lengths 0 and 1, groups of 1, 2 and 7 and a cache length
  that is no multiple of the kernel's block;
* ``prefill`` and ``decode_step`` logits of the four dense smoke configs at
  rtol 1e-5 (atol 1e-5 of the logits' scale), through the plain attention
  and through the kernel route;
* decode continuity, the port's mirror of
  ``tests/test_arch_smoke.py::test_decode_continuity``: ``prefill`` of 16
  tokens and one ``decode_step`` give the 17-token ``forward``'s last
  logits within 5e-4 (float32) for every smoke config that decodes
  (pixtral with its patch prefix), and the reference's own
  ``prefill``/``decode_step`` logits on the same parameters.
"""
import dataclasses
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
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels.decode_attention import decode_attention  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.interop import (load_reference_params,  # noqa: E402
                                 model_config_from_dict,
                                 model_params_from_reference)
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_cache, init_params, logits_from_hidden,
                                prefill)
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.transformer import PORTED_FAMILIES  # noqa: E402
from repro_torch.kernels.ref import decode_attention_ref  # noqa: E402

DENSE = ["qwen2_7b", "gemma_7b", "mistral_nemo_12b", "deepseek_7b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, dtype: str):
    """float32: atol 1e-5; bfloat16: one ulp at the scale of the output
    (the spacing of bfloat16 values just below its largest magnitude)."""
    want = _np(want)
    got = got.float().numpy()
    if dtype == "float32":
        atol = 1e-5
    else:
        atol = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_carry_across(arch):
    """Every config is the reference's, field for field, except that the
    port defaults to the kernel route (the reference's ``"pallas"``)."""
    from repro.configs import get_config as ref_get_config
    for ref, ours in ((ref_get_config(arch), get_config(arch)),
                      (ref_smoke_config(arch), smoke_config(arch))):
        assert ours.attention_impl == "kernel"
        assert model_config_from_dict(dataclasses.asdict(
            ref.scaled(attention_impl="pallas"))) == ours
        assert model_config_from_dict(dataclasses.asdict(ref)) == \
            dataclasses.replace(ours, attention_impl="reference")


def test_non_dense_families_are_refused():
    """Every family of the ten configs is ported (moe, which holds the mla
    config too, came last) and builds; a family outside the port is
    refused."""
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        assert cfg.family in PORTED_FAMILIES
        init_params(cfg, device="cpu")
    assert PORTED_FAMILIES == ("dense", "ssm", "hybrid", "encoder", "vlm",
                               "moe")
    cfg = dataclasses.replace(smoke_config("qwen2_7b"), family="bogus")
    with pytest.raises(NotImplementedError, match="not ported"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        init_cache(cfg, 1, 8, device="cpu")


def test_init_cache_refuses_the_encoder():
    """An encoder has no decode step (the reference's rule); the vlm gets
    the dense KV cache."""
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        init_cache(smoke_config("hubert_xlarge"), 1, 8, device="cpu")
    cfg = smoke_config("pixtral_12b")
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert set(cache) == {"index", "k", "v"}
    assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_and_layernorm(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (3, 5, 64))
    scale = rng.normal(0, 0.3, 64)
    bias = rng.normal(0, 0.3, 64)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale, jd)},
                              jnp.asarray(x, jd))
    _close(layers.rmsnorm(_t(x, td), _t(scale, td)), want, dtype)
    want = ref_layers.layernorm({"scale": jnp.asarray(scale, jd),
                                 "bias": jnp.asarray(bias, jd)},
                                jnp.asarray(x, jd))
    _close(layers.layernorm(_t(x, td), _t(scale, td), _t(bias, td)), want,
           dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.0, (2, 7, 3, 16))
    pos = rng.integers(0, 4096, (2, 7))
    want = ref_layers.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos),
                                 1_000_000.0)
    got = layers.apply_rope(_t(x, td), torch.from_numpy(pos), 1_000_000.0)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(kind, dtype):
    jd, td = DTYPES[dtype]
    p = ref_layers.mlp_init(jax.random.PRNGKey(2), 32, 96, kind, dtype=jd)
    x = np.random.default_rng(2).normal(0, 1.0, (2, 5, 32))
    want = ref_layers.mlp(p, jnp.asarray(x, jd), kind)
    mod = layers.MLP(32, 96, kind, generator=torch.Generator(),
                     dtype=td, device="cpu")
    load_reference_params(mod, _tree_np(p))
    with torch.no_grad():
        _close(mod(_t(x, td)), want, dtype)


def _attention_pair(arch: str, jd, td):
    ref_cfg = ref_smoke_config(arch)
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    p = ref_attn.attention_init(jax.random.PRNGKey(3), ref_cfg, dtype=jd)
    mod = attention.Attention(cfg, generator=torch.Generator(), dtype=td,
                              device="cpu")
    load_reference_params(mod, _tree_np(p))
    return ref_cfg, cfg, p, mod


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_attention_apply_prefill_then_ragged_decode(impl, dtype):
    """A prompt written at offset 0 of a 2-row cache, then one ragged decode
    step at per-row ages (the engine's path), against the reference's
    ``attention_apply`` with the cache threaded through."""
    jd, td = DTYPES[dtype]
    ref_cfg, cfg, p, mod = _attention_pair("qwen2_7b", jd, td)
    ref_cfg = ref_cfg.scaled(attention_impl="pallas" if impl == "kernel"
                             else "reference")
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    rng = np.random.default_rng(4)
    b, s, smax = 2, 9, 24
    hd = cfg.resolved_head_dim
    x = rng.normal(0, 1.0, (b, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s), (b, s))
    ref_cache = ref_attn.init_kv_cache(ref_cfg, b, smax, dtype=jd,
                                       n_layers=1)
    ref_cache = {k: v[0] for k, v in ref_cache.items()}
    cache = attention.init_kv_cache(cfg, b, smax, dtype=td, device="cpu",
                                    n_layers=1)
    layer = (cache["k"][0], cache["v"][0])
    with torch.no_grad():
        out = attention.attention_apply(mod, cfg, _t(x, td),
                                        torch.from_numpy(pos.copy()),
                                        cache=layer, cache_index=0)
    want, ref_cache = ref_attn.attention_apply(
        p, ref_cfg, jnp.asarray(x, jd), jnp.asarray(pos), cache=ref_cache,
        cache_index=jnp.asarray(0))
    _close(out, want, dtype)
    _close(layer[0], ref_cache["k"], dtype)

    ages = np.array([s, 4], np.int32)          # row 1 overwrites position 4
    x1 = rng.normal(0, 1.0, (b, 1, cfg.d_model))
    with torch.no_grad():
        out = attention.attention_apply(mod, cfg, _t(x1, td),
                                        torch.from_numpy(ages[:, None] + 0),
                                        cache=layer,
                                        cache_index=torch.from_numpy(ages))
    want, ref_cache = ref_attn.attention_apply(
        p, ref_cfg, jnp.asarray(x1, jd), jnp.asarray(ages[:, None]),
        cache=ref_cache, cache_index=jnp.asarray(ages))
    _close(out, want, dtype)
    _close(layer[0], ref_cache["k"], dtype)
    _close(layer[1], ref_cache["v"], dtype)
    assert layer[0].shape == (b, smax, cfg.n_kv_heads, hd)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cache_update(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    buf = rng.normal(0, 1.0, (3, 10, 2, 8))
    new = rng.normal(0, 1.0, (3, 4, 2, 8))
    want = ref_attn.cache_update(jnp.asarray(buf, jd), jnp.asarray(new, jd),
                                 jnp.asarray(5))
    got = _t(buf, td)
    attention.cache_update(got, _t(new, td), 5)
    _close(got, want, dtype)
    idx = np.array([0, 9, 3], np.int32)
    want = ref_attn.cache_update(jnp.asarray(buf, jd),
                                 jnp.asarray(new[:, :1], jd),
                                 jnp.asarray(idx))
    got = _t(buf, td)
    attention.cache_update(got, _t(new[:, :1], td), torch.from_numpy(idx))
    _close(got, want, dtype)
    with pytest.raises(ValueError, match="cannot write"):
        attention.cache_update(_t(buf, td), _t(new, td), 8)


# ---------------------------------------------------------------------------
# K3's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hkv,group,d", [(3, 1, 16), (2, 2, 32), (1, 7, 16),
                                         (2, 7, 64)])
def test_plain_decode_attention_matches_pallas_kernel(hkv, group, d):
    """Ragged lengths 0, 1, S_max and between; S_max = 40 is no multiple
    of the kernel's default block of 256 (it runs one block of 40)."""
    rng = np.random.default_rng(hkv * 100 + group * 10 + d)
    b, smax = 5, 40
    q = rng.normal(0, 1.0, (b, 1, hkv * group, d)).astype(np.float32)
    k = rng.normal(0, 1.0, (b, smax, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (b, smax, hkv, d)).astype(np.float32)
    lengths = np.array([0, 1, smax, 17, 33], np.int32)
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths),
                                       interpret=True))
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, lengths)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert not got[0].any()                    # length 0: zeros, as Pallas
    # a scalar length broadcasts to every row
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(11),
                                       interpret=True))
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v)), 11)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# the model: prefill and decode logits
# ---------------------------------------------------------------------------

def _model_pair(arch: str, impl: str):
    ref_cfg = ref_smoke_config(arch)
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg,
                                    dtype=jnp.float32)
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    model = model_params_from_reference(cfg, _tree_np(params), device="cpu")
    return ref_cfg, params, cfg, model


def _logits_close(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match_reference(arch, impl):
    ref_cfg, params, cfg, model = _model_pair(arch, impl)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    ref_cache = ref_models.init_cache(ref_cfg, 2, 32, dtype=jnp.float32)
    cache = init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    want, ref_cache = ref_models.prefill(
        params, ref_cfg, {"tokens": jnp.asarray(prompt)}, ref_cache)
    got, cache = prefill(model, torch.from_numpy(prompt).long(), cache)
    _logits_close(got, want)
    assert cache["index"] == int(ref_cache["index"]) == 11
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(ref_cache["layers"]["k"]),
                               rtol=1e-5, atol=1e-5)
    # a uniform step, then a ragged one at per-row ages
    for lengths in (None, np.array([12, 7], np.int32)):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, ref_cache = ref_models.decode_step(
            params, ref_cfg, jnp.asarray(tok), ref_cache,
            None if lengths is None else jnp.asarray(lengths))
        got, cache = decode_step(
            model, torch.from_numpy(tok).long(), cache,
            None if lengths is None else torch.from_numpy(lengths))
        _logits_close(got, want)
        assert cache["index"] == int(ref_cache["index"])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if smoke_config(a).supports_decode])
def test_decode_continuity(arch):
    """prefill(16) + decode(1) == forward(17) at 5e-4 in float32 (the
    reference's own test and bar), with the reference's parameters carried
    across; the decode logits also equal the reference's ``prefill`` +
    ``decode_step`` on those parameters at 5e-4. A vision model prefills
    its patch prefix."""
    ref_cfg, params, cfg, model = _model_pair(arch, "kernel")
    rng = np.random.default_rng(7)
    b = 2
    toks = rng.integers(0, cfg.vocab_size, (b, 17)).astype(np.int32)
    ref_batch = {"tokens": jnp.asarray(toks)}
    patches = None
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        pp = rng.normal(0, 1.0, (b, cfg.frontend.prefix_len,
                                 cfg.frontend.d_in)).astype(np.float32)
        ref_batch["patches"] = jnp.asarray(pp)
        patches = torch.from_numpy(pp)
    t = torch.from_numpy(toks).long()
    want = logits_from_hidden(model, forward(model, t, patches=patches))[:, -1]

    cache = init_cache(cfg, b, 64, dtype=torch.float32, device="cpu")
    _, cache = prefill(model, t[:, :16], cache, patches=patches)
    got, cache = decode_step(model, t[:, 16:17], cache)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               atol=5e-4, rtol=5e-4)
    assert cache["index"] == 17

    ref_cache = ref_models.init_cache(ref_cfg, b, 64, dtype=jnp.float32)
    _, ref_cache = ref_models.prefill(
        params, ref_cfg, {**ref_batch, "tokens": jnp.asarray(toks[:, :16])},
        ref_cache)
    ref_got, _ = ref_models.decode_step(params, ref_cfg,
                                        jnp.asarray(toks[:, 16:17]),
                                        ref_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_got), atol=5e-4,
                               rtol=5e-4)
