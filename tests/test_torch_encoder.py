"""The port's cacheless forward against the reference's.

The same seeded NumPy inputs, and the reference's own parameters carried
across by ``repro_torch.interop``, go through the reference (JAX on the
CPU) and the port (torch on the CPU):

* flash attention's plain version (``ref.flash_attention_ref``, K4's plain
  version) against the reference's Pallas ``flash_attention`` in interpret
  mode and its oracle ``ref.flash_attention_ref``, at the reference tests'
  four shapes (``tests/test_kernels.py::TestFlashAttention``), hubert's
  head dim of 80 and pixtral's group of 4, causal or not: float32 at 2e-5
  (the reference's own bar for its kernel) and bfloat16 at 2e-2 (atol and
  rtol);
* the CUDA wrapper refuses CPU tensors, and its library is built from the
  checkout's source;
* ``_sdpa``'s routing: on the kernel route a query without a cache goes to
  ``ops.flash_attention``, one against a cache to K3 or to the plain
  attention;
* hubert's ``_conv_pos_embed`` and pixtral's projector, float32 at 1e-5
  and bfloat16 bit for bit (both keep the reference's per-operation
  rounding);
* hubert's ``encode``, pixtral's ``train_loss`` and its ``forward`` with
  patches on the smoke configs: float32 against both reference routes
  (plain attention and the Pallas kernel in interpret mode) at 1e-5 of the
  output's scale; bfloat16 against the plain route run operation by
  operation (``jax.disable_jit``) at one bfloat16 ulp of the output's
  scale, and against it as XLA compiles it at two, since the compiled
  layer scan keeps some bfloat16 intermediates in float32 where both the
  port and the eager reference round them (1.5 ulps measured on hubert's
  logits);
* the sequence-chunked loss equal to the unchunked one;
* pixtral served token for token against the reference engine;
* the frontends' parameters carried across by ``interop``.
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
from repro import serving as ref_serving  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.interop import (model_config_from_dict,  # noqa: E402
                                 model_params_from_reference)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import (encode, forward,  # noqa: E402
                                logits_from_hidden, train_loss)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: K4's bars against the Pallas kernel and the oracle (atol and rtol)
FLASH_BARS = {"float32": 2e-5, "bfloat16": 2e-2}
#: smoke-config batch: hubert frames and pixtral tokens (8 patches)
B, S_AUDIO, S_TEXT = 2, 48, 40


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


def _close(got: torch.Tensor, want, dtype: str, ulps: float = 1.0):
    """float32: 1e-5 of the output's scale; bfloat16: ``ulps`` bfloat16
    ulps at the output's scale."""
    want = _np(want)
    got = got.detach().float().numpy()
    atol = (1e-5 * max(np.abs(want).max(), 1.0) if dtype == "float32"
            else ulps * _ulp(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# K4's plain version against the reference's Pallas kernel and oracle
# ---------------------------------------------------------------------------

#: (B, S, Hq, Hkv, D): tests/test_kernels.py::TestFlashAttention's four,
#: hubert's head dim (16 heads of 80) and pixtral's group (32 over 8)
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 4, 1, 64),
                (1, 384, 2, 2, 256), (1, 256, 16, 16, 80),
                (1, 128, 32, 8, 128)]


def _qkv(b, s, hq, hkv, d, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", FLASH_SHAPES)
def test_plain_flash_attention_matches_pallas_kernel(b, s, hq, hkv, d,
                                                     causal, dtype):
    jd, td = DTYPES[dtype]
    q, k, v = _qkv(b, s, hq, hkv, d, seed=b * 1000 + s + hq * 10 + d)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    got = flash_attention_ref(_t(q, td), _t(k, td), _t(v, td), causal=causal)
    assert got.shape == (b, s, hq, d) and got.dtype == td
    tol = FLASH_BARS[dtype]
    for want in (flash_attention(jq, jk, jv, causal=causal, interpret=True),
                 ref_kernels.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_ragged_lengths(causal):
    """Sq = 300 queries (no multiple of a tile) against 77 keys, float32,
    against the reference's oracle (the Pallas kernel takes only multiples
    of its block); causal is top-left aligned."""
    q, k, v = _qkv(2, 300, 6, 3, 16, seed=7, skv=77)
    want = ref_kernels.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                           causal=causal)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)
    if causal:                      # row 0 sees key 0 alone
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   np.repeat(v[:, :1], 2, axis=2)[:, 0],
                                   atol=1e-6)


def test_ops_flash_attention_takes_cpu_or_cuda_only():
    q, k, v = (_t(a) for a in _qkv(1, 8, 2, 1, 16, seed=1))
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                            causal=True)


def test_kernel_wrapper_refuses_cpu_tensors_and_is_built_from_source():
    """The CUDA wrapper never computes on the CPU (its checks run before
    any build), and its library is built from ``csrc/flash_attention.cu``
    into the checkout's build directory, with a typed C entry point."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kmod
    q, k, v = (_t(a) for a in _qkv(1, 8, 2, 1, 16, seed=3))
    with pytest.raises(ValueError, match="CUDA device"):
        kmod.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="do not group"):
        kmod.flash_attention(*(_t(a) for a in _qkv(1, 8, 3, 2, 16, seed=3)),
                             causal=True)
    assert (build.CSRC_DIR / "flash_attention.cu").is_file()
    assert build.library_path("flash_attention").parent == build.BUILD_DIR
    assert build.SIGNATURES["flash_attention"][0] == "flash_attention_launch"


@pytest.mark.parametrize("D,dtype,design,padded", [
    (64, torch.bfloat16, "wgmma-tma", 64),
    (80, torch.bfloat16, "wgmma-tma", 80),
    (128, torch.bfloat16, "wgmma-tma", 128),
    (14, torch.bfloat16, "mma.sync", 16),
    (96, torch.bfloat16, "mma.sync", 128),
    (256, torch.bfloat16, "mma.sync", 256),
    (80, torch.float32, "cuda-cores", 80),
    (128, torch.float32, "cuda-cores", 128)])
def test_kernel_design_by_dtype_and_head_dim(D, dtype, design, padded):
    """bf16 at the configs' head dims 64, 80 and 128 takes the wgmma/TMA
    body, other bf16 widths the mma.sync body (padded inside), float32 the
    CUDA cores: the wrapper's ``design`` names what the C entry point's
    dispatch launches."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kmod
    assert kmod.design(D, dtype) == design
    assert kmod.padded_head_dim(D) == padded
    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    dispatch = " ".join(
        source[source.index('extern "C" int flash_attention_launch'):]
        .split())
    wgmma = f"if (dtype == 1 && D == {D}) return launch_wgmma<{D}>"
    # the C dispatch sends bf16 (dtype 1) at this width to the wgmma body
    # exactly when the wrapper says bf16 takes it
    assert (wgmma in dispatch) == (kmod.design(D, torch.bfloat16)
                                   == "wgmma-tma")


# ---------------------------------------------------------------------------
# _sdpa's routing
# ---------------------------------------------------------------------------

def test_sdpa_routes_the_cacheless_query_to_flash_attention(monkeypatch):
    """Kernel route: no cache -> ``ops.flash_attention`` with the config's
    causal flag; a one-token query against a cache -> ``ops.decode_attention``
    (K3); a prefill against a cache -> the plain attention. The reference
    route never calls a kernel."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, kwargs.get("causal")))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ops, "flash_attention",
                        spy("flash", ops.flash_attention))
    monkeypatch.setattr(ops, "decode_attention",
                        spy("decode", ops.decode_attention))
    for arch, causal in (("hubert_xlarge", False), ("pixtral_12b", True)):
        cfg = model_config_from_dict(dataclasses.asdict(
            ref_smoke_config(arch)))
        q, k, v = (_t(a) for a in _qkv(1, 12, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, seed=2))
        cfg = dataclasses.replace(cfg, attention_impl="kernel")
        calls.clear()
        out = attention._sdpa(cfg, q, k, v, causal=cfg.causal)
        assert calls == [("flash", causal)]
        torch.testing.assert_close(
            out, attention.sdpa_reference(q, k, v, causal=causal))
        calls.clear()
        attention._sdpa(cfg, q[:, :1], k, v, causal=cfg.causal,
                        q_positions=torch.tensor([[5]]), kv_valid_len=6)
        assert calls == [("decode", None)]
        calls.clear()
        attention._sdpa(cfg, q, k, v, causal=cfg.causal,
                        q_positions=torch.arange(12)[None], kv_valid_len=12)
        assert calls == []
        attention._sdpa(dataclasses.replace(cfg, attention_impl="reference"),
                        q, k, v, causal=cfg.causal)
        assert calls == []


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------

def _model_pair(arch: str, dtype: str, ref_impl: str = "reference", **kw):
    """The reference's smoke config and parameters of ``arch`` in
    ``dtype`` (route ``ref_impl``), and the port's model holding them on
    the kernel route."""
    jd, _ = DTYPES[dtype]
    ref_cfg = ref_smoke_config(arch).scaled(attention_impl=ref_impl, **kw)
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg, dtype=jd)
    cfg = dataclasses.replace(
        model_config_from_dict(dataclasses.asdict(ref_cfg)),
        attention_impl="kernel")
    model = model_params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                        device="cpu")
    return ref_cfg, params, cfg, model


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_pos_embed_matches_reference(dtype):
    jd, td = DTYPES[dtype]
    _, params, _, model = _model_pair("hubert_xlarge", dtype)
    h = np.random.default_rng(3).normal(0, 1.0, (B, 50, 64))
    want = ref_transformer._conv_pos_embed(params["frontend"],
                                           jnp.asarray(h, jd))
    with torch.no_grad():
        got = transformer._conv_pos_embed(model.frontend, _t(h, td))
    _close(got, want, dtype, ulps=0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vision_projector_matches_reference(dtype):
    """The patch prefix of the embeddings: the projected patches replace
    the first P positions, the tokens' embeddings follow."""
    jd, td = DTYPES[dtype]
    ref_cfg, params, cfg, model = _model_pair("pixtral_12b", dtype)
    rng = np.random.default_rng(4)
    patches = rng.normal(0, 1.0, (B, 8, cfg.frontend.d_in))
    f = params["frontend"]
    want = ref_layers.dense(
        f["proj2"], jax.nn.gelu(ref_layers.dense(
            f["proj1"], jnp.asarray(patches, jd)), approximate=True))
    with torch.no_grad():
        got = model.frontend.proj2(transformer.gelu_tanh(
            model.frontend.proj1(_t(patches, td))))
    _close(got, want, dtype, ulps=0.0)


# ---------------------------------------------------------------------------
# the entry points: encode, train_loss, forward with patches
# ---------------------------------------------------------------------------

def _audio_batch(dtype: str):
    jd, td = DTYPES[dtype]
    frames = np.random.default_rng(5).normal(0, 1.0, (B, S_AUDIO, 24))
    return {"frames": jnp.asarray(frames, jd)}, {"frames": _t(frames, td)}


def _vision_batch(dtype: str, vocab: int = 256, d_in: int = 32):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, vocab, (B, S_TEXT)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S_TEXT)).astype(np.int32)
    mask = (rng.random((B, S_TEXT)) < 0.8).astype(np.float32)
    patches = rng.normal(0, 1.0, (B, 8, d_in))
    ref = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
           "loss_mask": jnp.asarray(mask), "patches": jnp.asarray(patches, jd)}
    ours = {"tokens": torch.from_numpy(tokens).long(),
            "labels": torch.from_numpy(labels).long(),
            "loss_mask": torch.from_numpy(mask),
            "patches": _t(patches, td)}
    return ref, ours


def _reference_runs(dtype: str, ref_impl: str, fn):
    """``fn()`` as the reference runs it: compiled (its layer scan is one
    XLA computation), and for bfloat16 also operation by operation."""
    runs = {"compiled": fn()}
    if dtype == "bfloat16":
        with jax.disable_jit():
            runs["eager"] = fn()
    return runs


ROUTES = [("float32", "reference"), ("float32", "pallas"),
          ("bfloat16", "reference")]


@pytest.mark.parametrize("dtype,ref_impl", ROUTES)
def test_encode_matches_reference(dtype, ref_impl):
    ref_cfg, params, cfg, model = _model_pair("hubert_xlarge", dtype,
                                              ref_impl)
    ref_batch, batch = _audio_batch(dtype)
    got = encode(model, batch)
    assert got.shape == (B, S_AUDIO, cfg.vocab_size)
    assert got.dtype == DTYPES[dtype][1]
    for run, want in _reference_runs(
            dtype, ref_impl,
            lambda: ref_transformer.encode(params, ref_cfg,
                                           ref_batch)).items():
        _close(got, want, dtype, ulps=2.0 if run == "compiled" else 1.0)


@pytest.mark.parametrize("dtype,ref_impl", ROUTES)
def test_vlm_train_loss_and_forward_match_reference(dtype, ref_impl):
    """pixtral's loss (masked, 8 patch positions) and its logits with the
    patches, against the reference's ``train_loss`` and ``forward``."""
    ref_cfg, params, cfg, model = _model_pair("pixtral_12b", dtype, ref_impl)
    ref_batch, batch = _vision_batch(dtype)
    loss, parts = train_loss(model, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(parts["aux"]) == 0.0 and float(parts["ce"]) == float(loss)
    with torch.no_grad():
        logits = logits_from_hidden(model, forward(
            model, batch["tokens"], patches=batch["patches"]))

    def ref_fn():
        want_loss, _ = ref_transformer.train_loss(params, ref_cfg, ref_batch)
        h, _, _ = ref_transformer.forward(params, ref_cfg, ref_batch)
        return want_loss, ref_transformer.logits_from_hidden(params, ref_cfg,
                                                             h)
    for run, (want_loss, want_logits) in _reference_runs(
            dtype, ref_impl, ref_fn).items():
        ulps = 2.0 if run == "compiled" else 1.0
        if dtype == "float32":
            np.testing.assert_allclose(float(loss), float(want_loss),
                                       rtol=1e-5)
        else:       # the loss is float32 from bfloat16 logits: their ulps
            assert abs(float(loss) - float(want_loss)) \
                <= ulps * _ulp(_np(want_loss)[None])
        _close(logits, want_logits, dtype, ulps=ulps)


def test_chunked_loss_equals_unchunked():
    """``loss_chunk`` = 8 divides S = 40: the chunked loss is the unchunked
    one (float32), and the reference's chunked loss."""
    ref_cfg, params, cfg, model = _model_pair("pixtral_12b", "float32",
                                              loss_chunk=8)
    ref_batch, batch = _vision_batch("float32")
    chunked, _ = train_loss(model, batch)
    model.cfg = dataclasses.replace(cfg, loss_chunk=0)
    whole, _ = train_loss(model, batch)
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)
    want, _ = ref_transformer.train_loss(params, ref_cfg, ref_batch)
    np.testing.assert_allclose(float(chunked), float(want), rtol=1e-5)
    del batch["loss_mask"]                    # the unmasked mean too
    model.cfg = cfg
    chunked, _ = train_loss(model, batch)
    model.cfg = dataclasses.replace(cfg, loss_chunk=0)
    np.testing.assert_allclose(float(chunked),
                               float(train_loss(model, batch)[0]), rtol=1e-6)


def test_train_loss_differentiates_on_the_reference_route_only():
    """The kernel route runs under ``no_grad`` (K4 has no backward); the
    plain route keeps the graph."""
    _, _, cfg, model = _model_pair("pixtral_12b", "float32")
    _, batch = _vision_batch("float32")
    loss, _ = train_loss(model, batch)
    assert not loss.requires_grad
    model.cfg = dataclasses.replace(cfg, attention_impl="reference")
    loss, _ = train_loss(model, batch)
    loss.backward()
    assert model.frontend.proj1.w.grad is not None


# ---------------------------------------------------------------------------
# serving and parameters
# ---------------------------------------------------------------------------

#: the reference's ragged workload (tests/test_serving.py)
PROMPT_LENS = (8, 12, 16, 9, 11)


def _serve(engine, request_cls, prompts):
    for i, pr in enumerate(prompts):
        engine.submit(request_cls(f"r{i}", pr, max_tokens=6, arrival_s=0.0))
    for _ in range(40):
        engine.admit()
        if engine.step() == 0 and not engine.queue:
            break
    return [engine.requests[f"r{i}"].output for i in range(len(prompts))]


def test_vlm_serves_tokens_like_the_reference_engine():
    """pixtral serves tokens only (no patches), through the dense KV
    cache, token for token with the reference engine."""
    ref_cfg, params, cfg, model = _model_pair("pixtral_12b", "float32",
                                              ref_impl="pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    ref_eng = ref_serving.ServingEngine(ref_cfg, params, n_slots=3,
                                        max_len=96)
    want = _serve(ref_eng, ref_serving.Request, prompts)
    eng = ServingEngine(cfg, model, n_slots=3, max_len=96, device="cpu")
    assert set(eng.cache) == {"index", "k", "v"}
    assert _serve(eng, Request, prompts) == want
    assert eng.metrics.decode_steps == ref_eng.metrics.decode_steps


def test_encoder_has_no_decode_step():
    _, _, cfg, model = _model_pair("hubert_xlarge", "float32")
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        ServingEngine(cfg, model, n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="takes frames"):
        forward(model, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("arch", ["hubert_xlarge", "pixtral_12b"])
def test_parameters_carry_across(arch):
    """Every leaf of the reference's tree lands in the port's module of the
    same name: hubert has no token embedding and its own head, pixtral its
    projector; the frontends' leaves included."""
    _, params, cfg, model = _model_pair(arch, "float32")
    flat = {}

    def walk(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)
    walk(params)
    state = model.state_dict()
    assert ("embed.table" in state) == (arch == "pixtral_12b")
    assert "lm_head.w" in state
    front = sorted(k for k in state if k.startswith("frontend."))
    assert front == sorted(k for k in flat if k.startswith("frontend."))
    assert front == (["frontend.pos_conv_b", "frontend.pos_conv_w",
                      "frontend.proj.w"] if arch == "hubert_xlarge"
                     else ["frontend.proj1.w", "frontend.proj2.w"])
    for name in front + ["lm_head.w", "final_norm.scale"]:
        np.testing.assert_array_equal(state[name].numpy(), flat[name])
    layers = flat["stack.mixer.wq.w"]
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            state[f"blocks.{i}.mixer.wq.w"].numpy(), layers[i])
