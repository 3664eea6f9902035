"""The port's state-space serving slice (mamba2, zamba2) against the
reference's.

The same seeded NumPy inputs, and the reference's own parameters carried
across by ``repro_torch.interop``, go through the reference (JAX on the
CPU) and the port (torch on the CPU):

* the plain SSD scan (``ssd_scan_ref``, K5's plain version) against the
  reference's ``ssd_chunked_reference`` and its Pallas kernel in interpret
  mode at ``tests/test_kernels.py``'s shapes (atol and rtol 5e-5, the
  reference's bar), and the chunked scan's final state against the port's
  one-token recurrence (``ssd_decode_step``, 1e-4 as the reference's);
* the mixer (``mamba2_apply``: prefill, then one-token decode) and zamba2's
  shared block (prefill, then ragged decode) at 1e-5 in float32 and one
  bfloat16 ulp of the output's scale in bfloat16;
* prefill and decode logits of both smoke configs at rtol 1e-5 (atol 1e-5
  of the logits' scale), through the plain scan and the kernel route;
* the engine, token for token, against the reference engine where no slot
  is reused (a one-token prompt included), and the fresh-sequence rule:
  a reused slot gives what a fresh one gives, which is the reference's
  prefill from a fresh cache (the reference's own reused slot does not);
* ``python -m repro_torch.launch.serve --smoke --arch mamba2-1.3b``.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

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
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.interop import (load_reference_params,  # noqa: E402
                                 model_config_from_dict,
                                 model_params_from_reference)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import (cache_slot_view, decode_step,  # noqa: E402
                                init_cache, prefill)
from repro_torch.models import mamba2, transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ["mamba2_1p3b", "zamba2_2p7b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference's SSD shapes (tests/test_kernels.py::TestSSDScan)
SSD_SHAPES = [(2, 512, 4, 64, 1, 128, 128), (1, 256, 8, 64, 2, 128, 256),
              (2, 256, 4, 64, 4, 128, 128)]


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


def _ssd_inputs(b, s, h, p, g, n, seed, a_log_max=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            rng.uniform(0, a_log_max, (h,)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_plain_ssd_scan_matches_reference_and_pallas(b, s, h, p, g, n,
                                                     chunk):
    arrays = _ssd_inputs(b, s, h, p, g, n, seed=s + h + g)
    got_y, got_state = ssd_scan_ref(*map(torch.from_numpy, arrays), chunk)
    for want_y, want_state in (
            ref_mamba2.ssd_chunked_reference(*map(jnp.asarray, arrays),
                                             chunk=chunk),
            pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                            interpret=True)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(got_state.numpy(),
                                   np.asarray(want_state),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_dispatch_on_cpu_is_the_plain_version(dtype):
    """``ops.ssd_scan`` on CPU tensors is ``ssd_scan_ref``: y in x's dtype,
    the state float32; strong decay (A up to 16, dt up to 1) stays finite
    although ``exp(cum_i - cum_j)`` overflows above the diagonal."""
    td = DTYPES[dtype][1]
    x, dt, a_log, bm, cm = _ssd_inputs(1, 64, 3, 16, 1, 16, seed=3,
                                       a_log_max=math.log(16))
    dt = np.random.default_rng(4).uniform(0.001, 1.0, dt.shape)
    args = (_t(x, td), _t(dt), _t(a_log), _t(bm, td), _t(cm, td))
    y, state = ops.ssd_scan(*args, chunk=16)
    want_y, want_state = ssd_scan_ref(*args, 16)
    assert y.dtype == td and state.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert y.isfinite().all() and state.isfinite().all()
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_scan_ref(*args, 48)


def test_chunked_state_matches_the_recurrence():
    """The scan's final state equals the port's one-token recurrence run
    over the sequence (the reference's ``test_state_continuity_chunks``),
    and each recurrence step equals the reference's ``ssd_decode_step``."""
    x, dt, a_log, bm, cm = _ssd_inputs(1, 128, 2, 64, 1, 128, seed=5,
                                       a_log_max=1.0)
    _, final = ssd_scan_ref(*map(torch.from_numpy, (x, dt, a_log, bm, cm)),
                            64)
    state = torch.zeros(1, 2, 64, 128)
    for t in range(x.shape[1]):
        prev = state.clone()
        y, new = mamba2.ssd_decode_step(
            state, *(torch.from_numpy(a[:, t]) for a in (x, dt)),
            torch.from_numpy(a_log),
            *(torch.from_numpy(a[:, t]) for a in (bm, cm)))
        assert new is state                     # updated in place
        if t % 32 == 0:
            want_y, want_state = ref_mamba2.ssd_decode_step(
                jnp.asarray(prev.numpy()), x[:, t], dt[:, t], a_log,
                bm[:, t], cm[:, t])
            _close(y, want_y, "float32")
            _close(state, want_state, "float32")
    np.testing.assert_allclose(final.numpy(), state.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the mixer and the shared block
# ---------------------------------------------------------------------------

def _mixer_pair(jd, td, impl):
    ref_cfg = ref_smoke_config("mamba2_1p3b").scaled(
        attention_impl="pallas" if impl == "kernel" else "reference")
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    p = ref_mamba2.mamba2_init(jax.random.PRNGKey(3), ref_cfg, dtype=jd)
    mod = mamba2.Mamba2(cfg, generator=torch.Generator(), dtype=td,
                        device="cpu")
    load_reference_params(mod, _tree_np(p))
    return ref_cfg, cfg, p, mod


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_mamba2_apply_prefill_then_decode(impl, dtype):
    """A 37-token prompt (padded to the chunk of 16 inside) written into a
    fresh 2-row cache, then two one-token decode steps, against the
    reference's ``mamba2_apply`` with its cache threaded through."""
    jd, td = DTYPES[dtype]
    ref_cfg, cfg, p, mod = _mixer_pair(jd, td, impl)
    assert mod.a_log.dtype == mod.dt_bias.dtype == torch.float32
    rng = np.random.default_rng(7)
    b, s = 2, 37
    x = rng.normal(0, 1.0, (b, s, cfg.d_model))
    ref_cache = {k: v[0] for k, v in
                 ref_mamba2.init_mamba_cache(ref_cfg, b, n_layers=1).items()}
    arena = mamba2.init_mamba_cache(cfg, b, n_layers=1, device="cpu")
    cache = transformer._mamba_layer(arena, 0)
    with torch.no_grad():
        out = mamba2.mamba2_apply(mod, cfg, _t(x, td), cache=cache,
                                  cache_index=0)
    want, ref_cache = ref_mamba2.mamba2_apply(p, ref_cfg, jnp.asarray(x, jd),
                                              cache=ref_cache)
    _close(out, want, dtype)
    for key in ("conv_x", "conv_bc", "ssd"):
        _close(getattr(cache, key), ref_cache[key], dtype)
    for step in range(2):
        x1 = rng.normal(0, 1.0, (b, 1, cfg.d_model))
        with torch.no_grad():
            out = mamba2.mamba2_apply(
                mod, cfg, _t(x1, td), cache=cache,
                cache_index=torch.tensor([s + step, s + step]))
        want, ref_cache = ref_mamba2.mamba2_apply(
            p, ref_cfg, jnp.asarray(x1, jd), cache=ref_cache)
        _close(out, want, dtype)
        _close(cache.ssd, ref_cache["ssd"], dtype)
    # the cacheless forward
    with torch.no_grad():
        out = mamba2.mamba2_apply(mod, cfg, _t(x, td))
    want, _ = ref_mamba2.mamba2_apply(p, ref_cfg, jnp.asarray(x, jd))
    _close(out, want, dtype)


def test_mamba2_prefill_restarts_and_refuses_a_cursor_past_zero():
    """A prefill at cursor 0 ignores what the cache held (conv and SSD
    state); a one-token call at cursor 0 too; a multi-token call at a
    cursor > 0 raises."""
    _, cfg, _, mod = _mixer_pair(jnp.float32, torch.float32, "reference")
    rng = np.random.default_rng(8)
    x = _t(rng.normal(0, 1.0, (1, 20, cfg.d_model)))
    for s in (20, 1):
        outs = []
        for junk in (0.0, 3.0):
            arena = mamba2.init_mamba_cache(cfg, 1, n_layers=1,
                                            device="cpu")
            for leaf in arena.values():
                leaf.fill_(junk)
            with torch.no_grad():
                outs.append(mamba2.mamba2_apply(
                    mod, cfg, x[:, :s],
                    cache=transformer._mamba_layer(arena, 0),
                    cache_index=0))
        assert torch.equal(outs[0], outs[1])
    with pytest.raises(NotImplementedError, match="cursor > 0"):
        mamba2.mamba2_apply(mod, cfg, x, cache=transformer._mamba_layer(
            arena, 0), cache_index=5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shared_block_prefill_then_ragged_decode(dtype):
    """zamba2's shared block on concat(x, emb0): a prompt into a 2-row
    cache at offset 0, then a ragged step at per-row ages, against the
    reference's ``shared_block_apply``."""
    jd, td = DTYPES[dtype]
    ref_cfg = ref_smoke_config("zamba2_2p7b")
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    p = ref_transformer.shared_block_init(jax.random.PRNGKey(4), ref_cfg,
                                          dtype=jd)
    mod = transformer.SharedBlock(cfg, generator=torch.Generator(),
                                  dtype=td, device="cpu")
    load_reference_params(mod, _tree_np(p))
    rng = np.random.default_rng(9)
    b, s, smax = 2, 9, 24
    nh = cfg.hybrid.shared_n_heads
    hd = 2 * cfg.d_model // nh
    x, emb0 = (rng.normal(0, 1.0, (b, s, cfg.d_model)) for _ in range(2))
    pos = np.broadcast_to(np.arange(s), (b, s))
    ref_cache = {k: jnp.zeros((b, smax, nh, hd), jd) for k in ("k", "v")}
    ck, cv = (torch.zeros((b, smax, nh, hd), dtype=td) for _ in range(2))
    with torch.no_grad():
        out = transformer.shared_block_apply(
            mod, cfg, _t(x, td), _t(emb0, td), torch.from_numpy(pos.copy()),
            cache=(ck, cv), cache_index=0)
    want, ref_cache = ref_transformer.shared_block_apply(
        p, ref_cfg, jnp.asarray(x, jd), jnp.asarray(emb0, jd),
        jnp.asarray(pos), cache=ref_cache, cache_index=jnp.asarray(0))
    _close(out, want, dtype)
    _close(ck, ref_cache["k"], dtype)

    ages = np.array([s, 4], np.int32)
    x1, e1 = (rng.normal(0, 1.0, (b, 1, cfg.d_model)) for _ in range(2))
    with torch.no_grad():
        out = transformer.shared_block_apply(
            mod, cfg, _t(x1, td), _t(e1, td), torch.from_numpy(ages[:, None]
                                                               + 0),
            cache=(ck, cv), cache_index=torch.from_numpy(ages))
    want, ref_cache = ref_transformer.shared_block_apply(
        p, ref_cfg, jnp.asarray(x1, jd), jnp.asarray(e1, jd),
        jnp.asarray(ages[:, None]), cache=ref_cache,
        cache_index=jnp.asarray(ages))
    _close(out, want, dtype)
    _close(cv, ref_cache["v"], dtype)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _model_pair(arch: str, ref_impl: str):
    ref_cfg = ref_smoke_config(arch).scaled(attention_impl=ref_impl)
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg,
                                    dtype=jnp.float32)
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    model = model_params_from_reference(cfg, _tree_np(params), device="cpu")
    return ref_cfg, params, cfg, model


def _logits_close(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _ref_leaves(arch: str, ref_cache):
    """The reference cache's leaves under the port's names."""
    layers = ref_cache["layers"]
    if arch == "zamba2_2p7b":
        return {**layers["attn"], **layers["mamba"]}
    return dict(layers)


@pytest.mark.parametrize("ref_impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_logits_match_reference(arch, ref_impl):
    ref_cfg, params, cfg, model = _model_pair(arch, ref_impl)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    ref_cache = ref_models.init_cache(ref_cfg, 2, 64, dtype=jnp.float32)
    cache = init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    want_leaves = _ref_leaves(arch, ref_cache)
    assert set(cache) - {"index"} == set(want_leaves)
    for key, leaf in want_leaves.items():       # the reference's layouts
        assert tuple(cache[key].shape) == leaf.shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(leaf.dtype), key
    want, ref_cache = ref_models.prefill(
        params, ref_cfg, {"tokens": jnp.asarray(prompt)}, ref_cache)
    got, cache = prefill(model, torch.from_numpy(prompt).long(), cache)
    _logits_close(got, want)
    assert cache["index"] == int(ref_cache["index"]) == 37
    for key, leaf in _ref_leaves(arch, ref_cache).items():
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(leaf),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # a uniform step, then a ragged one at per-row ages
    for lengths in (None, np.array([38, 30], np.int32)):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, ref_cache = ref_models.decode_step(
            params, ref_cfg, jnp.asarray(tok), ref_cache,
            None if lengths is None else jnp.asarray(lengths))
        got, cache = decode_step(
            model, torch.from_numpy(tok).long(), cache,
            None if lengths is None else torch.from_numpy(lengths))
        _logits_close(got, want)
        assert cache["index"] == int(ref_cache["index"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_slot_view_writes_into_the_arena(arch):
    """A prefill through ``cache_slot_view`` lands in that slot's rows of
    every leaf and nowhere else."""
    _, _, cfg, model = _model_pair(arch, "reference")
    cache = init_cache(cfg, 3, 32, dtype=torch.float32, device="cpu")
    prompt = torch.arange(5)[None] % cfg.vocab_size
    prefill(model, prompt, cache_slot_view(cache, 1))
    for key, leaf in cache.items():
        if key == "index":
            continue
        axis = leaf.dim() - 1 - transformer._CACHE_TRAILING[key]
        rows = [leaf.select(axis, i) for i in range(3)]
        assert rows[1].abs().sum() > 0, key
        assert not rows[0].any() and not rows[2].any(), key


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

#: prompts of the engine tests: one token, shorter than, across and
#: beyond the smoke chunk of 16
PROMPT_LENS = (1, 9, 16, 23, 40)
MAX_TOKENS = 6


def _prompts(vocab: int, lens=PROMPT_LENS, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)) for n in lens]


def _serve(engine, request_cls, prompts):
    for i, pr in enumerate(prompts):
        engine.submit(request_cls(f"r{i}", pr, max_tokens=MAX_TOKENS,
                                  arrival_s=0.0))
    for _ in range(60):
        engine.admit()
        if engine.step() == 0 and not engine.queue:
            break
    return [engine.requests[f"r{i}"].output for i in range(len(prompts))]


@pytest.mark.parametrize("ref_impl", ["pallas", "reference"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_reference_engine(arch, ref_impl):
    """Every request gets a slot of its own (no slot is reused): the
    port's engine on its kernel route gives the reference engine's tokens,
    through the reference's Pallas kernel (interpret mode) and through its
    plain scan."""
    ref_cfg, params, cfg, _ = _model_pair(arch, ref_impl)
    n_slots = len(PROMPT_LENS)
    ref_eng = ref_serving.ServingEngine(ref_cfg, params, n_slots=n_slots,
                                        max_len=64)
    want = _serve(ref_eng, ref_serving.Request, _prompts(cfg.vocab_size))
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
    model = model_params_from_reference(cfg, _tree_np(params), device="cpu")
    eng = ServingEngine(cfg, model, n_slots=n_slots, max_len=64,
                        device="cpu")
    got = _serve(eng, Request, _prompts(cfg.vocab_size))
    assert got == want
    assert eng.metrics.completed == ref_eng.metrics.completed \
        == len(PROMPT_LENS)
    assert eng.metrics.decode_steps == ref_eng.metrics.decode_steps


def _ref_prefill_logits(ref_cfg, params, prompt, cache):
    logits, cache = ref_models.prefill(
        params, ref_cfg, {"tokens": jnp.asarray(prompt)[None]}, cache)
    return np.asarray(logits[0]), cache


@pytest.mark.parametrize("arch", FAMILIES)
def test_reused_slot_serves_like_a_fresh_one(arch):
    """One slot serves three requests in turn (the third a one-token
    prompt); each gets the tokens and first logits it gets alone in a fresh
    engine, and those first logits are the reference's prefill from a fresh
    cache. The reference's prefill from the cache the first request left
    differs (its conv state carries over)."""
    ref_cfg, params, cfg, model = _model_pair(arch, "reference")
    prompts = _prompts(cfg.vocab_size, lens=(23, 9, 1), seed=1)
    first = {}

    def run(eng, prs):
        orig = transformer.prefill

        def spy(*args, **kwargs):
            logits, cache = orig(*args, **kwargs)
            first[len(first)] = logits[0].clone()
            return logits, cache
        from repro_torch.serving import engine as engine_mod
        engine_mod.prefill = spy
        try:
            return _serve(eng, Request, prs)
        finally:
            engine_mod.prefill = orig

    shared = ServingEngine(cfg, model, n_slots=1, max_len=64, device="cpu")
    reused = run(shared, prompts)
    reused_logits = dict(first)
    for i, pr in enumerate(prompts):
        first.clear()
        alone = run(ServingEngine(cfg, model, n_slots=1, max_len=64,
                                  device="cpu"), [pr])
        assert alone[0] == reused[i], f"request {i}"
        assert torch.equal(first[0], reused_logits[i])
        want, _ = _ref_prefill_logits(
            ref_cfg, params, pr,
            ref_models.init_cache(ref_cfg, 1, 64, dtype=jnp.float32))
        _logits_close(first[0], want)
    # the reference's reused slot: the cache after the first prompt
    _, used = _ref_prefill_logits(
        ref_cfg, params, prompts[0],
        ref_models.init_cache(ref_cfg, 1, 64, dtype=jnp.float32))
    used["index"] = jnp.asarray(0, jnp.int32)
    leaked, _ = _ref_prefill_logits(ref_cfg, params, prompts[1], used)
    fresh, _ = _ref_prefill_logits(
        ref_cfg, params, prompts[1],
        ref_models.init_cache(ref_cfg, 1, 64, dtype=jnp.float32))
    assert np.abs(leaked - fresh).max() > 1e-4


def test_serve_cli_runs_mamba2_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--arch", "mamba2-1.3b", "--device", "cpu", "--requests", "4",
         "--slots", "2", "--prompt-len", "20", "--max-tokens", "4"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "completed=4" in proc.stdout
