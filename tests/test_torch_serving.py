"""The port's serving slice against the reference's.

* The whole slice: the port's ``ServingEngine(device="cpu")`` on the
  reference's 5-request ragged workload (``tests/test_serving.py``) gives
  the reference engine's outputs token for token, both against the
  reference's Pallas decode kernel (interpret mode) and against its plain
  attention, with the reference's parameters carried across; and the
  port's continuous batching equals its own one-request-at-a-time decoding
  (the reference's own bar).
* Autoscaling: ``ServingCluster.step``, ``capacity_rps`` and
  ``ServingExecutor.profile`` equal the reference's at 1e-12 from the same
  ``ReplicaProfile`` and seed.
* The entry points on the CPU: ``calibrate``, ``run_engine`` and a short
  ``run_autoscaled`` with a fixed profile.
"""
import dataclasses
import math
import types

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
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.config_space import tpu_serving_space  # noqa: E402
from repro_torch.interop import (model_config_from_dict,  # noqa: E402
                                 model_params_from_reference)
from repro_torch.launch.serve import run_autoscaled, run_engine  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_params, prefill)
from repro_torch.serving import (ClusterModelParams,  # noqa: E402
                                 ReplicaProfile, Request, ServingCluster,
                                 ServingEngine, ServingExecutor, calibrate)

DENSE = ["qwen2_7b", "gemma_7b", "mistral_nemo_12b", "deepseek_7b"]
#: the reference's ragged workload (tests/test_serving.py)
PROMPT_LENS = (8, 12, 16, 9, 11)
N_SLOTS, MAX_LEN, MAX_TOKENS = 3, 96, 6
PROFILE = ReplicaProfile(decode_step_s=0.02, prefill_s=0.05, base_slots=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor operations run fastest on one thread; several test
    workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)) for n in PROMPT_LENS]


def _serve(engine, request_cls, prompts):
    for i, pr in enumerate(prompts):
        engine.submit(request_cls(f"r{i}", pr, max_tokens=MAX_TOKENS,
                                  arrival_s=0.0))
    for _ in range(40):
        engine.admit()
        if engine.step() == 0 and not engine.queue:
            break
    return [engine.requests[f"r{i}"].output for i in range(len(prompts))]


@pytest.mark.parametrize("ref_impl", ["pallas", "reference"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "mistral_nemo_12b"])
def test_engine_matches_reference_engine(arch, ref_impl):
    """The port's engine on its kernel route (the plain decode attention on
    the CPU) against the reference's engine through its Pallas kernel in
    interpret mode and through its plain attention."""
    ref_cfg = ref_smoke_config(arch).scaled(attention_impl=ref_impl)
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg,
                                    dtype=jnp.float32)
    ref_eng = ref_serving.ServingEngine(ref_cfg, params, n_slots=N_SLOTS,
                                        max_len=MAX_LEN)
    want = _serve(ref_eng, ref_serving.Request, _prompts(ref_cfg.vocab_size))

    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    assert cfg.attention_impl == ("kernel" if ref_impl == "pallas"
                                  else "reference")
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
    model = model_params_from_reference(cfg, jax.tree.map(np.asarray,
                                                           params),
                                         device="cpu")
    eng = ServingEngine(cfg, model, n_slots=N_SLOTS, max_len=MAX_LEN,
                        device="cpu")
    got = _serve(eng, Request, _prompts(cfg.vocab_size))
    assert got == want
    assert eng.metrics.completed == ref_eng.metrics.completed \
        == len(PROMPT_LENS)
    assert eng.metrics.decode_steps == ref_eng.metrics.decode_steps


@pytest.mark.parametrize("arch", DENSE)
def test_continuous_batching_matches_sequential(arch):
    """Ragged engine decoding == one-request-at-a-time decoding."""
    cfg = smoke_config(arch)
    model = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    eng = ServingEngine(cfg, model, n_slots=N_SLOTS, max_len=MAX_LEN,
                        device="cpu")
    prompts = _prompts(cfg.vocab_size)
    outputs = _serve(eng, Request, prompts)
    assert eng.metrics.completed == len(prompts)
    for i, pr in enumerate(prompts):
        cache = init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                           device="cpu")
        lg, cache = prefill(model, torch.as_tensor(pr)[None], cache)
        toks = [int(torch.argmax(lg[0]))]
        for _ in range(MAX_TOKENS - 1):
            lg, cache = decode_step(model, torch.tensor([[toks[-1]]]), cache)
            toks.append(int(torch.argmax(lg[0])))
        assert toks == outputs[i], f"{arch} req {i}"


def test_engine_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = init_params(smoke_config("qwen2_7b"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model.cfg, model, n_slots=2, max_len=32)


# ---------------------------------------------------------------------------
# autoscaling against the reference
# ---------------------------------------------------------------------------

def _clusters():
    ref = ref_serving.ServingCluster(
        ref_serving.ReplicaProfile(**dataclasses.asdict(PROFILE)),
        ref_serving.ClusterModelParams(), seed=3)
    ours = ServingCluster(PROFILE, ClusterModelParams(), seed=3)
    return ref, ours


def test_cluster_step_and_capacity_match_reference():
    ref, ours = _clusters()
    configs = [dict(c) for c in tpu_serving_space().enumerate()[::97]]
    for c in configs:
        np.testing.assert_allclose(ours.capacity_rps(c), ref.capacity_rps(c),
                                   rtol=1e-12)
    rng = np.random.default_rng(7)
    for i in range(200):
        rate = float(rng.uniform(0.5, 2.0) * ref.capacity_rps())
        if i == 50:
            ref.inject_failure()
            ours.inject_failure()
        if i == 120:
            ref.reconfigure(configs[3])
            ours.reconfigure(configs[3])
        a, b = ours.step(rate, 5.0), ref.step(rate, 5.0)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12)
        assert ours.caught_up == ref.caught_up


def test_executor_profile_matches_reference():
    ref, ours = _clusters()
    ref_ex = ref_serving.ServingExecutor(ref)
    ex = ServingExecutor(ours)
    configs = [dict(c) for c in tpu_serving_space().enumerate()[5::311]]
    for rate in (2.0, 9.0):
        a, b = ex.profile(configs, rate), ref_ex.profile(configs, rate)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_allclose(x[k], y[k], rtol=1e-12)
    for c in configs:
        assert ex.allocated_cost(c) == ref_ex.allocated_cost(c)
    for _ in range(30):
        ex.step(4.0)
        ref_ex.step(4.0)
    assert ex.observe() == pytest.approx(ref_ex.observe(), rel=1e-12)


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_calibrate_times_real_steps():
    p = calibrate(smoke_config("qwen2_7b"), n_slots=2, prompt_len=8,
                  steps=2, device="cpu")
    assert p.base_slots == 2
    assert 0 < p.decode_step_s < 10 and 0 < p.prefill_s < 10


def test_run_engine_serves_every_request():
    args = types.SimpleNamespace(requests=5, rate=1000.0, prompt_len=8,
                                 max_tokens=4, slots=2)
    t = run_engine(smoke_config("gemma_7b"), args, device="cpu")
    assert t["completed"] == 5 and t["queue_depth"] == 0
    assert math.isfinite(t["p95_latency_s"])


def test_run_autoscaled_reconfigures_the_fleet():
    """Demeter in charge of a simulated fleet for 20 minutes from a fixed
    replica profile: it reconfigures, and ends on a config of the space
    with finite telemetry."""
    args = types.SimpleNamespace(rate=8.0, duration_s=1200.0)
    out = run_autoscaled(smoke_config("qwen2_7b"), args, device="cpu",
                         profile=PROFILE)
    assert out["reconfigurations"] >= 1
    tpu_serving_space().index(out["final_config"])   # raises if outside
    assert all(math.isfinite(v) for v in out["final_telemetry"].values())
    assert out["controller"].store.all_observations()    # profiled configs
