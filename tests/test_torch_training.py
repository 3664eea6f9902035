"""The port's training slice against the reference's.

The reference's ``tests/test_training.py``, each case held against the
reference on the CPU: the same seeded NumPy inputs (and the reference's
parameters and train state, carried across by
``repro_torch.interop.model_params_from_reference`` and
``train_state_from_reference``) go through both packages.

* ``schedule`` and ``adamw_update`` at 1e-6 relative (float32);
* one train step of each family's smoke config (dense, moe with its aux
  and z losses, ssm, hybrid, vlm with patches, encoder with frames and a
  ``loss_mask``): loss and grad norm at 1e-5 relative, the updated
  parameters and moments within ``STEP_BAR`` of each tensor's scale;
* accumulation against the full batch, and against the reference's;
* compression: equal int8 codes and scales, the restored gradients and
  error feedback bit for bit and the optimizer after them, error feedback
  unbiased over steps, the wire ratio; a compressed, accumulated step,
  quantized over the reference's layer-stacked leaves;
* checkpoints: a bf16 round trip, GC keeps the newest, the port's files
  read back by the reference and the reference's by the port;
* ``ElasticTrainer``: failure, restore and replay bit for bit, and the same
  step losses as the reference's trainer from the same parameters;
* the pipeline: the reference's batches bit for bit per step, host shards
  disjoint, tokens in the vocabulary; the launcher on the CPU.
"""
import dataclasses
import shutil
import tempfile

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

from helpers import int8_ties  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro import training as ref_training  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed import compression as ref_compression  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed import compression, rescale  # noqa: E402
from repro_torch.interop import (model_config_from_dict,  # noqa: E402
                                 model_params_from_reference,
                                 train_state_from_reference)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

#: one smoke config of each family the reference trains
FAMILIES = {"dense": "deepseek_7b", "moe": "deepseek_moe_16b",
            "ssm": "mamba2_1p3b", "hybrid": "zamba2_2p7b",
            "vlm": "pixtral_12b", "encoder": "hubert_xlarge"}
#: the updated parameters and moments after one step, over each tensor's
#: largest magnitude. The two packages' float32 gradients differ in the
#: last bits; the step runs at Adam eps 1e-3 (not 1e-8), where the update
#: g / (|g| + eps) is well conditioned for every entry: at eps 1e-8 an entry
#: whose gradient is a few ulps of its terms moves by a fraction of the
#: learning rate that those last bits decide (up to 4e-4 of scale here).
#: Measured: at most 8.7e-6 (mamba2's convolution biases, zero at init).
STEP_BAR = 2e-5
STEP_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100, eps=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models are many tiny tensor operations, which run fastest
    on one thread; several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_dir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch: str):
    """The reference's float32 smoke config and parameters of ``arch``, and
    the port's config (the plain attention route) and model holding
    them."""
    ref_cfg = ref_smoke_config(arch).scaled(dtype="float32")
    params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg,
                                    dtype=jnp.float32)
    cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
    assert cfg.attention_impl == "reference"
    return ref_cfg, params, cfg


def _ref_batch(ref_cfg, seed=5, batch=4, seq=16):
    return ref_training.make_pipeline(
        ref_cfg, ref_training.DataConfig(batch_per_host=batch, seq_len=seq,
                                         seed=seed)).batch(0)


def _scale_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _one_step(arch: str, tc_kw: dict, opt_kw: dict):
    """One train step of both packages from the reference's parameters
    and state: the port's model and metrics, the reference's updated
    parameters carried across, and both new states (port names)."""
    ref_cfg, params, cfg = _pair(arch)
    batch = _ref_batch(ref_cfg)
    rtc = ref_training.TrainConfig(
        optimizer=ref_training.OptimizerConfig(**opt_kw), **tc_kw)
    rstate = ref_training.init_train_state(params, rtc)
    rp, rs, rm = jax.jit(ref_training.make_train_step(ref_cfg, rtc))(
        params, rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tc = training.TrainConfig(
        optimizer=training.OptimizerConfig(**opt_kw), **tc_kw)
    model = model_params_from_reference(cfg, _np(params), device="cpu")
    state = train_state_from_reference(model, _np(rstate))
    model, state, metrics = training.make_train_step(cfg, tc)(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = model_params_from_reference(cfg, _np(rp), device="cpu")
    return model, metrics, state, want, \
        train_state_from_reference(want, _np(rs)), rm


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    oc = training.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    roc = ref_training.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                       total_steps=100)
    steps = (0, 1, 5, 10, 11, 50, 99, 100, 250)
    got = [float(training.schedule(oc, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(ref_training.schedule(roc, jnp.asarray(s, jnp.int32)))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the reference test's shape: warmup to the peak, then decay
    assert got[1] < got[3] == pytest.approx(1e-3, rel=1e-6)
    assert got[5] < got[3] and got[7] < got[5]


def test_adamw_update_matches_reference(rng):
    """Three steps over a matrix (decayed), a vector (not) and a bf16
    matrix, with clipping active: parameters, moments and metrics."""
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    shapes = {"a": ((6, 5), np.float32), "b": ((7,), np.float32),
              "c": ((4, 3), jnp.bfloat16)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, (s, _) in shapes.items()}
    rparams = {k: jnp.asarray(v, shapes[k][1]) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v).to(
        torch.bfloat16 if shapes[k][1] is jnp.bfloat16 else torch.float32)
        for k, v in params.items()}
    rstate = ref_training.adamw_init(rparams)
    tstate = training.adamw_init(tparams)
    for _ in range(3):
        grads = {k: rng.normal(0, 1, shapes[k][0]).astype(np.float32)
                 for k in shapes}
        rparams, rstate, rm = ref_training.adamw_update(
            ref_training.OptimizerConfig(**oc),
            {k: jnp.asarray(v, rparams[k].dtype) for k, v in grads.items()},
            rstate, rparams)
        tparams, tstate, tm = training.adamw_update(
            training.OptimizerConfig(**oc),
            {k: torch.from_numpy(v).to(tparams[k].dtype)
             for k, v in grads.items()}, tstate, tparams)
        for k in shapes:
            np.testing.assert_allclose(
                tparams[k].float().numpy(),
                np.asarray(rparams[k], np.float32), rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(tstate[mom][k].numpy(),
                                           np.asarray(rstate[mom][k]),
                                           rtol=1e-6, atol=1e-9)
        assert int(tstate["step"]) == int(rstate["step"])
        assert tstate["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(rm[key]), rel=1e-6)
    assert float(tm["grad_norm"]) > oc["grad_clip"]     # clipping was on


def test_adamw_minimizes_quadratic_and_clips():
    """The reference's two optimizer cases, on the port."""
    params = {"w": torch.tensor([3.0, -2.0])}
    oc = training.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                                  weight_decay=0.0)
    state = training.adamw_init(params)
    for _ in range(200):
        params, state, _ = training.adamw_update(
            oc, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state["step"]) == 200
    oc = training.OptimizerConfig(lr=1.0, warmup_steps=0, grad_clip=1.0,
                                  weight_decay=0.0)
    _, _, metrics = training.adamw_update(
        oc, {"w": torch.full((4,), 1e6)}, training.adamw_init(
            {"w": torch.zeros(4)}), {"w": torch.zeros(4)})
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


# ---------------------------------------------------------------------------
# one train step per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    model, metrics, state, want, wstate, rm = _one_step(
        FAMILIES[family], {}, STEP_OPT)
    assert float(metrics["loss"]) == pytest.approx(float(rm["loss"]),
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(rm["grad_norm"]), rel=1e-5)
    assert float(metrics["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert float(metrics["grad_norm"]) > 0.0
    wd = dict(want.named_parameters())
    for name, p in model.named_parameters():
        assert _scale_err(p.detach(), wd[name].detach()) < STEP_BAR, name
        for mom in ("m", "v"):
            assert _scale_err(state["opt"][mom][name],
                              wstate["opt"][mom][name]) < STEP_BAR, \
                (mom, name)
    assert int(state["opt"]["step"]) == 1


def test_kernel_route_does_not_train():
    cfg = smoke_config("deepseek_7b")
    assert cfg.attention_impl == "kernel"
    with pytest.raises(ValueError, match="attention_impl='reference'"):
        training.make_train_step(cfg, training.TrainConfig())


# ---------------------------------------------------------------------------
# accumulation and compression
# ---------------------------------------------------------------------------

def test_grad_accumulation_matches_full_batch_and_reference():
    """The reference's case on the port (accumulating 4 microbatches gives
    the full batch's step), then 2 microbatches against the reference."""
    cfg = smoke_config("deepseek_7b").scaled(attention_impl="reference",
                                             dtype="float32")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, 255, (8, 16)))
             for k in ("tokens", "labels")}
    oc = training.OptimizerConfig(lr=1e-3, warmup_steps=0)
    out = {}
    for accum in (1, 4):
        model = init_params(cfg, seed=0, device="cpu")
        tc = training.TrainConfig(optimizer=oc, accum_steps=accum)
        model, _, m = training.make_train_step(cfg, tc)(
            model, training.init_train_state(model, tc), batch)
        out[accum] = (float(m["loss"]), model)
    assert out[1][0] == pytest.approx(out[4][0], rel=1e-4)
    for a, b in zip(out[1][1].parameters(), out[4][1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-4)
    model, metrics, state, want, wstate, rm = _one_step(
        "deepseek_7b", {"accum_steps": 2}, STEP_OPT)
    assert float(metrics["loss"]) == pytest.approx(float(rm["loss"]),
                                                   rel=1e-5)
    wd = dict(want.named_parameters())
    for name, p in model.named_parameters():
        assert _scale_err(p.detach(), wd[name].detach()) < STEP_BAR, name


def test_int8_codes_and_scales_match_reference(rng):
    for shape in ((300,), (17, 40), (256,), (3, 5, 7)):
        g = (rng.normal(0, 1e-2, shape)
             * rng.choice([1.0, 1e-3], shape)).astype(np.float32)
        q, s = compression._quantize_leaf(torch.from_numpy(g))
        rq, rs = ref_compression._quantize_leaf(jnp.asarray(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    # ties round half to even in both packages
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5] + [0.0] * 250,
                 np.float32)
    q, _ = compression._quantize_leaf(torch.from_numpy(g))
    rq, _ = ref_compression._quantize_leaf(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q[0, 1:6].tolist() == [0, 2, 2, -2, 0]


def test_compression_then_adamw_match_reference_bit_for_bit(rng):
    """On the same gradients and error feedback: the restored gradients
    and the new buffers bit for bit, then AdamW at 1e-6."""
    shapes = {"w": (40, 30), "b": (30,), "e": (5, 3, 7)}
    grads = {k: rng.normal(0, 1e-2, s).astype(np.float32)
             for k, s in shapes.items()}
    ef = {k: rng.normal(0, 1e-5, s).astype(np.float32)
          for k, s in shapes.items()}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    restored, new_ef = compression.compress_decompress(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in ef.items()})
    rrestored, rnew_ef = ref_compression.compress_decompress(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in ef.items()})
    for k in shapes:
        np.testing.assert_array_equal(restored[k].numpy(),
                                      np.asarray(rrestored[k]))
        np.testing.assert_array_equal(new_ef[k].numpy(),
                                      np.asarray(rnew_ef[k]))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    oc = dict(lr=1e-3, warmup_steps=0)
    new_p, _, _ = training.adamw_update(
        training.OptimizerConfig(**oc), restored, training.adamw_init(tp), tp)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _, _ = ref_training.adamw_update(
        ref_training.OptimizerConfig(**oc), rrestored,
        ref_training.adamw_init(rp), rp)
    for k in shapes:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_compressed_accumulated_step_matches_reference():
    """The whole step with compression on, its blocks laid over the
    reference's layer-stacked leaves: loss and the restored gradients'
    norm as the reference's, and the error feedback and parameters as the
    reference's but where a gradient within float32 rounding of a tie of
    its int8 code took the neighbouring code in one package: there the
    residual differs by exactly one quantum and the parameter by at most
    2 lr (``helpers.int8_ties``; 1 to 3 elements in 72 000-115 000 on the
    smoke configs)."""
    with int8_ties.compression_inputs() as calls:
        model, metrics, state, want, wstate, rm = _one_step(
            "deepseek_7b", {"accum_steps": 2, "compress_grads": True},
            STEP_OPT)
    assert float(metrics["loss"]) == pytest.approx(float(rm["loss"]),
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(rm["grad_norm"]), rel=1e-5)
    assert set(state) == {"opt", "ef"} and len(calls) == 1
    assert all(e.dtype == torch.float32 for e in state["ef"].values())
    params = dict(model.named_parameters())
    parted = int8_ties.assert_only_ties_part(
        calls[0], state["ef"], wstate["ef"], params,
        dict(want.named_parameters()), lr=float(metrics["lr"]),
        bar=STEP_BAR, names=list(params))
    assert parted <= 1e-4 * sum(p.numel() for p in params.values()), parted


def test_error_feedback_is_unbiased_over_time(rng):
    g = rng.normal(0, 1e-3, (256,)).astype(np.float32)
    grads = {"g": torch.from_numpy(g)}
    ef = compression.ef_init(grads)
    applied = np.zeros(256)
    for _ in range(50):
        restored, ef = compression.compress_decompress(grads, ef)
        applied += restored["g"].numpy()
    assert np.abs(applied - 50 * g).max() < 2.0 * np.abs(g).max() / 127.0
    # the reference test's single round trip, half a quantum at most
    g = rng.normal(0, 1e-2, (300,)).astype(np.float32)
    restored, _ = compression.compress_decompress(
        {"a": torch.from_numpy(g)},
        compression.ef_init({"a": torch.from_numpy(g)}))
    assert np.abs(restored["a"].numpy() - g).max() \
        <= np.abs(g).max() / 127.0 * 0.51 + 1e-9


def test_wire_ratio_matches_reference():
    assert compression.compression_ratio() \
        == ref_compression.compression_ratio() < 0.27


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(
        np.float32)).to(torch.bfloat16),
        "m": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)),
        "nested": {"step": torch.tensor(7, dtype=torch.int32),
                   "b": torch.arange(5, dtype=torch.int64)}}


def test_checkpoint_roundtrip_bf16(rng, tmp_dir):
    mgr = training.CheckpointManager(tmp_dir)
    tree = _tree(rng)
    mgr.save(7, tree, blocking=True)
    assert mgr.in_flight == 0
    step, back = mgr.restore(like=tree)
    assert step == 7 and list(back) == list(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # onto another device: rescale, and numpy `like` leaves on the CPU
    moved = rescale(back, "cpu")
    assert torch.equal(moved["w"], tree["w"])
    _, again = mgr.restore(7, like=jax.tree.map(lambda t: t.numpy()
                                                if t.dtype != torch.bfloat16
                                                else 0, tree), device="cpu")
    assert torch.equal(again["w"], tree["w"])


def test_checkpoint_gc_keeps_newest(tmp_dir):
    mgr = training.CheckpointManager(tmp_dir, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.zeros(4)}, blocking=True)
    assert mgr.list_steps() == [3, 4] and mgr.latest_step() == 4


def test_checkpoint_layout_is_the_references(rng, tmp_dir):
    """The port's checkpoint reads back through the reference's
    ``CheckpointManager`` (bf16 as raw bytes named in the manifest), and
    the reference's through the port's."""
    tree = _tree(rng)
    training.CheckpointManager(tmp_dir).save(3, tree, blocking=True)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                            if t.dtype == torch.bfloat16
                                            else t.numpy().dtype), tree)
    step, back = ref_training.CheckpointManager(tmp_dir).restore(like=like)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  tree["w"].float().numpy())
    assert np.asarray(back["w"]).dtype == jnp.bfloat16
    for k in ("m",):
        np.testing.assert_array_equal(np.asarray(back[k]), tree[k].numpy())
    assert int(back["nested"]["step"]) == 7
    np.testing.assert_array_equal(np.asarray(back["nested"]["b"]),
                                  np.arange(5))
    # and the other way
    ref_dir = tempfile.mkdtemp(dir=tmp_dir)
    ref_training.CheckpointManager(ref_dir).save(5, back, blocking=True)
    step, again = training.CheckpointManager(ref_dir).restore(like=tree)
    assert step == 5
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the elastic trainer and the launcher
# ---------------------------------------------------------------------------

def test_elastic_trainer_replays_bit_for_bit(tmp_dir):
    """The reference's failure case on the port, with compression and
    accumulation on: steps 0-9 with a checkpoint every 4, a failure, then
    4 steps that restore step 8 and replay; the replayed losses, and the
    parameters after the replayed step 9, equal the first pass's."""
    cfg = smoke_config("deepseek_7b").scaled(attention_impl="reference")
    tr = training.ElasticTrainer(
        cfg, training.TrainConfig(
            optimizer=training.OptimizerConfig(total_steps=50),
            accum_steps=2, compress_grads=True),
        training.DataConfig(batch_per_host=2, seq_len=16),
        training.FTConfig(checkpoint_dir=tmp_dir,
                          checkpoint_interval_steps=4), device="cpu")
    snap = {}
    tr.run(10, on_step=lambda ev: snap.setdefault(
        ev.step, [p.detach().clone() for p in tr.model.parameters()]))
    first = {e.step: e.loss for e in tr.events}
    assert tr.ckpt.list_steps() == [4, 8]
    tr.inject_failure()
    tr.run(4)
    assert tr.step == 12
    replay = [e for e in tr.events[10:]]
    assert [e.step for e in replay] == [8, 9, 10, 11]
    assert all(e.loss == first[e.step] for e in replay[:2])
    assert all(np.isfinite(e.loss) for e in tr.events)


def test_elastic_trainer_matches_reference_trainer(tmp_dir):
    """The reference's trainer and the port's from the same parameters
    (the reference's seed-0 draw, carried across): 6 steps with a
    checkpoint at step 4, a failure, then 3 steps replaying 4 and 5; every
    step event's loss at 1e-5 relative."""
    ref_cfg = ref_smoke_config("deepseek_7b").scaled(dtype="float32")
    kw = dict(batch_per_host=2, seq_len=16)
    oc = dict(total_steps=50, warmup_steps=2)
    events = {}
    for pkg in ("ref", "port"):
        d = tempfile.mkdtemp(dir=tmp_dir)
        if pkg == "ref":
            tr = ref_training.ElasticTrainer(
                ref_cfg, ref_training.TrainConfig(
                    optimizer=ref_training.OptimizerConfig(**oc)),
                ref_training.DataConfig(**kw),
                ref_training.FTConfig(checkpoint_dir=d,
                                      checkpoint_interval_steps=4))
        else:
            cfg = model_config_from_dict(dataclasses.asdict(ref_cfg))
            tr = training.ElasticTrainer(
                cfg, training.TrainConfig(
                    optimizer=training.OptimizerConfig(**oc)),
                training.DataConfig(**kw),
                training.FTConfig(checkpoint_dir=d,
                                  checkpoint_interval_steps=4),
                device="cpu")
            tr.model = model_params_from_reference(
                cfg, _np(ref_models.init_params(jax.random.PRNGKey(0),
                                                ref_cfg)), device="cpu")
            tr.state = training.init_train_state(tr.model, tr.tc)
        tr.run(6)
        tr.inject_failure()
        tr.run(3)
        events[pkg] = [(e.step, e.loss) for e in tr.events]
    assert [s for s, _ in events["port"]] == [s for s, _ in events["ref"]] \
        == [0, 1, 2, 3, 4, 5, 4, 5, 6]
    np.testing.assert_allclose([v for _, v in events["port"]],
                               [v for _, v in events["ref"]], rtol=1e-5)


def test_launch_train_runs_on_the_cpu(tmp_dir, capsys):
    launch_train.main(["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", tmp_dir, "--ckpt-interval", "2",
                       "--log-every", "1"])
    out = capsys.readouterr().out
    assert "attention_impl=reference" in out and "device=cpu" in out
    assert "[train] done: 3 steps" in out
    assert training.CheckpointManager(tmp_dir).list_steps() == [2]


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_7b", "hubert_xlarge",
                                  "pixtral_12b"])
def test_pipeline_draws_the_references_batches(arch):
    cfg, ref_cfg = smoke_config(arch), ref_smoke_config(arch)
    for n_hosts, host in ((1, 0), (2, 1)):
        kw = dict(batch_per_host=2, seq_len=16, seed=9, n_hosts=n_hosts,
                  host_index=host)
        port = training.make_pipeline(cfg, training.DataConfig(**kw))
        ref = ref_training.make_pipeline(ref_cfg,
                                         ref_training.DataConfig(**kw))
        for step in (0, 5, 1000):
            a, b = port.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    # deterministic per step, different across steps
    p1 = training.make_pipeline(cfg, training.DataConfig(2, 16, seed=9))
    p2 = training.make_pipeline(cfg, training.DataConfig(2, 16, seed=9))
    key = "frames" if "frames" in p1.batch(0) else "tokens"
    np.testing.assert_array_equal(p1.batch(5)[key], p2.batch(5)[key])
    assert not np.array_equal(p1.batch(5)[key], p1.batch(6)[key])


def test_pipeline_host_shards_are_disjoint_and_in_vocab(tmp_dir):
    cfg = smoke_config("deepseek_7b")
    a, b = (training.make_pipeline(cfg, training.DataConfig(
        batch_per_host=2, seq_len=16, n_hosts=2, host_index=h)).batch(0)
        for h in (0, 1))
    assert not np.array_equal(a["tokens"], b["tokens"])
    for step in range(0, 1000, 97):
        toks = training.make_pipeline(cfg, training.DataConfig(
            batch_per_host=1, seq_len=8)).batch(step)["tokens"]
        assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    # the file-backed source strides as the reference's
    path = f"{tmp_dir}/tokens.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    kw = dict(batch_per_host=2, seq_len=16, n_hosts=2, host_index=1,
              path=path)
    got = training.make_pipeline(cfg, training.DataConfig(**kw)).batch(3)
    want = ref_training.make_pipeline(
        ref_smoke_config("deepseek_7b"),
        ref_training.DataConfig(**kw)).batch(3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
