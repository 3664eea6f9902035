"""The plain reference against the port at a smoke size on the CPU, the fp8
control's readings, and the faults that must turn ``correct`` false."""
import json
import math

import numpy as np
import pytest
import torch

from chipbench import harness, system, weights
from chipbench.arch import deepseek as arch
from chipbench.reference import deepseek
from chipbench.tests.smoke_root import DATA, SMOKE, make_root

SEEDS = (11, 2 ** 31 + 17, 4_000_000_019)


def smoke_cfg(name):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


def program_logits(cfg, w, prompt, served):
    """The port's logits at each served position: a prefill of the prompt
    into one slot, then one decode step a served token."""
    from repro_torch.models import cache_slot_view, decode_step, prefill
    eng = system.build_engine(arch.model_config(cfg), w, slots=1,
                              max_len=len(prompt) + len(served),
                              device="cpu")
    logits, _ = prefill(eng.model, torch.as_tensor(prompt)[None],
                        cache_slot_view(eng.cache, 0))
    out = [logits[0]]
    for i, tok in enumerate(served[:-1]):
        logits, _ = decode_step(eng.model, torch.tensor([[tok]]), eng.cache,
                                torch.tensor([len(prompt) + i]))
        out.append(logits[0])
    return torch.stack(out)


@pytest.mark.parametrize("name", ["smoke-moe", "smoke-mla"])
def test_reference_follows_the_port_through_prefill_and_decode(name):
    cfg = smoke_cfg(name)
    w = weights.make(arch.spec(cfg), 7, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg["vocab_size"], 80).tolist()
    served = rng.integers(0, cfg["vocab_size"], 12).tolist()
    got = program_logits(cfg, w, prompt, served)
    want = deepseek.served_logits(cfg, w, [(prompt, served)], "cpu")[0]
    assert got.shape == want.shape == (12, cfg["vocab_size"])
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_prompt_capacity_drops_assignments_at_the_smoke_size():
    cfg = smoke_cfg("smoke-moe")
    torch.manual_seed(0)
    logits = torch.randn(80, cfg["n_routed_experts"]) * 3
    _, w = deepseek.route(cfg, logits, 80)
    cap = math.ceil(80 * 2 * 1.25 / 8)
    assert cap < 80 and int((w == 0).sum()) > 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("chipbench"))


@pytest.mark.parametrize("cell", sorted(SMOKE))
def test_fp8_control_fails_the_limit(root, cell):
    limit = harness.load_cell(root, cell).limits["mean_logit_gap"]
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 1.0, False, device="cpu",
                               root=root, control=True)
        assert out["sample"]["program_mean_logit_gap"] <= limit
        assert out["sample"]["mean_logit_gap"] > limit, seed
        assert out["result"]["correct"] is False, seed


def _roll_tokens(fn):
    """A token altered where it is produced: every decode step's logits
    turned by one place, so its greedy token is the next id."""
    def broken(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        return logits.roll(1, dims=-1), cache
    return broken


def _half_batch(fn):
    """Half of the batch left out: the second half of the rows gets the
    mean of the first half's logits."""
    def broken(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:half].mean(0)
        return logits, cache
    return broken


def _keep_state(fn):
    """A step that leaves its state unchanged: one-position cache writes
    (the decode steps') dropped."""
    def broken(buf, new, idx):
        if new.shape[1] != 1:
            fn(buf, new, idx)
    return broken


FAULTS = {
    "token_altered": [("repro_torch.serving.engine", "decode_step",
                       _roll_tokens)],
    "half_batch_left_out": [("repro_torch.serving.engine", "decode_step",
                             _half_batch)],
    "state_unchanged": [("repro_torch.models.attention", "cache_update",
                         _keep_state),
                        ("repro_torch.models.mla", "cache_update",
                         _keep_state)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SMOKE))
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    import importlib
    for mod_name, attr, breaker in FAULTS[fault]:
        mod = importlib.import_module(mod_name)
        monkeypatch.setattr(mod, attr, breaker(getattr(mod, attr)))
    out = harness.run_cell(cell, SEEDS[0], 0.5, False, device="cpu",
                           root=root)
    assert out["result"]["correct"] is False
    assert out["sample"]["mean_logit_gap"] > \
        harness.load_cell(root, cell).limits["mean_logit_gap"]
