"""The port's collectives, elastic re-placement and sharded training on 4
gloo ranks on the CPU, against the reference's.

One ``torch.multiprocessing.spawn`` of 4 ranks runs every case in one
worker (``tests/helpers/collectives_worker.py``); the reference's
collectives run in a process of their own with 4 forced host devices
(``tests/helpers/collectives_reference.py``) and hand over their inputs
and outputs as ``.npz``. The tests below read the ranks' results:

* ``ring_allreduce`` over (data=4), on buffers of 15 values (padded to 4
  chunks) and 64: bit-equal to the reference's ring, device by device;
* ``hierarchical_allreduce`` over (pod=2, data=2), each rank a buffer of
  its own: bit-equal to the reference's (two sums of two);
* ``surviving_mesh``'s ranks and axes equal the reference's device ids
  and axis names;
* ``rescale`` onto a (data=2, model=2) mesh: every parameter placed by
  ``param_shardings``, its global value unchanged;
* deepseek-7b's smoke ``train_loss`` in float32 on that mesh within rtol
  1e-5 of the unsharded port, and one AdamW step within 1e-4 of each
  parameter's scale; the loss of one smoke config of every other family
  (both MoE configs) within rtol 1e-5 too;
* the gradients of the regions' parameters on that mesh (the embedding
  table, ``wq``, an expert weight, the router and an earlier layer's
  ``wq`` of a MoE config, MLA's ``wuk`` and ``wuv``, mamba2's ``in_x``;
  ``wq`` and ``wk`` with one KV head, which replicates while the query
  heads could shard)
  within ``GRAD_BAR`` of each gradient's scale of the unsharded ones;
* ``ElasticTrainer(mesh=(pod=2, data=2))``: a failure after a checkpoint,
  the restore onto ``surviving_mesh``, the replay equal to the first pass
  (within ``REPLAY_RTOL``: the replay runs on half the ranks, so its batch
  mean adds the ranks' partial sums in another order) and ranks 2-3, off
  the surviving mesh, leaving the loop.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

HELPERS = Path(__file__).parent / "helpers"
SRC = Path(__file__).parent.parent / "src"
WORLD = 4

#: the replay runs over 2 ranks instead of 4: float32 rounding of the mean
REPLAY_RTOL = 1e-6
#: sharded gradients against the unsharded: float32 partial sums added in
#: another order across the ranks
GRAD_BAR = 1e-5


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(HELPERS / "collectives_reference.py"),
                    str(out)], env=env, check=True, timeout=300)
    return out


@pytest.fixture(scope="module")
def ref(reference):
    return np.load(reference)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Each rank's results from the one spawn."""
    import torch.multiprocessing as mp

    sys.path.insert(0, str(HELPERS))
    import collectives_worker
    out = tmp_path_factory.mktemp("ranks")
    init = tempfile.mktemp(dir=out)
    mp.spawn(collectives_worker.run,
             args=(WORLD, init, str(reference), str(out)),
             nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("case", ["ring_odd", "ring_even"])
def test_ring_allreduce_bit_equal_to_the_references(ranks, ref, case):
    for r, res in enumerate(ranks):
        assert np.array_equal(res[case], ref[case + "_out"][r]), r
    # and it is the sum (NumPy adds in another order: float32 rounding)
    np.testing.assert_allclose(ranks[0][case],
                               ref[case + "_in"].sum(0), rtol=1e-5,
                               atol=1e-6)


def test_hierarchical_allreduce_equal_to_the_references(ranks, ref):
    for r, res in enumerate(ranks):
        assert np.array_equal(res["hier"], ref["hier_out"][r]), r


def test_surviving_mesh_equal_to_the_references(ranks, ref):
    for r, res in enumerate(ranks):
        assert res["surviving_ranks"] == ref["surviving_ids"].tolist()
        assert res["surviving_axes"] == ref["surviving_axes"].tolist()
        assert res["on_surviving"] == (r in res["surviving_ranks"])


def test_rescale_onto_a_mesh(ranks):
    for res in ranks:
        assert res["rescale_placements_equal"]
        assert res["rescale_values_equal"]
        # the rules shard the projections and the embedding, not the norms
        assert "embed.table" in res["rescale_sharded"]
        assert "blocks.0.mixer.wq.w" in res["rescale_sharded"]
        assert "final_norm.scale" not in res["rescale_sharded"]


def test_sharded_train_loss_equals_the_unsharded(ranks):
    for res in ranks:
        assert res["loss_sharded_is_dtensor"]
        assert res["loss_sharded"] == pytest.approx(res["loss_plain"],
                                                    rel=1e-5)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "mamba2_1p3b", "zamba2_2p7b",
                                  "hubert_xlarge", "pixtral_12b"])
def test_every_familys_sharded_loss_equals_the_unsharded(ranks, arch):
    for res in ranks:
        got, want = res["family_losses"][arch]
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("case", ["deepseek_7b", "deepseek_moe_16b",
                                  "deepseek_v2_lite_16b", "mamba2_1p3b",
                                  "gqa_kv_heads_1"])
def test_sharded_gradients_equal_the_unsharded(ranks, case):
    for res in ranks:
        got = res["grads"][case]
        assert got["losses"][0] == pytest.approx(got["losses"][1], rel=1e-5)
        for name, err in got["err_of_scale"].items():
            assert err < GRAD_BAR, (name, err)


def test_sharded_adamw_step_equals_the_unsharded(ranks):
    for res in ranks:
        assert res["adamw_err_of_scale"] < 1e-4


def test_elastic_trainer_restores_onto_the_surviving_mesh(ranks):
    survivors = ranks[0]["surviving_ranks"]
    for r, res in enumerate(ranks):
        events = res["trainer_events"]
        first = dict(events[:3])
        assert [s for s, _ in events[:3]] == [0, 1, 2]
        if r in survivors:
            assert res["trainer_active"] and res["trainer_mesh"] == ["data"]
            # restored at the checkpoint of step 2: replays 2, then 3
            assert [s for s, _ in events[3:]] == [2, 3]
            assert events[3][1] == pytest.approx(first[2], rel=REPLAY_RTOL)
            assert all(np.isfinite(loss) for _, loss in events)
        else:
            assert not res["trainer_active"] and len(events) == 3
    # every surviving rank saw the same losses
    assert ranks[survivors[0]]["trainer_events"] \
        == ranks[survivors[-1]]["trainer_events"]
