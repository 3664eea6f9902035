"""One rank of the 4-rank gloo run behind ``tests/test_torch_collectives.py``.

Every case runs in this one worker function, so the run costs one spawn
of four processes. Rank ``r`` reads the reference's inputs from the
``.npz`` that ``collectives_reference.py`` wrote, runs:

* ``ring_allreduce`` over a (data=4) mesh on its buffer of each case;
* ``hierarchical_allreduce`` over a (pod=2, data=2) mesh;
* ``surviving_mesh`` of that mesh (its ranks, axes, and whether this rank
  is on it);
* ``rescale`` of a model's parameters onto a (data=2, model=2) mesh;
* deepseek-7b's smoke ``train_loss`` (float32, plain attention) with those
  DTensor parameters inside a sharding context, and one AdamW step, beside
  the same on an unsharded copy of the model;
* the same loss (forward only) for one smoke config of every other family,
  sharded on that mesh and unsharded;
* the loss's gradients on that mesh and unsharded (:data:`GRAD_CASES`):
  the embedding table and ``wq`` of deepseek-7b; an expert weight, the
  router and the first layer's ``wq`` of deepseek-moe-16b (whose gradient
  comes back through the MoE layer's partial sums); MLA's ``wuk`` and
  ``wuv`` and the router of deepseek-v2-lite; mamba2's ``in_x``; ``wq``
  and ``wk`` of deepseek-7b with one KV head (which cannot shard on
  ``model`` while its 4 query heads can);
* ``ElasticTrainer`` on the (pod=2, data=2) mesh: 3 steps with a
  checkpoint after 2, a failure, the restore onto ``surviving_mesh`` and 2
  more steps;

and writes its results to ``<out>/rank<r>.pt``.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

ARCH = "deepseek_7b"
BATCH, SEQ = 4, 16
#: one smoke config of each other family (moe twice: MLA and not)
FAMILIES = ("deepseek_moe_16b", "deepseek_v2_lite_16b", "mamba2_1p3b",
            "zamba2_2p7b", "hubert_xlarge", "pixtral_12b")
#: case -> (smoke config, its overrides, the parameters whose gradients
#: are compared)
GRAD_CASES = {
    "deepseek_7b": ("deepseek_7b", {}, ("embed.table",
                                        "blocks.0.mixer.wq.w")),
    "deepseek_moe_16b": ("deepseek_moe_16b", {},
                         ("blocks.1.ffn.experts.up.w",
                          "blocks.1.ffn.router.w", "blocks.0.mixer.wq.w")),
    "deepseek_v2_lite_16b": ("deepseek_v2_lite_16b", {},
                             ("blocks.0.mixer.wuk.w", "blocks.0.mixer.wuv.w",
                              "blocks.1.ffn.router.w")),
    "mamba2_1p3b": ("mamba2_1p3b", {}, ("blocks.0.mixer.in_x.w",)),
    "gqa_kv_heads_1": ("deepseek_7b", {"n_kv_heads": 1},
                       ("blocks.0.mixer.wq.w", "blocks.0.mixer.wk.w")),
}


def run(rank: int, world: int, init_file: str, ref_npz: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        torch.save(_cases(rank, np.load(ref_npz), out_dir),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cases(rank: int, ref, out_dir: str) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import smoke_config
    from repro_torch.distributed import (hierarchical_allreduce,
                                         param_shardings, rescale,
                                         ring_allreduce, set_parameters,
                                         sharding_context, surviving_mesh)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, train_loss
    from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                      OptimizerConfig, TrainConfig,
                                      make_train_step, make_pipeline)
    from repro_torch.training.train import init_train_state, parameters

    out: dict = {}
    ring = make_mesh((4,), ("data",), device="cpu")
    for name in ("ring_odd", "ring_even"):
        x = torch.from_numpy(ref[name + "_in"][rank])
        out[name] = ring_allreduce(x, ring, "data").numpy()
    pd = make_mesh((2, 2), ("pod", "data"), device="cpu")
    out["hier"] = hierarchical_allreduce(
        torch.from_numpy(ref["hier_in"][rank]), pd).numpy()
    survivors = surviving_mesh(pd)
    out["surviving_ranks"] = survivors.mesh.flatten().tolist()
    out["surviving_axes"] = list(survivors.mesh_dim_names)
    out["on_surviving"] = survivors.get_coordinate() is not None

    dm = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = smoke_config(ARCH).scaled(attention_impl="reference",
                                    dtype="float32")
    plain = init_params(cfg, seed=0, device="cpu")
    model = copy.deepcopy(plain)
    placed = rescale(parameters(model), dm)
    want = param_shardings(dm, parameters(plain))
    out["rescale_placements_equal"] = all(
        tuple(t.placements) == want[k].placements for k, t in placed.items())
    out["rescale_values_equal"] = all(
        torch.equal(t.full_tensor(), parameters(plain)[k])
        for k, t in placed.items())
    out["rescale_sharded"] = sorted(
        k for k, t in placed.items()
        if any(p.is_shard() for p in t.placements))
    set_parameters(model, placed)

    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             make_pipeline(cfg, DataConfig(batch_per_host=BATCH,
                                           seq_len=SEQ)).batch(0).items()}
    out["loss_plain"] = float(train_loss(plain, batch)[0])
    with sharding_context(dm):
        loss = train_loss(model, batch)[0]
        out["loss_sharded_is_dtensor"] = isinstance(loss, DTensor)
        out["loss_sharded"] = float(loss.full_tensor())

    tc = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=0,
                                               total_steps=10))
    step = make_train_step(cfg, tc)
    step(plain, init_train_state(plain, tc), batch)
    with sharding_context(dm):
        step(model, init_train_state(model, tc), batch)
    out["adamw_err_of_scale"] = max(
        float((p.full_tensor() - parameters(plain)[k]).abs().max()
              / parameters(plain)[k].abs().max().clamp_min(1e-30))
        for k, p in parameters(model).items())

    out["family_losses"] = {}
    for arch in FAMILIES:
        fcfg = smoke_config(arch).scaled(attention_impl="reference",
                                         dtype="float32")
        fplain = init_params(fcfg, seed=0, device="cpu")
        fmodel = copy.deepcopy(fplain)
        set_parameters(fmodel, rescale(parameters(fmodel), dm))
        fbatch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                  make_pipeline(fcfg, DataConfig(batch_per_host=BATCH,
                                                 seq_len=SEQ))
                  .batch(0).items()}
        with torch.no_grad():
            want_loss = float(train_loss(fplain, fbatch)[0])
            with sharding_context(dm):
                got = float(train_loss(fmodel, fbatch)[0].full_tensor())
        out["family_losses"][arch] = (got, want_loss)

    out["grads"] = {case: _grads(dm, arch, over, names)
                    for case, (arch, over, names) in GRAD_CASES.items()}

    ckpt = os.path.join(out_dir, "ckpt")
    tr = ElasticTrainer(
        cfg, tc, DataConfig(batch_per_host=BATCH, seq_len=SEQ),
        FTConfig(checkpoint_dir=ckpt, checkpoint_interval_steps=2),
        mesh=pd, device="cpu")
    tr.run(3)
    tr.inject_failure()
    tr._recover(new_mesh=surviving_mesh(pd))
    tr.run(2)
    out["trainer_events"] = [(e.step, e.loss) for e in tr.events]
    out["trainer_active"] = tr.active
    out["trainer_mesh"] = list(tr.mesh.mesh_dim_names)
    return out


def _grads(dm, arch: str, overrides: dict, names) -> dict:
    """``arch``'s smoke ``train_loss`` (float32, plain attention) and its
    gradients with respect to ``names``, sharded on ``dm`` and unsharded:
    the two losses and each gradient's largest difference over the
    unsharded one's largest magnitude."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import (rescale, set_parameters,
                                         sharding_context)
    from repro_torch.models import init_params, train_loss
    from repro_torch.training import DataConfig, make_pipeline
    from repro_torch.training.train import parameters
    cfg = smoke_config(arch).scaled(attention_impl="reference",
                                    dtype="float32", **overrides)
    plain = init_params(cfg, seed=0, device="cpu")
    model = copy.deepcopy(plain)
    set_parameters(model, rescale(parameters(model), dm))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             make_pipeline(cfg, DataConfig(batch_per_host=BATCH, seq_len=SEQ))
             .batch(0).items()}
    loss = train_loss(plain, batch)[0]
    want = torch.autograd.grad(loss, [parameters(plain)[n] for n in names])
    with sharding_context(dm):
        got_loss = train_loss(model, batch)[0]
        got = torch.autograd.grad(got_loss,
                                  [parameters(model)[n] for n in names])
    return {"losses": (float(got_loss.full_tensor()), float(loss)),
            "err_of_scale": {
                n: float((g.full_tensor() - w).abs().max()
                         / w.abs().max().clamp_min(1e-30))
                for n, g, w in zip(names, got, want)}}
