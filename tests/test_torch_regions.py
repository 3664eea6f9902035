"""The sharded regions (``distributed.sharding.local_region``) on a fake
(data=2, model=2) process group in this process.

* Outside a sharding context, or inside one with no DTensor argument, a
  region calls its body itself (single-device runs do not change).
* The attention regions resolve one logical ``heads`` axis for q and the
  KV heads: with 2 KV heads both shard on ``model``; with 1 (which cannot)
  q's heads replicate with them, and the merged output follows.
* The embedding is vocab-parallel: a result partial over ``model`` where
  the vocab divides it, a plain lookup of the replicated table where not.
* The witness: for one smoke config of every family, a sharded
  ``train_loss`` and its backward hand DTensor to none of the aten ops
  whose sharding rules the PyTorch releases disagree on (PyTorch 2.11
  refuses ``aten._unsafe_view`` where a flattened dimension after the
  first is sharded, and its ``aten.index_put`` rule fails on the
  embedding's backward), and to no op of a region's body (the attention
  core and the head splits, the SSD mixer, the routing and the expert
  FFN, the embedding lookup, hubert's convolutional positional
  embedding).
* The MoE layer on a fake (pod=2, data=2, model=2) group, 4 sequences
  (one a batch shard): its forward and backward run. Before the routing
  took the tokens' reshape inside its regions, the backward's
  ``aten.view`` of the tokens' gradient (sharded on all three axes, which
  4 sequences cannot split) failed there, as the multi-pod dry-run's MoE
  ``train_4k`` cells did.

The fake group moves no data, so these tests check placements and ops;
``tests/test_torch_collectives.py`` holds the values and gradients on 4
gloo ranks against the unsharded port.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.distributed import (rescale, set_parameters,
                                     sharding_context)
from repro_torch.distributed.sharding import local_region, region_block
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, init_params, layers, mamba2, mla
from repro_torch.models import moe, train_loss, transformer
from repro_torch.obs.probe import AtenOpCounter
from repro_torch.training import DataConfig, make_pipeline
from repro_torch.training.train import parameters

#: ops whose DTensor sharding rules the PyTorch releases disagree on
REFUSED = ("aten._unsafe_view.default", "aten.index_put.default",
           "aten.index_put_.default", "aten._index_put_impl_.default")

#: the regions' bodies: no op inside one may see a DTensor
BODIES = {f.__code__ for f in (
    attention._qkv_heads, attention._attend, attention.sdpa_reference,
    mla._split_queries, mla._naive_heads, mla._absorbed_heads,
    mamba2._ssd_heads, mamba2.ssd_decode_step, kref.ssd_scan_ref,
    moe._route, moe._routed_buffer, moe._expert_ffn, layers._lookup,
    transformer._pos_conv)}

FAMILIES = ("deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "mamba2_1p3b", "zamba2_2p7b", "hubert_xlarge", "pixtral_12b")


@pytest.fixture(scope="module")
def mesh():
    """A (data=2, model=2) DeviceMesh over a fake 4-rank group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_mesh((2, 2), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _placed(mesh, t, *placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(placements))


def test_a_region_outside_a_context_calls_its_body():
    x = torch.ones(4, 3)
    seen = []

    def body(t, n):
        seen.append(region_block("batch"))
        return t

    region = local_region(body, (("batch", None), None), (("batch", None),))
    assert region(x, 1) is x
    with sharding_context({"data": 2, "model": 2}):
        assert region(x, 1) is x        # plain tensors: the body itself
    assert seen == [(0, 1), (0, 1)]


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_query_heads_shard_with_the_kv_heads(mesh, kv_heads):
    from torch.distributed.tensor import Replicate, Shard
    b, s, hd = 4, 8, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, 4 * hd, generator=g)
    kv = torch.randn(b, s, kv_heads * hd, generator=g)
    pos = torch.arange(s)[None].expand(b, s)
    with sharding_context(mesh):
        # the projections' outputs: batch on data, the merged heads on model
        qh, kh, vh = attention.qkv_heads(
            *(_placed(mesh, t, Shard(0), Shard(2)) for t in (q, kv, kv)),
            pos, 10000.0, hd)
        out = attention.attend(attention.sdpa_reference, qh, kh, vh,
                               causal=True)
    heads = Shard(2) if kv_heads == 2 else Replicate()
    for t in (qh, kh, vh):
        assert t.placements == (Shard(0), heads)
    assert tuple(qh.shape) == (b, s, 4, hd)
    assert tuple(kh.shape) == (b, s, kv_heads, hd)
    assert out.placements == (Shard(0), heads)
    assert tuple(out.shape) == (b, s, 4 * hd)


@pytest.mark.parametrize("vocab", [256, 255])
def test_the_embedding_is_vocab_parallel(mesh, vocab):
    from torch.distributed.tensor import Partial, Replicate, Shard
    table = torch.randn(vocab, 8)
    tokens = torch.randint(0, vocab, (4, 6))
    rows = Shard(0) if vocab % 2 == 0 else Replicate()
    with sharding_context(mesh):
        h = layers.embed(_placed(mesh, table, Replicate(), rows), tokens)
    assert tuple(h.shape) == (4, 6, 8)
    assert h.placements == (Shard(0), Partial() if vocab % 2 == 0
                            else Replicate())


class DTensorOps(AtenOpCounter):
    """The aten ops that receive a DTensor argument, and those among them
    dispatched from inside a region's body (by its Python frame)."""

    def __init__(self):
        super().__init__()
        self.dtensor_ops = set()
        self.in_bodies = set()

    def record(self, func, args, kwargs, out):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        if not any(isinstance(a, DTensor)
                   for a in tree_leaves((args, kwargs or {}))):
            return
        self.dtensor_ops.add(str(func))
        frame = sys._getframe()
        while frame is not None:
            if frame.f_code in BODIES:
                self.in_bodies.add((str(func), frame.f_code.co_name))
            frame = frame.f_back


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_dtensor_reaches_a_body_or_a_refused_op(mesh, arch):
    from torch.distributed.tensor import DTensor
    cfg = smoke_config(arch).scaled(attention_impl="reference",
                                    dtype="float32")
    model = init_params(cfg, seed=0, device="cpu")
    set_parameters(model, rescale(parameters(model), mesh))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             make_pipeline(cfg, DataConfig(batch_per_host=4, seq_len=16))
             .batch(0).items()}
    ops = DTensorOps()
    with sharding_context(mesh), ops:
        loss = train_loss(model, batch)[0]
        loss.backward()
    assert isinstance(loss, DTensor)
    assert ops.dtensor_ops, "the sharded step ran no DTensor op"
    assert not ops.dtensor_ops & set(REFUSED), \
        sorted(ops.dtensor_ops & set(REFUSED))
    assert not ops.in_bodies, sorted(ops.in_bodies)
    grads = [p.grad for p in parameters(model).values()]
    assert all(isinstance(g, DTensor) for g in grads)


THREE_AXIS_MOE = """
import torch, torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import smoke_config
from repro_torch.distributed import rescale, set_parameters, sharding_context
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.training.train import parameters
cfg = smoke_config("deepseek_moe_16b").scaled(attention_impl="reference")
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
layer = MoE(cfg, generator=None, dtype=torch.bfloat16, device="meta")
set_parameters(layer, rescale(parameters(layer), mesh))
x = distribute_tensor(torch.empty(4, 16, cfg.d_model, dtype=torch.bfloat16,
                                  device="meta"),
                      mesh, [Shard(0), Shard(0), Replicate()])
x.requires_grad_()
with sharding_context(mesh):
    y, aux = moe_apply(layer, cfg, x)
    (y.float().sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]).backward()
assert isinstance(x.grad, DTensor) and tuple(x.grad.shape) == (4, 16, 64)
assert all(isinstance(p.grad, DTensor) for p in parameters(layer).values())
print("backward ran", tuple(x.grad.placements))
dist.destroy_process_group()
"""


def test_a_three_axis_moe_layer_runs_its_backward():
    src = Path(__file__).parent.parent / "src"
    proc = subprocess.run([sys.executable, "-c", THREE_AXIS_MOE],
                          env={**os.environ, "PYTHONPATH": str(src)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "backward ran" in proc.stdout
