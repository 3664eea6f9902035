"""The port's sharding rules and launch specs against the reference's.

The reference's ``tests/test_sharding.py``, each case held against the
reference on the CPU:

* ``param_specs`` for every smoke config equal the reference's specs of its
  layer-stacked leaves with the leading layer axes dropped, leaf by leaf
  (the port keys by ``named_parameters()``: ``blocks.<i>.*`` for the stack,
  the MoE family's dense ``prefix`` blocks first);
* ``cache_specs`` equal the reference's on ``init_cache`` structs, over an
  abstract (data=4, model=4) mesh and over the (1, 1) mesh;
* the reference's ``TestSanitize`` cases, and the mesh helpers
  (``batch_spec``, ``has_pod_axis``, ``axis_size``) beside the reference's;
* ``shard`` returns ``x`` itself outside a context; inside one it
  right-aligns the logical axes to the tensor's rank (the reference's own
  case fails on JAX 0.9.0, so it is held to the rule as written, on a
  DTensor over a fake 4-rank group);
* ``SHAPES``, ``cell_supported`` and ``batch_specs`` agree with the
  reference for every full config, as meta tensors, and every full
  config's parameters build on the meta device.
"""
import functools
import math

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed import mesh as ref_mesh  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.distributed import (axis_size, batch_spec,  # noqa: E402
                                     cache_specs, has_pod_axis, named,
                                     param_shardings, param_specs,
                                     sanitize_spec, shard, sharding_context)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402


class FakeMesh:
    """The reference tests' abstract mesh: axis names and sizes only."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _keystr(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(tree):
    return {_keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_params(cfg):
    return jax.eval_shape(lambda k: ref_init_params(k, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _unstacked(cfg, ref_specs_by_path):
    """The reference's specs under the port's names: a stacked leaf's spec,
    without its leading layer axes, for each of its layers."""
    n_prefix = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    lead = ((cfg.n_layers // cfg.hybrid.period, cfg.hybrid.period)
            if cfg.family == "hybrid" else (cfg.n_layers - n_prefix,))
    out = {}
    for path, spec in ref_specs_by_path.items():
        name, spec = path.replace("/", "."), tuple(spec)
        if name.startswith("stack."):
            for i in range(math.prod(lead)):
                out[f"blocks.{n_prefix + i}.{name[6:]}"] = spec[len(lead):]
        elif name.startswith("prefix."):
            out[f"blocks.{name[7:]}"] = spec
        else:
            out[name] = spec
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references_unstacked(arch):
    ref_cfg = ref_smoke_config(arch)
    ref = _flat(ref_sharding.param_specs(_ref_params(ref_cfg)))
    want = _unstacked(ref_cfg, ref)
    model = init_params(smoke_config(arch), device="meta")
    got = param_specs(model)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == want[name], name
    # the placements on an abstract mesh follow the sanitized specs
    mesh = {"data": 4, "model": 4}
    shapes = {n: p.shape for n, p in model.named_parameters()}
    for name, sh in param_shardings(mesh, model).items():
        assert sh.spec == ref_sharding.sanitize_spec(
            FakeMesh(**mesh), jax.sharding.PartitionSpec(*want[name]),
            tuple(shapes[name])), name


def test_core_and_expert_rules():
    specs_ = param_specs(init_params(smoke_config("deepseek_7b"),
                                     device="meta"))
    assert specs_["blocks.0.mixer.wq.w"] == ("data", "model")
    assert specs_["blocks.1.mixer.wo.w"] == ("model", "data")
    assert specs_["blocks.0.ffn.down.w"] == ("model", "data")
    assert specs_["embed.table"] == ("model", None)
    assert specs_["final_norm.scale"] == (None,)
    moe = param_specs(init_params(smoke_config("deepseek_moe_16b"),
                                  device="meta"))
    assert moe["blocks.1.ffn.experts.gate.w"] == ("model", "data", None)
    assert moe["blocks.1.ffn.experts.down.w"] == ("model", None, "data")


MESHES = {"abstract_4x4": {"data": 4, "model": 4},
          "one_by_one": {"data": 1, "model": 1}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).supports_decode])
def test_cache_specs_equal_the_references(arch, mesh):
    if mesh == "one_by_one":
        ref_m = ref_make_mesh((1, 1), ("data", "model"))
    else:
        ref_m = FakeMesh(**MESHES[mesh])
    ref_cache = jax.eval_shape(functools.partial(
        ref_init_cache, ref_smoke_config(arch), 8, 64))
    ref = _flat(ref_sharding.cache_specs(ref_m, ref_cache))
    # the port's leaves by key; the reference's stacked leaf of that key
    # (its MoE prefix list holds the same spec less the layer axis)
    want = {path.rsplit("/", 1)[-1]: tuple(spec) for path, spec in ref.items()
            if not path.startswith("prefix/")}
    got = cache_specs(MESHES[mesh], init_cache(smoke_config(arch), 8, 64,
                                               device="meta"))
    assert got == want


def test_sanitize_drops_non_dividing_axes():
    assert sanitize_spec({"data": 1, "model": 1}, ("data", "model"),
                         (7, 5)) == ("data", "model")
    mesh = FakeMesh(data=4, model=4)
    assert sanitize_spec(mesh, ("data", "model"), (8, 6)) == ("data", None)
    assert sanitize_spec(mesh, (("data", "model"),), (15,)) == (None,)
    assert sanitize_spec(mesh, (("data", "model"),), (16,)) \
        == (("data", "model"),)
    for spec, shape in (((("data", "model"),), (15,)),
                        (("data", "model"), (8, 6)), ((None, "model"), (3, 8))):
        want = ref_sharding.sanitize_spec(
            mesh, jax.sharding.PartitionSpec(*spec), shape)
        assert sanitize_spec(mesh, spec, shape) == tuple(want)


@pytest.mark.parametrize("shape", [{"data": 4, "model": 4},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"model": 8}])
def test_mesh_helpers_equal_the_references(shape):
    mesh = FakeMesh(**shape)
    if "data" in shape:
        assert batch_spec(mesh) == tuple(ref_mesh.batch_spec(mesh))
    assert has_pod_axis(mesh) == ref_mesh.has_pod_axis(mesh)
    for a in ("pod", "data", "model"):
        assert axis_size(mesh, a) == ref_mesh.axis_size(mesh, a)


def test_named_places_each_axis_by_the_dimension_naming_it():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert named(mesh, (("pod", "data"), None, "model")).placements == \
        (Shard(0), Shard(0), Shard(2))
    assert named(mesh, (None, "data")).placements == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        named(mesh, (("data", "pod"),))


def test_shard_is_the_identity_without_context():
    x = torch.ones(4, 4)
    assert shard(x, "batch", "mlp") is x
    with sharding_context({"data": 4, "model": 4}):
        # a plain tensor is this rank's whole value
        assert shard(x, "batch", "mlp") is x


@pytest.fixture(scope="module")
def fake_mesh():
    """A (data=2, model=2) DeviceMesh over a fake 4-rank group in this
    process (no data moves: the group's collectives do nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_mesh((2, 2), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_shard_right_aligns_in_context(fake_mesh):
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.ones(2, 4, 4), fake_mesh, rep)
    with sharding_context(fake_mesh):
        y = shard(x, "batch", "mlp")            # shorter spec: pads left
        z = shard(distribute_tensor(torch.ones(4), fake_mesh, rep),
                  "batch", None, "mlp")          # longer: trims
        odd = shard(distribute_tensor(torch.ones(3, 4), fake_mesh, rep),
                    "batch", "mlp")              # 3 rows: batch replicated
    assert y.shape == x.shape and y.placements == (Shard(1), Shard(2))
    assert z.shape == (4,) and z.placements == (Replicate(), Shard(0))
    assert odd.placements == (Replicate(), Shard(1))


def test_make_mesh_needs_a_group_of_its_size(fake_mesh):
    from repro_torch.launch.mesh import make_mesh
    assert dict(zip(fake_mesh.mesh_dim_names, fake_mesh.shape)) \
        == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="world size 8; this one has 4"):
        make_mesh((2, 4), ("data", "model"), device="cpu")


def test_launch_shape_tables():
    assert specs.SHAPES == ref_specs.SHAPES
    assert specs.SHAPE_KIND == ref_specs.SHAPE_KIND


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_batch_specs_equal_the_references_on_meta(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in specs.SHAPES:
        assert specs.cell_supported(cfg, shape) \
            == ref_specs.cell_supported(ref_cfg, shape)
    for training in (True, False):
        got = specs.batch_specs(cfg, 256, 4096, training=training)
        want = ref_specs.batch_specs(ref_cfg, 256, 4096, training=training)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).split(".")[1] == str(want[k].dtype)
    model = specs.param_structs(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    want_n = sum(math.prod(leaf.shape)
                 for leaf in jax.tree.leaves(_ref_params(ref_cfg)))
    assert sum(p.numel() for p in model.parameters()) == want_n
