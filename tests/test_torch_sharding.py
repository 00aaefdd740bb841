"""The port's mesh specs against the JAX package's, in one process.

``repro_torch.launch.specs`` computes its specs on an abstract
``MeshSpec`` and the reference's on ``jax.sharding.AbstractMesh`` of the
same axes and sizes; neither needs a device.  For every architecture
(full and smoke configs) and the meshes (1, 1), (2, 4), (16, 16) and
(2, 16, 16), the specs of ``param_pack``, ``opt_pack`` (float32 and
8-bit moments), ``input_specs`` at every shape of ``SHAPES`` and
``cache_pack`` at each shape's (batch, sequence) must equal the
reference's entry for entry, and so must ``sharded_arg_bytes`` (exact
integers).  ``default_train_config`` must equal the reference's for every
(arch, shape).  The placements a spec gives a ``DeviceMesh`` are held on
a fake one-dimensional stand-in that names its axes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config, get_smoke as jget_smoke
from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke
from repro_torch.launch import specs
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import MeshSpec, P

ARCHS = ARCH_IDS + ["lm100m"]
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return MeshSpec(shape, axes), AbstractMesh(shape, axes)


def _port_specs(tree):
    out = []
    sharding.walk(tree, out.append, sharding.is_spec)
    return [tuple(s) for s in out]


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _ref_leaves(tree):
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    return [tuple(x.shape) for x in specs._leaves(tree)]


def _configs(arch, kind):
    if kind == "full":
        return get_config(arch), jget_config(arch)
    return get_smoke(arch), jget_smoke(arch)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, kind, mesh_name):
    cfg, jcfg = _configs(arch, kind)
    mesh, jmesh = _meshes(mesh_name)
    _, abs_p, p_specs = specs.param_pack(cfg, mesh)
    _, jabs_p, jp_specs = jspecs.param_pack(jcfg, jmesh)
    assert _port_leaves(abs_p) == _ref_leaves(jabs_p)
    assert _port_specs(p_specs) == _ref_specs(jp_specs)
    assert specs.sharded_arg_bytes(abs_p, p_specs, mesh) == \
        jspecs.sharded_arg_bytes(jabs_p, jp_specs, jmesh)
    for eightbit in (False, True):
        st, st_specs = specs.opt_pack(abs_p, p_specs, mesh, eightbit)
        jst, jst_specs = jspecs.opt_pack(jabs_p, jp_specs, jmesh, eightbit)
        assert _port_leaves(st) == _ref_leaves(jst)
        assert _port_specs(st_specs) == _ref_specs(jst_specs)
        assert specs.sharded_arg_bytes(st, st_specs, mesh) == \
            jspecs.sharded_arg_bytes(jst, jst_specs, jmesh)
    for name, shape in SHAPES.items():
        batch, b_specs = specs.input_specs(cfg, shape, mesh)
        jbatch, jb_specs = jspecs.input_specs(jcfg, JSHAPES[name], jmesh)
        assert sorted(batch) == sorted(jbatch)
        for key in batch:
            assert tuple(batch[key].shape) == tuple(jbatch[key].shape)
            assert tuple(b_specs[key]) == tuple(jb_specs[key]), (name, key)
        assert specs.sharded_arg_bytes(batch, b_specs, mesh) == \
            jspecs.sharded_arg_bytes(jbatch, jb_specs, jmesh)
        b, s = shape.global_batch, shape.seq_len
        cache, c_specs = specs.cache_pack(cfg, mesh, b, s,
                                          seq_all=b == 1)
        jcache, jc_specs = jspecs.cache_pack(jcfg, jmesh, b, s,
                                             seq_all=b == 1)
        assert _port_leaves(cache) == _ref_leaves(jcache)
        assert _port_specs(c_specs) == _ref_specs(jc_specs), name
        assert specs.sharded_arg_bytes(cache, c_specs, mesh) == \
            jspecs.sharded_arg_bytes(jcache, jc_specs, jmesh)


def test_qwen_param_bytes_a_device():
    """qwen2.5-3b's bf16 parameters at 16×16: 26,852,608 bytes a
    device, the reference's figure."""
    mesh, jmesh = _meshes("16x16")
    _, abs_p, p_specs = specs.param_pack(get_config("qwen2.5-3b"), mesh)
    assert specs.sharded_arg_bytes(abs_p, p_specs, mesh) == 26_852_608
    _, jabs, jsp = jspecs.param_pack(jget_config("qwen2.5-3b"), jmesh)
    assert jspecs.sharded_arg_bytes(jabs, jsp, jmesh) == 26_852_608


def _train_config_fields(tc):
    out = dataclasses.asdict(tc)
    out["grad_accum_dtype"] = str(tc.grad_accum_dtype).split(".")[-1]
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_default_train_config_equals_reference(arch, shape):
    got = _train_config_fields(specs.default_train_config(arch,
                                                          SHAPES[shape]))
    jtc = jspecs.default_train_config(arch, JSHAPES[shape])
    want = dataclasses.asdict(jtc)
    want["grad_accum_dtype"] = jnp.dtype(jtc.grad_accum_dtype).name
    assert got == want


class _NamedMesh:
    """What ``placements`` reads of a DeviceMesh: its names and shape."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


@pytest.mark.parametrize("spec, want", [
    (P(), (Replicate(), Replicate(), Replicate())),
    (P(("pod", "data"), None), (Shard(0), Shard(0), Replicate())),
    (P("data", "model"), (Replicate(), Shard(0), Shard(1))),
    (P("model", "data"), (Replicate(), Shard(1), Shard(0))),
    (P(None, None, "model"), (Replicate(), Replicate(), Shard(2))),
])
def test_placements(spec, want):
    mesh = _NamedMesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements(spec, mesh) == want


def test_placements_refuse_out_of_order_axes():
    mesh = _NamedMesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        sharding.placements(P(("data", "pod")), mesh)


def test_sharding_tree_and_divisible():
    """``sharding_tree`` places each logical leaf by its spec;
    ``divisible`` is true for an axis the mesh lacks."""
    mesh = _NamedMesh((2, 4), ("data", "model"))
    tree = sharding.sharding_tree({"w": ("fsdp", "tp"), "b": (None,)}, mesh)
    assert tree["w"] == sharding.NamedSharding(mesh, (Shard(0), Shard(1)))
    assert tree["b"].placements == (Replicate(), Replicate())
    assert sharding.divisible(6, mesh, "data")
    assert not sharding.divisible(6, mesh, "model")
    assert sharding.divisible(3, mesh, "pod")
