"""The port's LM sharding rules (sharding/partition, models/model.
param_specs), its named mesh (core/meshutil.Mesh, launch/mesh) and
elastic re-planning (train/elastic) against the JAX package's: the spec
arithmetic and every struct's shard shape at 1x1, a (8, 2) mesh and the
production meshes (16x16, 2x16x16), for every LM arch.  The JAX side
runs on jax.sharding.AbstractMesh (no devices needed)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.models.config import ALL_SHAPES as J_SHAPES
from repro.sharding import partition as jpartition
from repro.train import elastic as jelastic
from repro_torch.configs import registry
from repro_torch.core import meshutil
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.models.config import ALL_SHAPES
from repro_torch.sharding import partition
from repro_torch.train import elastic

MESHES = [((1, 1), ("data", "model")), ((8, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = registry.LM_ARCH_IDS


def _jshapes(tree) -> list:
    return [tuple(x.sharding.shard_shape(x.shape))
            for x in jax.tree.leaves(tree)]


def _tshapes(tree) -> list:
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tshapes(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _tshapes(v)]
    assert tree.device.type == "meta"
    return [tuple(tree.shape)]


def _spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    jc, tc = jregistry.get_config(arch), registry.get_config(arch)
    want = {k: _spec(v) for k, v in jmodel.param_specs(jc).items()}
    assert model.param_specs(tc) == want


@pytest.mark.parametrize("sizes,names", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_structs_shard_shapes_equal_jax(arch, sizes, names):
    jm, tm = AbstractMesh(sizes, names), meshutil.make_mesh(sizes, names)
    jc, tc = jregistry.get_config(arch), registry.get_config(arch)
    for fsdp in (None, True):
        assert _tshapes(partition.param_structs(tc, tm, fsdp)) == \
            _jshapes(jpartition.param_structs(jc, jm, fsdp))
    assert _tshapes(partition.opt_state_structs(tc, tm)) == \
        _jshapes(jpartition.opt_state_structs(jc, jm, None))
    for js, ts in zip(J_SHAPES, ALL_SHAPES):
        assert _tshapes(partition.batch_structs(tc, ts, tm)) == \
            _jshapes(jpartition.batch_structs(jc, js, jm)), js.name
        if js.kind == "decode":
            assert _tshapes(partition.cache_structs(tc, ts, tm)) == \
                _jshapes(jpartition.cache_structs(jc, js, jm)), js.name


@pytest.mark.parametrize("sizes,names", MESHES)
def test_normalize_and_zero_spec_equal_jax(sizes, names):
    jm, tm = AbstractMesh(sizes, names), meshutil.make_mesh(sizes, names)
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model")]
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 16, 32, 48, 7, 256, 512]))
                      for _ in range(nd))
        spec = tuple(entries[int(rng.integers(len(entries)))]
                     for _ in range(int(rng.integers(0, nd + 1))))
        assert partition.normalize(spec, shape, tm) == \
            _spec(jpartition.normalize(P(*spec), shape, jm)), (spec, shape)
        free = tuple(e if e in (None, "model") else None for e in spec)
        assert partition.zero_spec(free, shape, tm) == \
            tuple(jpartition.zero_spec(free, shape, jm)), (free, shape)
    sh = partition.shard(tm, (("pod", "data"), "model"), (64, 32))
    assert sh.shard_shape((64, 32)) == tuple(
        jpartition.shard(jm, P(("pod", "data"), "model"),
                         (64, 32)).shard_shape((64, 32)))
    assert partition.replicated(tm).shard_shape((5, 7)) == (5, 7)


def test_param_shardings_and_default_fsdp():
    tm = mesh_lib.make_production_mesh()
    jm = AbstractMesh((16, 16), ("data", "model"))
    for arch in ARCHS:
        tc, jc = registry.get_config(arch), jregistry.get_config(arch)
        got = partition.param_shardings(tc, tm)
        want = jpartition.param_shardings(jc, jm)
        assert {k: v.spec for k, v in got.items()} == \
            {k: _spec(v.spec) for k, v in want.items()}
        assert partition.default_fsdp(tc, tm) == (arch == "arctic-480b")


def test_production_and_host_meshes():
    pod = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert mesh_lib.make_host_mesh(4, n_devices=8).shape == \
        {"data": 2, "model": 4}
    assert mesh_lib.make_host_mesh(4, n_devices=1).shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        meshutil.make_mesh((2, 2), ("data",))


def test_set_mesh_and_maybe_constrain():
    x = torch.arange(6.0).reshape(2, 3)
    m = meshutil.make_mesh((1, 1), ("data", "model"))
    assert meshutil.active_mesh() is None
    with meshutil.set_mesh(m) as active:
        assert active is m and meshutil.active_mesh() is m
        assert meshutil.maybe_constrain(x, ("pod", "data"), None) is x
    assert meshutil.active_mesh() is None
    assert meshutil.maybe_constrain(x, ("pod", "data"), None) is x
    # nothing partitions a step in the port: a larger mesh is refused
    with meshutil.set_mesh(meshutil.make_mesh((2, 1), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="one device"):
            meshutil.maybe_constrain(x, ("pod", "data"), None)
    assert meshutil.active_mesh() is None


def test_replan_shape_equals_jax():
    for n in (1, 2, 3, 5, 6, 7, 8, 12, 24, 40, 48, 96, 256, 512):
        for prefer in (1, 2, 4, 16):
            assert elastic.replan_shape(n, prefer) == \
                jelastic.replan_shape(n, prefer), (n, prefer)


def test_replan_shape_non_power_of_two_counts():
    """tests/test_elastic_checkpoint.py's cases on the port."""
    assert elastic.replan_shape(6) == (3, 2)
    assert elastic.replan_shape(12) == (3, 4)
    assert elastic.replan_shape(48) == (3, 16)
    assert elastic.replan_shape(7) == (7, 1)
    assert elastic.replan_shape(1) == (1, 1)
    assert elastic.replan_shape(8, prefer_model=4) == (2, 4)
    for n in (1, 2, 3, 5, 6, 7, 12, 24, 40, 96):
        data, model_ = elastic.replan_shape(n)
        assert data * model_ == n and model_ & (model_ - 1) == 0


def test_replan_mesh():
    mesh = elastic.replan_mesh(1)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert elastic.replan_mesh(6).shape == {"data": 3, "model": 2}
    assert elastic.replan_mesh(6, prefer_model=1).shape == \
        {"data": 6, "model": 1}
