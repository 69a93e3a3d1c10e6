"""The port's mesh functions against the JAX package's, leaf by leaf.

``partition_specs``, ``act_spec``, ``input_partition_specs`` and
``cache_partition_specs`` of ``repro_torch`` must equal the reference's
for every arch, every shape (``long_500k``'s sequence-sharded KV
included) and the meshes 16×16, 2×16×16, 2×4 and 2×2×2, compared as
tuples by key path. The reference's spec functions read only the mesh's
``.shape``, so they run on a stub mesh without devices. The dry run's
per-chip argument bytes must equal the same sum over the reference's
specs.
"""
import math
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.launch.mesh import default_rules as ref_default_rules
from repro.models import api as ref_api
from repro.models.module import MeshRules as RefMeshRules
from repro.models.module import act_spec as ref_act_spec
from repro.models.module import partition_specs as ref_partition_specs
from repro.sharding.specs import cache_partition_specs as ref_cache_specs
from repro.sharding.specs import input_partition_specs as ref_input_specs_p
from repro_torch.configs import get_config, input_specs
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models.module import (
    MeshRules, act_spec, partition_specs, shardings, tree_items,
)
from repro_torch.sharding.partition import (
    NamedSharding, PartitionSpec, shard_count,
)
from repro_torch.sharding.specs import (
    cache_partition_specs, input_partition_specs, to_shardings,
)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
CELLS = [(a, m) for a in ARCH_IDS for m in MESHES]


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    return ref, mesh_mod.make_mesh(shape, axes)


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {tuple(k.key for k in path): tuple(p) for path, p in leaves}


def _port_flat(tree):
    return {path: tuple(p) for path, p in tree_items(tree)}


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_param_specs_match_reference(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    want = _ref_flat(ref_partition_specs(
        ref_api.spec(ref_get_config(arch)), ref_mesh,
        ref_default_rules(ref_mesh)))
    got = partition_specs(api.spec(get_config(arch)), port_mesh,
                          mesh_mod.default_rules(port_mesh))
    assert all(isinstance(p, PartitionSpec) for _, p in tree_items(got))
    assert _port_flat(got) == want


# rules that map a logical axis to two mesh axes, where a dim that
# divides one axis but not the pair takes the longest prefix that divides
WIDE_RULES = {
    "fsdp_pod_data": dict(fsdp=("pod", "data")),
    "tensor_data_model": dict(tensor=("data", "model")),
    "tensor_model_pod": dict(fsdp=(), tensor=("model", "pod")),
}


@pytest.mark.parametrize("rules", list(WIDE_RULES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_prefix_fallback_matches_reference(arch, rules):
    for mesh in ("2x16x16", "2x2x2"):
        ref_mesh, port_mesh = _meshes(mesh)
        want = _ref_flat(ref_partition_specs(
            ref_api.spec(ref_get_config(arch)), ref_mesh,
            RefMeshRules(**WIDE_RULES[rules])))
        got = partition_specs(api.spec(get_config(arch)), port_mesh,
                              MeshRules(**WIDE_RULES[rules]))
        assert _port_flat(got) == want, mesh


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_input_and_cache_specs_match_reference(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_rules = ref_default_rules(ref_mesh)
    rules = mesh_mod.default_rules(port_mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        want = {k: tuple(v) for k, v in ref_input_specs_p(
            ref_mesh, ref_rules, ref_input_specs(rcfg, shape)).items()}
        got = input_partition_specs(port_mesh, rules,
                                    input_specs(cfg, shape))
        assert {k: tuple(v) for k, v in got.items()} == want, name
        if shape.kind != "decode":
            continue
        ref_caches = ref_api.cache_abstract(rcfg, shape.global_batch,
                                            shape.seq_len,
                                            enc_len=shape.seq_len)
        caches = api.cache_abstract(cfg, shape.global_batch, shape.seq_len,
                                    enc_len=shape.seq_len)
        # the same leaf names (each leaf's role) at the same paths
        assert {p: tuple(t.shape) for p, t in tree_items(caches)} == {
            tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref_caches)[0]}, name
        want = _ref_flat(ref_cache_specs(rcfg, ref_mesh, ref_rules,
                                         ref_caches))
        got = cache_partition_specs(cfg, port_mesh, rules, caches)
        assert _port_flat(got) == want, name


def test_long_500k_kv_is_sequence_sharded():
    """B = 1 cannot be split, so the attention caches' sequence dim takes
    the batch axes (jamba's attention positions)."""
    _, port_mesh = _meshes("2x16x16")
    cfg, shape = get_config("jamba-v0.1-52b"), SHAPES["long_500k"]
    caches = api.cache_abstract(cfg, shape.global_batch, shape.seq_len)
    specs = dict(tree_items(cache_partition_specs(
        cfg, port_mesh, mesh_mod.default_rules(port_mesh), caches)))
    kv = [p for path, p in specs.items() if path[-1] in ("k", "v")]
    assert kv and all(p[1] is None and p[2] == ("pod", "data") for p in kv)


def _ref_chip_bytes(shape_dtypes, specs, mesh_shape):
    leaves = jax.tree_util.tree_leaves(shape_dtypes)
    ps = jax.tree_util.tree_leaves(specs,
                                   is_leaf=lambda x: isinstance(x, RefP))
    total = 0
    for leaf, p in zip(leaves, ps):
        n = 1
        for entry in p:
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                n *= mesh_shape[a]
        total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize // n
    return total


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_argument_bytes_equal_the_sum_over_reference_specs(arch, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_rules = ref_default_rules(ref_mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    spec = ref_api.spec(rcfg)
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                          spec, is_leaf=lambda x: hasattr(x, "axes"))
    p_bytes = _ref_chip_bytes(shapes, ref_partition_specs(
        spec, ref_mesh, ref_rules), ref_mesh.shape)
    for name, shape in SHAPES.items():
        ins = ref_input_specs(rcfg, shape)
        want = p_bytes + _ref_chip_bytes(
            ins, ref_input_specs_p(ref_mesh, ref_rules, ins), ref_mesh.shape)
        if shape.kind == "train":
            want += 2 * p_bytes + 2 * 4    # m, v; AdamW count, state step
        elif shape.kind == "decode":
            caches = ref_api.cache_abstract(rcfg, shape.global_batch,
                                            shape.seq_len,
                                            enc_len=shape.seq_len)
            want += _ref_chip_bytes(caches, ref_cache_specs(
                rcfg, ref_mesh, ref_rules, caches), ref_mesh.shape)
        got = dryrun.argument_bytes(cfg, shape, port_mesh,
                                    mesh_mod.default_rules(port_mesh))
        assert got == want, name


LOGICAL = [
    ("batch", None, "act_embed"), ("batch", None, "act_ffn"),
    ("batch", None, "act_heads"), ("batch", None, "act_heads", None),
    ("batch", "act_heads", None, None), ("batch", None, None),
    ("batch", "act_experts", None, "act_ffn"),
    ("batch", "act_seq", "act_embed"), ("act_experts", None, "act_ffn"),
    ("stage", "batch", None), ("batch", None, "act_kv"),
    ("layers", "embed", "ffn"), ("vocab", "embed"), ("experts", "embed",
                                                      "ffn"),
    ("embed", "heads"), ("heads", "kv_heads"), ("batch", "batch"), (),
]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_spec_matches_reference(mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    for seq in ((), ("model",), ("data",)):
        ref_rules = RefMeshRules(sequence=seq)
        rules = MeshRules(sequence=seq)
        for logical in LOGICAL:
            want = tuple(ref_act_spec(ref_mesh, ref_rules, *logical))
            assert tuple(act_spec(port_mesh, rules, *logical)) == want, \
                (seq, logical)


def test_shardings_wrap_the_specs():
    _, port_mesh = _meshes("2x4")
    cfg, rules = get_config("qwen3-1.7b"), MeshRules()
    sh = shardings(api.spec(cfg), port_mesh, rules)
    specs = partition_specs(api.spec(cfg), port_mesh, rules)
    for (_, s), (_, p) in zip(tree_items(sh), tree_items(specs)):
        assert isinstance(s, NamedSharding) and s.mesh is port_mesh
        assert s.spec == p
    wrapped = to_shardings(port_mesh, {"a": PartitionSpec("data", None)})
    assert wrapped["a"] == NamedSharding(port_mesh, ("data", None))
    assert shard_count(port_mesh, wrapped["a"].spec) == 2
    assert shard_count(port_mesh, PartitionSpec(("data", "model"))) == 8


def test_production_mesh_and_override(monkeypatch):
    m = mesh_mod.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert mesh_mod.mesh_device_count(m) == 256
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert list(m.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert mesh_mod.mesh_device_count(m) == 512
    monkeypatch.setenv("REPRO_MESH_SINGLE", "2,4")
    monkeypatch.setenv("REPRO_MESH_MULTI", "2,2,2")
    assert mesh_mod.make_production_mesh().shape == {"data": 2, "model": 4}
    assert mesh_mod.mesh_device_count(
        mesh_mod.make_production_mesh(multi_pod=True)) == 8
    assert mesh_mod.default_rules(
        mesh_mod.make_production_mesh()).batch == ("data",)
    monkeypatch.setenv("REPRO_MESH_SINGLE", "2,2,2")
    with pytest.raises(ValueError):
        mesh_mod.make_production_mesh()


def test_partition_spec_is_a_tuple():
    p = PartitionSpec(None, ("pod", "data"), "model")
    assert p == (None, ("pod", "data"), "model") == tuple(RefP(
        None, ("pod", "data"), "model"))
    assert PartitionSpec() == ()
