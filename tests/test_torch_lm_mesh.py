"""LM serving sharded over a device mesh, against the JAX package unsharded.

Each mesh — (2,2), (1,4) and (4,1) over the axes (data, model) — is one
spawn of four gloo ranks (``torch_lm_mesh_worker.py``, one thread each,
a file store under the test's temporary directory, every join bounded),
shared by the cases below. The model is a small dense config (2 layers,
d 64, 4 query and 2 KV heads, vocab 512, float32 compute) with the JAX
package's parameters (``params_from_reference``); phi-3-vision's and
whisper-small's blocks at the same widths check the vlm and audio
families. The reference is the JAX package's unsharded ``forward``,
``prefill``, ``decode_step`` and ``generate`` on the CPU.

Tolerance: ``atol`` 1e-5 and ``rtol`` 1e-4 on logits (float32 on both
sides; the mesh cuts reductions differently from one device); tokens and
placements exactly. Placements are held to ``placements(mesh, spec)`` of
the JAX package's own spec for each parameter, cache leaf and activation
site, and each rank's resident bytes to the dry run's ``argument_bytes``
less its input bytes.
"""
import os
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard

import torch_lm_mesh_worker as worker
from repro.launch.mesh import default_rules as ref_default_rules
from repro.models import api as ref_api
from repro.models.module import MeshRules as RefMeshRules
from repro.models.module import partition_specs as ref_partition_specs
from repro.serve.step import generate as ref_generate
from repro.sharding.ctx import _divisible_spec as ref_divisible_spec
from repro.sharding.specs import cache_partition_specs as ref_cache_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.module import MeshRules
from repro_torch.sharding import ctx
from repro_torch.sharding.partition import Mesh, PartitionSpec as P, \
    placements
from torch_lm_helpers import (
    batch_np, first_pos, port_cfg, prefix, ref_cfg, ref_decode_fn,
    ref_forward_fn, ref_params_np, ref_prefill_fn, to_jax,
)

ATOL, RTOL = 1e-5, 1e-4
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# where each mesh's checkpoint is restored: (2,2) → (4,1), and round
RESTORE = {"2x2": (4, 1), "1x4": (2, 2), "4x1": (1, 4)}
OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
MODELS = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
          "audio": "whisper-small", "chunked": "qwen3-1.7b"}
# each model's widths; "chunked" takes the online-softmax attention path
# (sequences of 8 and more in chunks of 4)
OVERS = {m: OVER for m in MODELS}
OVERS["chunked"] = dict(OVER, chunked_attn_threshold=8, attn_chunk_q=4,
                        attn_chunk_kv=4)
B, S, MAX, N_STEPS, N_NEW = 4, 8, 32, 4, 4
SERVE = {"b4": B, "b1": 1}
JOIN_S = 240


def _stub(shape):
    return types.SimpleNamespace(shape=dict(zip(AXES, shape)))


def _serve_inputs(model, b):
    """(prompt batch, teacher-forced decode tokens, first position)."""
    cfg = port_cfg(MODELS[model], "f32", **OVERS[model])
    full = batch_np(cfg, seed=b, b=b, s=S + N_STEPS)
    return prefix(full, S), full["tokens"][:, S:], first_pos(cfg, S)


def _job(mesh_name, tmp):
    models = {}
    for name, arch in MODELS.items():
        cfg = port_cfg(arch, "f32", **OVERS[name])
        serve = {}
        for b_name, b in SERVE.items():
            batch, feed, first = _serve_inputs(name, b)
            serve[b_name] = {"batch": batch, "feed": feed, "first": first}
        models[name] = {"arch": arch, "over": OVERS[name],
                        "params": ref_params_np(arch, **OVER),
                        "batch": batch_np(cfg, b=B, s=S), "serve": serve}
    models["dense"]["generate"] = _serve_inputs("dense", B)[0]["tokens"]
    return {"models": models, "max_seq": MAX,
            "n_new": N_NEW, "restore_model": "dense", "restore_shape": RESTORE[mesh_name],
            "ckpt_dir": os.path.join(tmp, "ckpt")}


def _spawn(shape, job, tmp):
    """Four ranks on ``shape``; every join bounded, a hung rank killed."""
    out = os.path.join(tmp, "out")
    os.makedirs(out)
    store = os.path.join(tmp, "store")
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=worker.main,
                           args=(r, 4, store, shape, job, out))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    with open(os.path.join(out, "result.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    name = request.param
    tmp = str(tmp_path_factory.mktemp(f"mesh_{name}"))
    return name, MESHES[name], _spawn(MESHES[name], _job(name, tmp), tmp)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _ref_params(arch):
    return jax.tree.map(jnp.asarray, ref_params_np(arch, **OVER))


def _placed(shape, spec) -> str:
    return repr(placements(Mesh(shape, AXES), spec))


def _ref_flat(tree):
    from jax.sharding import PartitionSpec as RefP
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(k.key for k in path): p for path, p in leaves}


# ---------------------------------------------------------------------------
# Values against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_forward_logits_match_reference(run, model):
    arch = MODELS[model]
    cfg = port_cfg(arch, "f32", **OVERS[model])
    want, _ = ref_forward_fn(arch, "f32", **OVERS[model])(
        _ref_params(arch), to_jax(batch_np(cfg, b=B, s=S)))
    _close(run[2][model, "forward"], want)


@pytest.mark.parametrize("model,b_name", [(m, b) for m in MODELS
                                           for b in SERVE])
def test_prefill_and_decode_match_reference(run, model, b_name):
    """Prefill, then four donating decode steps; ``b1`` is batch 1, where
    a mesh with a data axis cuts the KV cache along the sequence."""
    arch = MODELS[model]
    batch, feed, first = _serve_inputs(model, SERVE[b_name])
    params = _ref_params(arch)
    logits, caches = ref_prefill_fn(arch, "f32", MAX, **OVERS[model])(
        params, to_jax(batch))
    _close(run[2][model, b_name, "prefill"], logits[:, -1:])
    dec = ref_decode_fn(arch, "f32", **OVERS[model])
    for i, got in enumerate(run[2][model, b_name, "decode"]):
        want, caches = dec(params, caches, jnp.asarray(feed[:, i:i + 1]),
                           jnp.int32(first + i))
        _close(got, want)


def test_generate_matches_reference(run):
    arch = MODELS["dense"]
    prompt = _serve_inputs("dense", B)[0]["tokens"]
    want = ref_generate(_ref_params(arch), ref_cfg(arch, "f32", **OVER),
                        jnp.asarray(prompt), N_NEW, MAX)
    np.testing.assert_array_equal(run[2]["dense", "generate"],
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# Placements and bytes against the JAX package's specs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_parameters_take_the_reference_placements(run, model):
    _, shape, res = run
    arch = MODELS[model]
    stub = _stub(shape)
    specs = _ref_flat(ref_partition_specs(
        ref_api.spec(ref_cfg(arch, "f32", **OVER)), stub,
        ref_default_rules(stub)))
    assert res[model, "params"] == {k: _placed(shape, s)
                                    for k, s in specs.items()}


@pytest.mark.parametrize("model,b_name", [(m, b) for m in MODELS
                                           for b in SERVE])
def test_caches_keep_the_reference_placements_through_decode(run, model,
                                                             b_name):
    """After prefill and after each donating decode step, every cache leaf
    is laid out by the JAX package's ``cache_partition_specs``."""
    _, shape, res = run
    arch = MODELS[model]
    stub = _stub(shape)
    cfg = ref_cfg(arch, "f32", **OVERS[model])
    batch, _, _ = _serve_inputs(model, SERVE[b_name])
    _, caches = jax.eval_shape(
        lambda p, b: ref_api.prefill(p, cfg, b, MAX),
        _ref_params(arch), to_jax(batch))
    want = {k: _placed(shape, s) for k, s in _ref_flat(ref_cache_specs(
        cfg, stub, ref_default_rules(stub), caches)).items()}
    placed = res[model, b_name, "caches"]
    assert len(placed) == N_STEPS + 1
    assert all(p == want for p in placed)
    if model == "dense" and b_name == "b1" and shape[0] > 1:
        # the sequence-cut cache: its slots (dim 2) over data
        assert want["pos0/k"].startswith("(Shard(dim=2),")


@pytest.mark.parametrize("b_name", list(SERVE))
def test_each_rank_holds_the_dry_runs_bytes(run, b_name):
    """Each rank's local parameter and cache bytes equal the dry run's
    ``argument_bytes`` less its input bytes, at the same mesh."""
    _, shape, res = run
    cfg = port_cfg(MODELS["dense"], "f32", **OVER)
    mesh = mesh_mod.make_mesh(shape, AXES)
    rules = mesh_mod.default_rules(mesh)
    cell = ShapeConfig("mesh_test", MAX, SERVE[b_name], "decode")
    want = (dryrun.argument_bytes(cfg, cell, mesh, rules)
            - dryrun.input_bytes(cfg, cell, mesh, rules))
    assert res["dense", b_name, "bytes"] == [want] * 4


def test_every_activation_site_takes_the_reference_spec(run):
    """Each ``shard_act`` call under the mesh gave the placements of the
    JAX package's ``_divisible_spec`` for its axes and shape."""
    _, shape, res = run
    stub = _stub(shape)
    rules = ref_default_rules(stub)
    sites = res["sites"]
    assert {s[0] for s in sites} >= {
        ("batch", None, None), ("batch", None, "act_heads", None),
        ("batch", "act_heads", None, None), ("batch", None, "act_ffn"),
        ("batch", None, "vocab")}
    for logical, shp, got in sites:
        want = _placed(shape, tuple(ref_divisible_spec(stub, rules, logical,
                                                       shp)))
        assert got == want, (logical, shp)


# ---------------------------------------------------------------------------
# Restore, mesh construction.
# ---------------------------------------------------------------------------

def test_restore_reshards_onto_another_mesh(run):
    """Saved from this mesh, restored onto ``RESTORE``'s: every leaf takes
    the new mesh's spec and the whole tensors equal the saved ones; a
    step built for this mesh refuses to run under the other."""
    name, shape, res = run
    other = RESTORE[name]
    out = res["restore"]
    arch = MODELS["dense"]
    stub = _stub(other)
    specs = _ref_flat(ref_partition_specs(
        ref_api.spec(ref_cfg(arch, "f32", **OVER)), stub,
        ref_default_rules(stub)))
    assert out["step"] == 1
    assert out["placed"] == {k: _placed(other, s) for k, s in specs.items()}
    ref = {"/".join(k.key for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(ref_params_np(arch,
                                                              **OVER))[0]}
    assert out["full"].keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(out["full"][k], v)
    assert out["other_mesh"] == "RuntimeError"


def test_several_axes_cut_one_dim_pod_major(run):
    """P(("pod", "data")) on a (2, 2, 1) device mesh gives rank r the r-th
    quarter, as JAX's row-major device order does."""
    assert run[2]["pod_major"] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_device_mesh_refuses_a_wrong_world_or_a_missing_card(run):
    assert run[2]["mesh_refusals"] == {"world": "ValueError",
                                       "card": "RuntimeError"}


def test_device_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_device_mesh((1, 1), AXES, "cpu")


def test_shard_act_raises_under_the_dry_runs_mesh():
    mesh = mesh_mod.make_mesh((2, 2), AXES)
    with ctx.use_sharding(mesh, mesh_mod.default_rules(mesh)):
        with pytest.raises(NotImplementedError, match="one device"):
            ctx.shard_act(torch.ones(2, 3), "batch", None)


# ---------------------------------------------------------------------------
# placements(): no process group needed.
# ---------------------------------------------------------------------------

MESH_2D = Mesh((2, 4), AXES)
MESH_3D = Mesh((2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("mesh,spec,want", [
    (MESH_2D, P("data", None), (Shard(0), Replicate())),
    (MESH_2D, P(None, "model"), (Replicate(), Shard(1))),
    (MESH_2D, P("model", "data"), (Shard(1), Shard(0))),
    (MESH_2D, P(None, None, None), (Replicate(), Replicate())),
    (MESH_2D, P(), (Replicate(), Replicate())),
    (MESH_3D, P(("pod", "data"), "model"), (Shard(0), Shard(0), Shard(1))),
    (MESH_3D, P(None, ("pod", "data", "model")),
     (Shard(1), Shard(1), Shard(1))),
    (MESH_3D, P("data", None), (Replicate(), Shard(0), Replicate())),
], ids=["one_axis", "second_dim", "both_axes", "unsharded", "empty",
        "pod_data", "all_three", "data_of_three"])
def test_placements_of_a_spec(mesh, spec, want):
    assert placements(mesh, spec) == want


@pytest.mark.parametrize("spec", [P(("data", "pod")), P("data", "data"),
                                  P("expert")],
                         ids=["minor_first", "axis_twice", "unknown_axis"])
def test_placements_refuse_a_spec_dtensor_cannot_hold(spec):
    with pytest.raises(ValueError):
        placements(MESH_3D, spec)


def test_divisible_spec_matches_reference():
    stub = _stub((2, 4))
    rules = MeshRules(fsdp=("data",), tensor=("model",), batch=("data",))
    ref_rules = RefMeshRules(fsdp=("data",), tensor=("model",),
                             batch=("data",))
    for logical, shape in [(("batch", None, "act_heads", None), (4, 8, 2, 16)),
                           (("batch", None, "act_heads", None), (1, 8, 4, 16)),
                           (("batch", "act_heads", None, None), (4, 8, 1, 8)),
                           (("batch", None, "vocab"), (3, 1, 512))]:
        want = tuple(ref_divisible_spec(stub, ref_rules, logical, shape))
        assert tuple(ctx.divisible_spec(stub, rules, logical, shape)) == want
