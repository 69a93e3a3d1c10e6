"""MoE serving sharded over a device mesh, against the JAX package unsharded.

Each mesh — (2,2) and (1,4) over the axes (data, model), and (4,1) for the
grouped dispatch — is one spawn of four gloo ranks
(``torch_lm_mesh_worker.py``, one thread each, a file store under the
test's temporary directory, every join bounded), made when a case first
needs it and shared by the cases after. The models are
``test_torch_lm_mesh.py``'s widths (2 layers, d 64, 4 query and 2 KV
heads, head_dim 16, vocab 512, f32 compute, expert d_ff 128) with the JAX
package's parameters (``params_from_reference``):

- ``granite``: granite-moe's routing, 32 experts, top-8, the global pool
  (EP: 16 experts a rank at (2,2), 8 at (1,4));
- ``etp``: 3 experts, top-2, an expert count no tensor axis divides (ETP:
  each expert's ffn cut);
- ``mixtral``: mixtral's top-2 of its 4 reduced experts, with a sliding
  window of 4 (the decode cache a ring buffer);
- ``grouped``: granite's routing under ``grouped_dispatch`` (G = B, each
  rank its own rows);
- ``drop``: granite's routing at ``capacity_factor`` 0.5, so that
  assignments go to the drop slot.

The reference is the JAX package's unsharded ``forward``, ``prefill``,
``decode_step`` and ``generate`` on the CPU.

Tolerance: ``test_torch_lm_mesh.py``'s, ``atol`` 1e-5 and ``rtol`` 1e-4 on
logits and the aux loss (float32 on both sides; the mesh cuts reductions
differently from one device); tokens and placements exactly. Placements
are held to ``placements(mesh, spec)`` of the JAX package's own spec for
each parameter, cache leaf and activation site, and each rank's resident
bytes to the dry run's ``argument_bytes`` less its input bytes.
"""
import os
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_lm_mesh_worker as worker
from repro.launch.mesh import default_rules as ref_default_rules
from repro.models import api as ref_api
from repro.models.module import partition_specs as ref_partition_specs
from repro.serve.step import generate as ref_generate
from repro.sharding.ctx import _divisible_spec as ref_divisible_spec
from repro.sharding.specs import cache_partition_specs as ref_cache_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding.partition import Mesh, placements
from torch_lm_helpers import (
    batch_np, first_pos, port_cfg, prefix, ref_cfg, ref_decode_fn,
    ref_forward_fn, ref_params_np, ref_prefill_fn, to_jax,
)

ATOL, RTOL = 1e-5, 1e-4
AXES = ("data", "model")
OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
GRANITE = (("n_experts", 32), ("top_k", 8))
MODELS = {
    "granite": ("granite-moe-1b-a400m", dict(OVER, moe=GRANITE)),
    "etp": ("granite-moe-1b-a400m",
            dict(OVER, moe=(("n_experts", 3), ("top_k", 2)))),
    "mixtral": ("mixtral-8x7b", dict(OVER, sliding_window=4)),
    "grouped": ("granite-moe-1b-a400m",
                dict(OVER, moe=GRANITE + (("grouped_dispatch", True),))),
    "drop": ("granite-moe-1b-a400m",
             dict(OVER, moe=GRANITE + (("capacity_factor", 0.5),))),
}
MESHES = {"2x2": ((2, 2), tuple(MODELS)), "1x4": ((1, 4), tuple(MODELS)),
          "4x1": ((4, 1), ("grouped",))}
# where each mesh's checkpoint is restored, and of which model
RESTORE = {"2x2": (1, 4), "1x4": (2, 2), "4x1": (2, 2)}
RESTORE_MODEL = {"2x2": "granite", "1x4": "etp", "4x1": "grouped"}
CASES = [(m, model) for m, (_, models) in MESHES.items()
         for model in models]
B, S, MAX, N_STEPS, N_NEW = 4, 8, 32, 4, 4
SERVE = {"b4": B, "b1": 1}
JOIN_S = 240


def _cfgs(model):
    arch, over = MODELS[model]
    return arch, over, port_cfg(arch, "f32", **over)


def _stub(shape):
    return types.SimpleNamespace(shape=dict(zip(AXES, shape)))


def _serve_inputs(model, b):
    """(prompt batch, teacher-forced decode tokens, first position)."""
    _, _, cfg = _cfgs(model)
    full = batch_np(cfg, seed=b, b=b, s=S + N_STEPS)
    return prefix(full, S), full["tokens"][:, S:], first_pos(cfg, S)


def _job(mesh_name, tmp):
    models = {}
    for name in MESHES[mesh_name][1]:
        arch, over, cfg = _cfgs(name)
        serve = {}
        for b_name, b in SERVE.items():
            batch, feed, first = _serve_inputs(name, b)
            serve[b_name] = {"batch": batch, "feed": feed, "first": first}
        models[name] = {"arch": arch, "over": over,
                        "params": ref_params_np(arch, **over),
                        "batch": batch_np(cfg, b=B, s=S), "serve": serve,
                        "generate": _serve_inputs(name, B)[0]["tokens"]}
    return {"models": models, "max_seq": MAX, "n_new": N_NEW,
            "refused_archs": (), "restore_model": RESTORE_MODEL[mesh_name],
            "restore_shape": RESTORE[mesh_name],
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(mesh name)``: that mesh's spawn, made once (a failed spawn
    fails every case of its mesh without spawning again)."""
    done = {}

    def get(name):
        if name not in done:
            tmp = str(tmp_path_factory.mktemp(f"moe_mesh_{name}"))
            try:
                done[name] = _spawn(MESHES[name][0], _job(name, tmp), tmp)
            except Exception as e:      # noqa: BLE001 - re-raised per case
                done[name] = e
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    return get


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _ref_params(model):
    arch, over, _ = _cfgs(model)
    return jax.tree.map(jnp.asarray, ref_params_np(arch, **over))


def _placed(shape, spec) -> str:
    return repr(placements(Mesh(shape, AXES), spec))


def _ref_flat(tree):
    from jax.sharding import PartitionSpec as RefP
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(k.key for k in path): p for path, p in leaves}


def _param_placements(model, shape):
    arch, over, _ = _cfgs(model)
    stub = _stub(shape)
    specs = _ref_flat(ref_partition_specs(
        ref_api.spec(ref_cfg(arch, "f32", **over)), stub,
        ref_default_rules(stub)))
    return {k: _placed(shape, s) for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Values against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model", CASES)
def test_forward_logits_and_aux_match_reference(runs, mesh, model):
    """Forward logits, and the aux loss, whole and equal on every rank."""
    arch, over, cfg = _cfgs(model)
    want, aux = ref_forward_fn(arch, "f32", **over)(
        _ref_params(model), to_jax(batch_np(cfg, b=B, s=S)))
    res = runs(mesh)
    _close(res[model, "forward"], want)
    got = res[model, "aux"]
    assert len(set(got)) == 1, got
    _close(got[0], float(aux))


@pytest.mark.parametrize("mesh,model", CASES)
@pytest.mark.parametrize("b_name", list(SERVE))
def test_prefill_and_decode_match_reference(runs, mesh, model, b_name):
    """Prefill, then four donating decode steps; ``b1`` is batch 1, whose
    single group no data axis cuts."""
    arch, over, _ = _cfgs(model)
    batch, feed, first = _serve_inputs(model, SERVE[b_name])
    params = _ref_params(model)
    logits, caches = ref_prefill_fn(arch, "f32", MAX, **over)(
        params, to_jax(batch))
    res = runs(mesh)
    _close(res[model, b_name, "prefill"], logits[:, -1:])
    dec = ref_decode_fn(arch, "f32", **over)
    got = res[model, b_name, "decode"]
    assert len(got) == N_STEPS
    for i, lg in enumerate(got):
        want, caches = dec(params, caches, jnp.asarray(feed[:, i:i + 1]),
                           jnp.int32(first + i))
        _close(lg, want)


@pytest.mark.parametrize("mesh,model", CASES)
def test_generate_matches_reference(runs, mesh, model):
    arch, over, _ = _cfgs(model)
    prompt = _serve_inputs(model, B)[0]["tokens"]
    want = ref_generate(_ref_params(model), ref_cfg(arch, "f32", **over),
                        jnp.asarray(prompt), N_NEW, MAX)
    np.testing.assert_array_equal(runs(mesh)[model, "generate"],
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# Placements and bytes against the JAX package's specs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model", CASES)
def test_parameters_take_the_reference_placements(runs, mesh, model):
    shape = MESHES[mesh][0]
    assert runs(mesh)[model, "params"] == _param_placements(model, shape)


@pytest.mark.parametrize("mesh,want", [
    ("2x2", {"granite": "Shard(dim=1)", "etp": "Shard(dim=3)"}),
    ("1x4", {"granite": "Shard(dim=1)", "etp": "Shard(dim=3)"})])
def test_expert_weights_are_cut_by_expert_or_by_ffn(runs, mesh, want):
    """EP where the expert count divides the tensor axis (granite's 32
    experts), ETP where it does not (3 experts): ``w_gate`` [L, E, d, f]
    cut over ``model`` along E, or along f."""
    placed = runs(mesh)
    for model, cut in want.items():
        got = placed[model, "params"]["blocks/pos0/moe/w_gate"]
        assert got.endswith(f"{cut})"), (model, got)


@pytest.mark.parametrize("mesh,model", CASES)
@pytest.mark.parametrize("b_name", list(SERVE))
def test_caches_keep_the_reference_placements_through_decode(
        runs, mesh, model, b_name):
    """After prefill and after each donating decode step, every cache leaf
    is laid out by the JAX package's ``cache_partition_specs``."""
    shape = MESHES[mesh][0]
    arch, over, _ = _cfgs(model)
    stub = _stub(shape)
    cfg = ref_cfg(arch, "f32", **over)
    batch, _, _ = _serve_inputs(model, SERVE[b_name])
    _, caches = jax.eval_shape(
        lambda p, b: ref_api.prefill(p, cfg, b, MAX),
        _ref_params(model), to_jax(batch))
    want = {k: _placed(shape, s) for k, s in _ref_flat(ref_cache_specs(
        cfg, stub, ref_default_rules(stub), caches)).items()}
    placed = runs(mesh)[model, b_name, "caches"]
    assert len(placed) == N_STEPS + 1
    assert all(p == want for p in placed)


@pytest.mark.parametrize("mesh,model", CASES)
@pytest.mark.parametrize("b_name", list(SERVE))
def test_each_rank_holds_the_dry_runs_bytes(runs, mesh, model, b_name):
    """Each rank's local parameter and cache bytes equal the dry run's
    ``argument_bytes`` less its input bytes, at the same mesh."""
    shape = MESHES[mesh][0]
    _, _, cfg = _cfgs(model)
    m = mesh_mod.make_mesh(shape, AXES)
    rules = mesh_mod.default_rules(m)
    cell = ShapeConfig("moe_mesh_test", MAX, SERVE[b_name], "decode")
    want = (dryrun.argument_bytes(cfg, cell, m, rules)
            - dryrun.input_bytes(cfg, cell, m, rules))
    assert runs(mesh)[model, b_name, "bytes"] == [want] * 4


MOE_SITES = {("batch", "act_experts", None, None),
             ("batch", "act_experts", None, "act_ffn"),
             ("batch", None, None)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_activation_site_takes_the_reference_spec(runs, mesh):
    """Each ``shard_act`` call under the mesh, the MoE dispatch's five
    sites among them, gave the placements of the JAX package's
    ``_divisible_spec`` for its axes and shape."""
    shape = MESHES[mesh][0]
    stub = _stub(shape)
    rules = ref_default_rules(stub)
    sites = runs(mesh)["sites"]
    assert {s[0] for s in sites} >= MOE_SITES
    for logical, shp, got in sites:
        want = _placed(shape, tuple(ref_divisible_spec(stub, rules, logical,
                                                       shp)))
        assert got == want, (logical, shp)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_the_expert_site_is_cut_by_expert_and_by_ffn(runs, mesh):
    """The ``h`` site [G, E, C, f] took the tensor axis on its experts
    (granite's 32) and on its ffn (3 experts): EP and ETP both ran."""
    hs = {got for logical, _, got in runs(mesh)["sites"]
          if logical == ("batch", "act_experts", None, "act_ffn")}
    assert any(g.endswith("Shard(dim=1))") for g in hs), hs
    assert any(g.endswith("Shard(dim=3))") for g in hs), hs


# ---------------------------------------------------------------------------
# Restore onto another mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_restore_reshards_onto_another_mesh(runs, mesh):
    """Saved from this mesh, restored onto ``RESTORE``'s: every leaf takes
    the new mesh's spec (EP or ETP there) and the whole tensors equal the
    saved ones; a step built for this mesh refuses to run under the
    other."""
    out = runs(mesh)["restore"]
    model = RESTORE_MODEL[mesh]
    arch, over, _ = _cfgs(model)
    assert out["step"] == 1
    assert out["placed"] == _param_placements(model, RESTORE[mesh])
    ref = {"/".join(k.key for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(ref_params_np(arch,
                                                              **over))[0]}
    assert out["full"].keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(out["full"][k], v)
    assert out["other_mesh"] == "RuntimeError"
