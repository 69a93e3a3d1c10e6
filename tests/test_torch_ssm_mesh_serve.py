"""Serving of the recurrent families sharded over a device mesh, against
the JAX package unsharded.

Each mesh — (2,2), (1,4) and (4,1) over the axes (data, model) — is one
spawn of four gloo ranks (``torch_lm_mesh_worker.py``, one thread each,
a file store under the test's temporary directory, every join bounded),
made when a case first needs it and shared by the cases after. The
models are ``test_torch_lm_mesh.py``'s widths (d 64, f32 compute, vocab
512) with the JAX package's parameters (``params_from_reference``):

- ``rwkv``: rwkv6-7b's block at ``rwkv_head_dim`` 16, so 4 WKV heads (one
  a rank at (1,4)), 2 layers;
- ``jamba``: jamba-v0.1-52b's own interleave at 8 layers (attention at
  index 4, the MoE every other layer, 4 experts top-2, the rest Mamba),
  at (2,2), where both axes cut it;
- ``jamba2``: ``attn_every=2, attn_index=1`` at 2 layers, one Mamba + MLP
  position and one attention + MoE position (the card's gate).

Each serves batch 4 on an 8-token prompt, rwkv and the gate batch 1 on
it too, and jamba's models batch 4 on a 2-token prompt (``p2``: shorter than the conv window, so
the prefill pads the Mamba state window on each rank's shard). The
reference is the JAX package's unsharded ``forward``, ``prefill``,
``decode_step`` and ``generate`` on the CPU.

Tolerances (float32 on both sides; the mesh cuts the contractions
differently from one device):
- logits: ``test_torch_lm_mesh.py``'s, ``atol`` 1e-5 and ``rtol`` 1e-4;
- the recurrent states after prefill and after the last decode: each
  within 1e-4 of its leaf's largest |value| (``F32_TOL``, the gradients'
  measure). Element by element they miss ``atol`` 1e-5 deep in jamba's
  8 layers, where a Mamba window (values up to ~3) differs from the JAX
  package's by up to 2.6e-5 in an element near zero (the unsharded
  port's by up to 6.4e-6);
- tokens, placements, bytes and the states' storage exactly. Placements
  are held to ``placements(mesh, spec)`` of the JAX package's own spec
  for each parameter, cache leaf and activation site, and each rank's
  resident bytes to the dry run's ``argument_bytes`` less its input
  bytes.
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
    F32_TOL, batch_np, first_pos, port_cfg, prefix, ref_cfg, ref_decode_fn,
    ref_forward_fn, ref_params_np, ref_prefill_fn, to_jax,
)

ATOL, RTOL = 1e-5, 1e-4
AXES = ("data", "model")
OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
MODELS = {
    "rwkv": ("rwkv6-7b", dict(OVER, ssm=(("rwkv_head_dim", 16),))),
    "jamba": ("jamba-v0.1-52b", dict(OVER, n_layers=8)),
    "jamba2": ("jamba-v0.1-52b", dict(OVER, attn_every=2, attn_index=1)),
}
# (2,2) takes every model; (1,4) and (4,1) the two 2-layer ones (the
# 8-layer interleave runs where both axes cut it: four gloo ranks a spawn
# beside the suite's other spawns load every core)
MESHES = {"2x2": ((2, 2), tuple(MODELS)), "1x4": ((1, 4), ("rwkv", "jamba2")),
          "4x1": ((4, 1), ("rwkv", "jamba2"))}
# where each mesh's checkpoint is restored, and of which model
RESTORE = {"2x2": (1, 4), "1x4": (4, 1), "4x1": (2, 2)}
RESTORE_MODEL = {"2x2": "rwkv", "1x4": "jamba2", "4x1": "jamba2"}
CASES = [(m, model) for m, (_, models) in MESHES.items()
         for model in models]
S, MAX, N_STEPS, N_NEW = 8, 32, 4, 4
SERVE = {"b4": (4, S), "b1": (1, S), "p2": (4, 2)}   # batch, prompt
# jamba's models serve the 2-token prompt (its Mamba window padded), the
# 8-layer one not batch 1; rwkv's logits at positions 0-1 are
# ill-conditioned in f32 (the group norm of near-zero WKV outputs: the
# JAX package's own f32 logits there are 1.6e-5 from float64), so rwkv is
# held at the 8-token prompts
SERVED = {"rwkv": ("b4", "b1"), "jamba": ("b4", "p2"),
          "jamba2": tuple(SERVE)}
SERVE_CASES = [(m, model, b) for m, model in CASES for b in SERVED[model]]
JOIN_S = 300


def _cfgs(model):
    arch, over = MODELS[model]
    return arch, over, port_cfg(arch, "f32", **over)


def _stub(shape):
    return types.SimpleNamespace(shape=dict(zip(AXES, shape)))


def _serve_inputs(model, b_name):
    """(prompt batch, teacher-forced decode tokens, first position)."""
    _, _, cfg = _cfgs(model)
    b, s = SERVE[b_name]
    full = batch_np(cfg, seed=b + s, b=b, s=s + N_STEPS)
    return prefix(full, s), full["tokens"][:, s:], first_pos(cfg, s)


def _job(mesh_name, tmp):
    models = {}
    for name in MESHES[mesh_name][1]:
        arch, over, cfg = _cfgs(name)
        serve = {}
        for b_name in SERVED[name]:
            batch, feed, first = _serve_inputs(name, b_name)
            serve[b_name] = {"batch": batch, "feed": feed, "first": first}
        models[name] = {"arch": arch, "over": over,
                        "params": ref_params_np(arch, **over),
                        "batch": batch_np(cfg, b=4, s=S), "serve": serve,
                        "generate": _serve_inputs(name, "b4")[0]["tokens"]}
    return {"models": models, "max_seq": MAX, "n_new": N_NEW,
            "states": True, "restore_model": RESTORE_MODEL[mesh_name],
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
            tmp = str(tmp_path_factory.mktemp(f"ssm_mesh_{name}"))
            try:
                done[name] = _spawn(MESHES[name][0], _job(name, tmp), tmp)
            except Exception as e:      # noqa: BLE001 - re-raised per case
                done[name] = e
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    return get


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


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


STATES = ("conv", "h", "wkv", "shift_t", "shift_c")


def _states_close(got, want):
    """Every recurrent state (the Mamba conv window and SSM state, the WKV
    state and the token shifts; jamba's KV caches are held by the logits
    and their placements), each within ``F32_TOL`` of its leaf's largest
    |value|."""
    want = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got.keys() == want.keys()
    names = [k for k in want if k.split("/")[-1] in STATES]
    assert names
    for k in names:
        w = want[k].astype(np.float64)
        err = np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-30)
        assert err < F32_TOL, (k, err)


# ---------------------------------------------------------------------------
# Values against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model", CASES)
def test_forward_logits_match_reference(runs, mesh, model):
    arch, over, cfg = _cfgs(model)
    want, _ = ref_forward_fn(arch, "f32", **over)(
        _ref_params(model), to_jax(batch_np(cfg, b=4, s=S)))
    _close(runs(mesh)[model, "forward"], want)


@pytest.mark.parametrize("mesh,model,b_name", SERVE_CASES)
def test_prefill_decode_and_states_match_reference(runs, mesh, model,
                                                   b_name):
    """Prefill, then four donating decode steps: the logits of each, and
    every cache leaf after prefill and after the last step. ``b1`` is
    batch 1, which no data axis cuts; ``p2`` a 2-token prompt."""
    arch, over, _ = _cfgs(model)
    batch, feed, first = _serve_inputs(model, b_name)
    params = _ref_params(model)
    logits, caches = ref_prefill_fn(arch, "f32", MAX, **over)(
        params, to_jax(batch))
    res = runs(mesh)
    _close(res[model, b_name, "prefill"], logits[:, -1:])
    states = res[model, b_name, "states"]
    _states_close(states["prefill"], caches)
    dec = ref_decode_fn(arch, "f32", **over)
    got = res[model, b_name, "decode"]
    assert len(got) == N_STEPS
    for i, lg in enumerate(got):
        want, caches = dec(params, caches, jnp.asarray(feed[:, i:i + 1]),
                           jnp.int32(first + i))
        _close(lg, want)
    _states_close(states["decode"], caches)


@pytest.mark.parametrize("mesh,model", CASES)
def test_generate_matches_reference(runs, mesh, model):
    arch, over, _ = _cfgs(model)
    prompt = _serve_inputs(model, "b4")[0]["tokens"]
    want = ref_generate(_ref_params(model), ref_cfg(arch, "f32", **over),
                        jnp.asarray(prompt), N_NEW, MAX)
    np.testing.assert_array_equal(runs(mesh)[model, "generate"],
                                  np.asarray(want))


@pytest.mark.parametrize("mesh,model,b_name", SERVE_CASES)
def test_donating_decode_writes_the_states_in_place(runs, mesh, model,
                                                    b_name):
    """After four donating decode steps every cache leaf's local shard, on
    every rank, is the storage the prefill made (``data_ptr``): each rank
    wrote its own shard, nothing was gathered or replaced."""
    assert runs(mesh)[model, b_name, "states"]["in_place"] == [True] * 4


# ---------------------------------------------------------------------------
# Placements and bytes against the JAX package's specs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model", CASES)
def test_parameters_take_the_reference_placements(runs, mesh, model):
    assert runs(mesh)[model, "params"] == _param_placements(model,
                                                            MESHES[mesh][0])


@pytest.mark.parametrize("mesh,model,b_name", SERVE_CASES)
def test_caches_keep_the_reference_placements_through_decode(
        runs, mesh, model, b_name):
    """After prefill and after each donating decode step, every cache leaf
    is laid out by the JAX package's ``cache_partition_specs``."""
    shape = MESHES[mesh][0]
    arch, over, _ = _cfgs(model)
    stub = _stub(shape)
    cfg = ref_cfg(arch, "f32", **over)
    batch, _, _ = _serve_inputs(model, b_name)
    _, caches = jax.eval_shape(
        lambda p, b: ref_api.prefill(p, cfg, b, MAX),
        _ref_params(model), to_jax(batch))
    want = {k: _placed(shape, s) for k, s in _ref_flat(ref_cache_specs(
        cfg, stub, ref_default_rules(stub), caches)).items()}
    placed = runs(mesh)[model, b_name, "caches"]
    assert len(placed) == N_STEPS + 1
    assert all(p == want for p in placed)


@pytest.mark.parametrize("model,leaf,want", [
    ("rwkv", "pos0/wkv", "(Replicate(), Shard(dim=2))"),
    ("rwkv", "pos0/shift_t", "(Replicate(), Replicate())"),
    ("jamba2", "pos0/conv", "(Replicate(), Shard(dim=3))"),
    ("jamba2", "pos0/h", "(Replicate(), Shard(dim=2))")])
def test_recurrent_states_are_cut_over_the_tensor_axis(runs, model, leaf,
                                                       want):
    """At (1,4) the WKV state is cut on its heads and the Mamba states on
    their channels (one rank a quarter); the token shifts stay whole."""
    assert runs("1x4")[model, "b4", "caches"][-1][leaf] == want


@pytest.mark.parametrize("mesh,model,b_name", SERVE_CASES)
def test_each_rank_holds_the_dry_runs_bytes(runs, mesh, model, b_name):
    """Each rank's local parameter and cache bytes equal the dry run's
    ``argument_bytes`` less its input bytes, at the same mesh."""
    _, _, cfg = _cfgs(model)
    m = mesh_mod.make_mesh(MESHES[mesh][0], AXES)
    rules = mesh_mod.default_rules(m)
    cell = ShapeConfig("ssm_mesh_test", MAX, SERVE[b_name][0], "decode")
    want = (dryrun.argument_bytes(cfg, cell, m, rules)
            - dryrun.input_bytes(cfg, cell, m, rules))
    assert runs(mesh)[model, b_name, "bytes"] == [want] * 4


SSM_SITES = {("batch", None, "act_heads"), ("batch", None, "act_ffn"),
             ("batch", None, None)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_activation_site_takes_the_reference_spec(runs, mesh):
    """Each ``shard_act`` call under the mesh, the recurrent mixers' sites
    among them (rwkv's r, k, v, g and channel-mix k; Mamba's xz), gave the
    placements of the JAX package's ``_divisible_spec`` for its axes and
    shape."""
    shape = MESHES[mesh][0]
    stub = _stub(shape)
    rules = ref_default_rules(stub)
    sites = runs(mesh)["sites"]
    assert {s[0] for s in sites} >= SSM_SITES
    for logical, shp, got in sites:
        want = _placed(shape, tuple(ref_divisible_spec(stub, rules, logical,
                                                       shp)))
        assert got == want, (logical, shp)


# ---------------------------------------------------------------------------
# Restore onto another mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_restore_reshards_onto_another_mesh(runs, mesh):
    """Saved from this mesh, restored onto ``RESTORE``'s: every leaf takes
    the new mesh's spec and the whole tensors equal the saved ones; a step
    built for this mesh refuses to run under the other."""
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
