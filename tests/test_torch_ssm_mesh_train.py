"""Training of the recurrent families sharded over a device mesh, against
the JAX package unsharded.

Each mesh — (2,2), (1,4) and (4,1) over the axes (data, model) — is one
spawn of four gloo ranks (``torch_train_mesh_worker.py``, one thread each,
a file store under the test's temporary directory, every join bounded),
made when a case first needs it and shared by the cases after. The
models are ``test_torch_ssm_mesh_serve.py``'s (rwkv6-7b's block at 4 WKV
heads, jamba's own 8-layer interleave at (2,2), and its 2-layer gate,
here with ``loss_chunk`` 4 so the chunked loss runs on the mesh; d 64,
f32 compute) with the JAX package's parameters (``params_from_reference``);
batch 4, seq 8. The reference is the JAX package's unsharded
``value_and_grad(_loss_fn)``, ``forward``'s aux loss and
``make_train_step`` on the CPU. rwkv at (2,2) also runs the remat
policies (the backward, so each recurrent block's recompute, on another
thread too). Restoring a sharded train state onto
another mesh is the checkpoint's, whatever the family
(``test_torch_train_mesh.py``, ``test_torch_moe_mesh_train.py``).

Tolerances (``test_torch_train_mesh.py``'s):
- loss, grad norm and the aux loss rel 1e-4, each gradient within 1e-4 of
  its leaf's largest |g| (``F32_TOL``): f32 on both sides, the mesh sums
  in another order than one device;
- parameters after 3 AdamW steps at lr 1e-3: atol 5e-3
  (``tests/test_train_substrate.py:65``);
- remat none/full/dots: rel 1e-6;
- placements and bytes: exactly.
"""
import functools
import os
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_train_mesh_worker as worker
from repro.launch.mesh import default_rules as ref_default_rules
from repro.models import api as ref_api
from repro.models.module import partition_specs as ref_partition_specs
from repro.optim.adamw import AdamW as RefAdamW
from repro.train.step import _loss_fn as ref_loss_fn
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding.partition import Mesh, placements
from test_torch_ssm_mesh_serve import MODELS as SERVED
from torch_lm_helpers import F32_TOL, port_cfg, ref_cfg, ref_params_np

AXES = ("data", "model")
MODELS = dict(SERVED)
MODELS["jamba2"] = (SERVED["jamba2"][0], dict(SERVED["jamba2"][1],
                                              loss_chunk=4))
# (2,2) takes every model; (1,4) and (4,1) the two 2-layer ones (jamba's
# 8-layer interleave, a minute of training a mesh on four gloo ranks, runs
# where both axes cut it)
MESHES = {"2x2": ((2, 2), tuple(MODELS)), "1x4": ((1, 4), ("rwkv", "jamba2")),
          "4x1": ((4, 1), ("rwkv", "jamba2"))}
# the model of each mesh that also runs the extras, and which
EXTRAS = {"2x2": ("rwkv", ("remat",)), "1x4": ("jamba2", ()),
          "4x1": ("jamba2", ())}
CASES = [(m, model) for m, (_, models) in MESHES.items()
         for model in models]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 4, 8
LOSS_RTOL = 1e-4
PARAM_ATOL = 5e-3       # tests/test_train_substrate.py:65, lr 1e-3
SAME_RTOL = 1e-6
JOIN_S = 300
REPLICATED = "(Replicate(), Replicate())"


def _cfgs(model):
    arch, over = MODELS[model]
    return arch, over, ref_cfg(arch, "f32", **over)


def _batch(model):
    """tokens/labels [B, S] from seed 0."""
    cfg = _cfgs(model)[2]
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _job(name):
    models = {}
    for m in MESHES[name][1]:
        arch, over, _ = _cfgs(m)
        models[m] = {"arch": arch, "over": over,
                     "params": ref_params_np(arch, **over),
                     "batch": _batch(m)}
    model, extras = EXTRAS[name]
    return {"models": models, "opt": OPT, "extras_model": model,
            "extras": extras}


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
            tmp = str(tmp_path_factory.mktemp(f"ssm_train_{name}"))
            try:
                done[name] = _spawn(MESHES[name][0], _job(name), tmp)
            except Exception as e:      # noqa: BLE001 - re-raised per case
                done[name] = e
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    return get


# ---------------------------------------------------------------------------
# The JAX package, unsharded (cached: every mesh holds to the same values).
# ---------------------------------------------------------------------------

def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ref(model):
    """(grads, metrics a step, params after 3 steps, forward's aux or None
    without experts) of the JAX package."""
    arch, over, cfg = _cfgs(model)
    params = jax.tree.map(jnp.asarray, ref_params_np(arch, **over))
    batch = {k: jnp.asarray(v) for k, v in _batch(model).items()}
    (_, (loss, _)), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, cfg, b), has_aux=True))(params, batch)
    aux = None if cfg.moe is None else float(
        ref_api.forward(params, cfg, {"tokens": batch["tokens"]})[1])
    opt = RefAdamW(**OPT)
    step = jax.jit(ref_make_train_step(cfg, opt))
    state = ref_init_state(params, opt)
    metrics = []
    for _ in range(worker.N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return _flat(grads), metrics, _flat(state.params), aux


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _grads_close(got, want, tol=F32_TOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel(got[k], w) < tol, (k, _rel(got[k], w))


def _params_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def _metrics_close(got, want):
    for k in ("loss", "grad_norm"):
        assert abs(got[k] / want[k] - 1) < LOSS_RTOL, (k, got[k], want[k])


def _want_placed(model, shape):
    """Each parameter's placements from the JAX package's own spec."""
    from jax.sharding import PartitionSpec as RefP
    stub = types.SimpleNamespace(shape=dict(zip(AXES, shape)))
    specs = ref_partition_specs(ref_api.spec(_cfgs(model)[2]), stub,
                                ref_default_rules(stub))
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    mesh = Mesh(shape, AXES)
    return {"/".join(k.key for k in path): repr(placements(mesh, p))
            for path, p in leaves}


# ---------------------------------------------------------------------------
# Values and layout of every model, on every mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,model", CASES)
def test_loss_grad_norm_and_aux_match_reference(runs, mesh, model):
    """Step 1's loss and grad norm; jamba's MoE aux loss, whole and equal
    on every rank."""
    _, metrics, _, aux = _ref(model)
    got = runs(mesh)[model]
    _metrics_close(got["metrics"][0], metrics[0])
    assert (aux is None) == ("aux" not in got)
    if aux is not None:
        assert len(set(got["aux"])) == 1, got["aux"]
        assert abs(got["aux"][0] / aux - 1) < LOSS_RTOL, (got["aux"], aux)


@pytest.mark.parametrize("mesh,model", CASES)
def test_gradients_match_reference(runs, mesh, model):
    grads, _, _, _ = _ref(model)
    _grads_close(runs(mesh)[model]["grads"], grads)


@pytest.mark.parametrize("mesh,model", CASES)
def test_params_after_three_adamw_steps_match_reference(runs, mesh, model):
    _, metrics, params, _ = _ref(model)
    got = runs(mesh)[model]
    for g, w in zip(got["metrics"], metrics):
        _metrics_close(g, w)
        assert g["step"] == w["step"]
    _params_close(got["params"], params)


@pytest.mark.parametrize("mesh,model", CASES)
def test_gradients_and_moments_take_the_parameters_placements(runs, mesh,
                                                              model):
    """Every gradient, m and v in its parameter's ``placements(mesh,
    spec)`` of the JAX package's spec (the scans' leaves cut on their
    channels or heads over ``model``); the count and the step
    replicated."""
    want = _want_placed(model, MESHES[mesh][0])
    got = runs(mesh)[model]
    assert got["grad_placed"] == want
    for k in ("params", "m", "v"):
        assert got["state_placed"][k] == want, k
    assert got["state_placed"]["count"] == REPLICATED
    assert got["state_placed"]["step"] == REPLICATED


@pytest.mark.parametrize("mesh,model", CASES)
def test_each_rank_holds_the_dry_runs_train_state_bytes(runs, mesh, model):
    """Each rank's local bytes of params, m, v, count and step equal the
    dry run's train ``argument_bytes`` less its inputs."""
    arch, over, _ = _cfgs(model)
    cfg = port_cfg(arch, "f32", **over)
    m = mesh_mod.make_mesh(MESHES[mesh][0], AXES)
    rules = mesh_mod.default_rules(m)
    cell = ShapeConfig("ssm_train_mesh", S, B, "train")
    want = (dryrun.argument_bytes(cfg, cell, m, rules)
            - dryrun.input_bytes(cfg, cell, m, rules))
    assert runs(mesh)[model]["bytes"] == [want] * 4


# ---------------------------------------------------------------------------
# Remat (rwkv at (2,2)).
# ---------------------------------------------------------------------------

REMAT = [m for m, (_, extras) in EXTRAS.items() if "remat" in extras]


@pytest.mark.parametrize("mesh", REMAT)
def test_remat_policies_give_the_same_gradients(runs, mesh):
    got = runs(mesh)["remat"]
    for policy in ("full", "dots"):
        for k, w in got["none"].items():
            assert _rel(got[policy][k], w) <= SAME_RTOL, (policy, k)
    grads, _, _, _ = _ref(EXTRAS[mesh][0])
    _grads_close(got["full"], grads)


@pytest.mark.parametrize("mesh", REMAT)
def test_recurrent_recompute_on_another_thread_keeps_the_mesh(runs, mesh):
    """The backward on another thread than the forward (as the card's
    autograd engine runs it): each recurrent block's recompute sees the
    forward's mesh; the gradients equal one thread's, in the parameters'
    placements."""
    got = runs(mesh)["remat"]
    for k, w in got["full"].items():
        assert _rel(got["full_thread"][k], w) <= SAME_RTOL, k
    assert got["full_thread_placed"] == _want_placed(EXTRAS[mesh][0],
                                                     MESHES[mesh][0])
