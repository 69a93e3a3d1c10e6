"""MoE training sharded over a device mesh, against the JAX package unsharded.

Each mesh — (2,2) and (1,4) over the axes (data, model), and (4,1) for the
grouped dispatch — is one spawn of four gloo ranks
(``torch_train_mesh_worker.py``, one thread each, a file store under the
test's temporary directory, every join bounded), made when a case first
needs it and shared by the cases after. The models are
``test_torch_moe_mesh_serve.py``'s (granite's routing with EP, 3 experts
with ETP, mixtral's top-2 with a sliding window, the grouped dispatch, a
capacity drop; 2 layers, d 64, f32 compute) with the JAX package's
parameters (``params_from_reference``); batch 4, seq 8. The reference is
the JAX package's unsharded ``value_and_grad(_loss_fn)``, ``forward``'s
aux loss and ``make_train_step`` on the CPU. granite at (2,2) also runs
the remat policies (the backward, so each MoE block's recompute, on
another thread too) and a restore of its state onto (1,4).

Tolerances (``test_torch_train_mesh.py``'s):
- loss, grad norm and the aux loss rel 1e-4, each gradient within 1e-4 of
  its leaf's largest |g| (``F32_TOL``): f32 on both sides, the mesh sums
  in another order than one device;
- parameters after 3 AdamW steps at lr 1e-3: atol 5e-3
  (``tests/test_train_substrate.py:65``);
- remat none/full/dots and a restored state: rel 1e-6;
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
from test_torch_moe_mesh_serve import MODELS
from torch_lm_helpers import F32_TOL, port_cfg, ref_cfg, ref_params_np

AXES = ("data", "model")
# (2,2) takes every model; (1,4) the routings whose cut differs there
# (8 experts a rank, ffn cut four ways, mixtral's 1 expert a rank); (4,1)
# the grouped dispatch, each rank one batch row's group
MESHES = {"2x2": ((2, 2), tuple(MODELS)),
          "1x4": ((1, 4), ("granite", "etp", "mixtral")),
          "4x1": ((4, 1), ("grouped",))}
# granite at (2,2) also runs the remat policies and a restore of its
# state onto (1,4)
EXTRAS = {"2x2": ("granite", ("remat", "restore")),
          "1x4": ("granite", ()), "4x1": ("grouped", ())}
RESTORE = (1, 4)
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


def _job(tmp, name):
    models = {}
    for m in MESHES[name][1]:
        arch, over, _ = _cfgs(m)
        models[m] = {"arch": arch, "over": over,
                     "params": ref_params_np(arch, **over),
                     "batch": _batch(m)}
    model, extras = EXTRAS[name]
    return {"models": models, "opt": OPT, "extras_model": model,
            "extras": extras, "refused_archs": (), "restore_shape": RESTORE,
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
            tmp = str(tmp_path_factory.mktemp(f"moe_train_{name}"))
            try:
                done[name] = _spawn(MESHES[name][0], _job(tmp, name), tmp)
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
    """(grads, metrics a step, params after 3 steps, forward's aux) of the
    JAX package."""
    arch, over, cfg = _cfgs(model)
    params = jax.tree.map(jnp.asarray, ref_params_np(arch, **over))
    batch = {k: jnp.asarray(v) for k, v in _batch(model).items()}
    (_, (loss, _)), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, cfg, b), has_aux=True))(params, batch)
    aux = float(ref_api.forward(params, cfg, {"tokens": batch["tokens"]})[1])
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
    _, metrics, _, aux = _ref(model)
    got = runs(mesh)[model]
    _metrics_close(got["metrics"][0], metrics[0])
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
    spec)`` of the JAX package's spec (the expert weights cut by expert
    or by ffn over ``model``); the count and the step replicated."""
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
    shape = MESHES[mesh][0]
    arch, over, _ = _cfgs(model)
    cfg = port_cfg(arch, "f32", **over)
    m = mesh_mod.make_mesh(shape, AXES)
    rules = mesh_mod.default_rules(m)
    cell = ShapeConfig("moe_train_mesh", S, B, "train")
    want = (dryrun.argument_bytes(cfg, cell, m, rules)
            - dryrun.input_bytes(cfg, cell, m, rules))
    assert runs(mesh)[model]["bytes"] == [want] * 4


# ---------------------------------------------------------------------------
# Remat and restore (granite at (2,2)).
# ---------------------------------------------------------------------------

def test_remat_policies_give_the_same_gradients(runs):
    got = runs("2x2")["remat"]
    for policy in ("full", "dots"):
        for k, w in got["none"].items():
            assert _rel(got[policy][k], w) <= SAME_RTOL, (policy, k)
    grads, _, _, _ = _ref("granite")
    _grads_close(got["full"], grads)


def test_moe_recompute_on_another_thread_keeps_the_mesh(runs):
    """The backward on another thread than the forward (as the card's
    autograd engine runs it): each MoE block's recompute sees the
    forward's mesh; the gradients equal one thread's, in the parameters'
    placements."""
    got = runs("2x2")["remat"]
    for k, w in got["full"].items():
        assert _rel(got["full_thread"][k], w) <= SAME_RTOL, k
    assert got["full_thread_placed"] == _want_placed("granite", (2, 2))


def test_restore_onto_another_mesh_continues_the_run(runs):
    """The state after one step at (2,2), saved and restored onto (1,4):
    placements there (16 experts a rank become 8), and the next step there
    equal to the next step of the live state laid out on that mesh (and to
    this mesh's next step within the mesh tolerances)."""
    got = runs("2x2")["restore"]
    want = _want_placed("granite", RESTORE)
    assert got["saved"] == 1
    for k in ("params", "m", "v"):
        assert got["placed"][k] == want, k
    assert got["placed"]["count"] == REPLICATED
    for k in ("loss", "grad_norm", "acc"):
        assert abs(got["back"][k] - got["moved"][k]) <= SAME_RTOL * abs(
            got["moved"][k]), k
    for k, w in got["moved_params"].items():
        assert _rel(got["back_params"][k], w) <= SAME_RTOL, k
    _metrics_close(got["back"], got["live"])
    _params_close(got["back_params"], got["live_params"])
    assert got["other_mesh"] == "RuntimeError"
