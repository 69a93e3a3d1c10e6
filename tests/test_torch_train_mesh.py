"""LM training sharded over a device mesh, against the JAX package unsharded.

Each mesh — (2,2), (1,4) and (4,1) over the axes (data, model) — is one
spawn of four gloo ranks (``torch_train_mesh_worker.py``, one thread each,
a file store under the test's temporary directory, every join bounded),
shared by the cases below. The models are ``test_torch_lm_mesh.py``'s
widths (2 layers, d 64, 4 query and 2 KV heads, head_dim 16, d_ff 128,
vocab 512, f32 compute) of qwen3-1.7b, phi-3-vision-4.2b and
whisper-small, plus qwen3 on the chunked-attention path and with
``loss_chunk`` 4, with the JAX package's parameters
(``params_from_reference``); batch 4, seq 8. The reference is the JAX
package's unsharded ``value_and_grad(_loss_fn)`` and ``make_train_step``
on the CPU. Each spawn also runs qwen3's train step on a (2,2,1) mesh
over (pod, data, model), the JAX dry run's multi-pod train cell, and
``compressed_psum`` over the data group of a (2,2) mesh and over the
world.

Tolerances (``tests/test_torch_train.py``'s, and why):
- loss and grad norm rel 1e-4, each gradient within 1e-4 of its leaf's
  largest |g| (``F32_TOL``): f32 on both sides, the mesh sums in another
  order than one device.
- parameters after 3 AdamW steps at lr 1e-3: atol 5e-3
  (``tests/test_train_substrate.py:65``; AdamW's first step moves a
  parameter by ≈ lr·sign(g)).
- remat none/full/dots, and a checkpoint restored onto another mesh: rel
  1e-6 (recompute and restore change memory and layout, not values).
- placements, bytes, int8 codes, error-feedback residuals and the
  ``compressed_psum`` results: exactly.
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
import torch
import torch.multiprocessing as mp

import torch_train_mesh_worker as worker
from repro.launch.mesh import default_rules as ref_default_rules
from repro.models import api as ref_api
from repro.models.module import partition_specs as ref_partition_specs
from repro.optim import compression as ref_comp
from repro.optim.adamw import AdamW as RefAdamW
from repro.train.step import _loss_fn as ref_loss_fn
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import compression as comp
from repro_torch.sharding.partition import Mesh, placements
from torch_lm_helpers import F32_TOL, port_cfg, ref_cfg, ref_params_np

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# where each mesh's train state is restored: (2,2) → (4,1), and round
RESTORE = {"2x2": (4, 1), "1x4": (2, 2), "4x1": (1, 4)}
OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128)
MODELS = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
          "audio": "whisper-small", "chunked": "qwen3-1.7b",
          "loss_chunk": "qwen3-1.7b"}
OVERS = {m: OVER for m in MODELS}
OVERS["chunked"] = dict(OVER, chunked_attn_threshold=8, attn_chunk_q=4,
                        attn_chunk_kv=4)
OVERS["loss_chunk"] = dict(OVER, loss_chunk=4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S = 4, 8
LOSS_RTOL = 1e-4
PARAM_ATOL = 5e-3       # tests/test_train_substrate.py:65, lr 1e-3
SAME_RTOL = 1e-6
JOIN_S = 300
REPLICATED = {2: "(Replicate(), Replicate())",
              3: "(Replicate(), Replicate(), Replicate())"}


def _batch(model):
    """tokens/labels [B, S] from seed 0 (+ frames [B, S, d] for audio, image
    embeddings and labels over the image positions too for vlm)."""
    cfg = ref_cfg(MODELS[model], "f32", **OVERS[model])
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.img_embed_dim)).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.full((B, cfg.n_img_tokens), -100, np.int32), out["labels"]],
            axis=1)
    return out


def _job(tmp, name):
    models = {m: {"arch": MODELS[m], "over": OVERS[m],
                  "params": ref_params_np(MODELS[m], **OVER),
                  "batch": _batch(m)} for m in MODELS}
    return {"models": models, "opt": OPT, "extras_model": "dense",
            "restore_shape": RESTORE[name],
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
    tmp = str(tmp_path_factory.mktemp(f"train_mesh_{name}"))
    return name, MESHES[name], _spawn(MESHES[name], _job(tmp, name), tmp)


# ---------------------------------------------------------------------------
# The JAX package, unsharded (cached: every mesh holds to the same values).
# ---------------------------------------------------------------------------

def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ref(model, kind="plain"):
    """(grads, step-1 metrics, params after the steps) of the JAX package:
    ``plain`` 3 steps, ``accum`` one step at grad_accum 2, ``compress`` 3
    compressed steps."""
    cfg = ref_cfg(MODELS[model], "f32", **OVERS[model])
    params = jax.tree.map(jnp.asarray, ref_params_np(MODELS[model], **OVER))
    batch = {k: jnp.asarray(v) for k, v in _batch(model).items()}
    (_, (loss, _)), grads = jax.value_and_grad(ref_loss_fn, has_aux=True)(
        params, cfg, batch)
    opt = RefAdamW(**OPT)
    kw = {"accum": {"grad_accum": 2}, "compress": {"compress": True}}.get(
        kind, {})
    step = jax.jit(ref_make_train_step(cfg, opt, **kw))
    state = ref_init_state(params, opt, compress=kind == "compress")
    metrics = []
    for _ in range(1 if kind == "accum" else worker.N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return _flat(grads), metrics, _flat(state.params)


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


def _stub(shape, axes=AXES):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _want_placed(model, shape, axes=AXES):
    """Each parameter's placements from the JAX package's own spec."""
    from jax.sharding import PartitionSpec as RefP
    stub = _stub(shape, axes)
    specs = ref_partition_specs(
        ref_api.spec(ref_cfg(MODELS[model], "f32", **OVERS[model])), stub,
        ref_default_rules(stub))
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    mesh = Mesh(shape, axes)
    return {"/".join(k.key for k in path): repr(placements(mesh, p))
            for path, p in leaves}


# ---------------------------------------------------------------------------
# Values and layout of every model, on every mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_loss_and_grad_norm_match_reference(run, model):
    _, metrics, _ = _ref(model)
    _metrics_close(run[2][model]["metrics"][0], metrics[0])


@pytest.mark.parametrize("model", list(MODELS))
def test_gradients_match_reference(run, model):
    grads, _, _ = _ref(model)
    _grads_close(run[2][model]["grads"], grads)


@pytest.mark.parametrize("model", list(MODELS))
def test_params_after_three_adamw_steps_match_reference(run, model):
    _, metrics, params = _ref(model)
    got = run[2][model]
    for g, w in zip(got["metrics"], metrics):
        _metrics_close(g, w)
        assert g["step"] == w["step"]
    _params_close(got["params"], params)


@pytest.mark.parametrize("model", list(MODELS))
def test_gradients_and_moments_take_the_parameters_placements(run, model):
    """Every gradient, m and v in its parameter's ``placements(mesh,
    spec)`` of the JAX package's spec; the count and the step
    replicated."""
    _, shape, res = run
    want = _want_placed(model, shape)
    got = res[model]
    assert got["grad_placed"] == want
    for k in ("params", "m", "v"):
        assert got["state_placed"][k] == want, k
    assert got["state_placed"]["count"] == REPLICATED[2]
    assert got["state_placed"]["step"] == REPLICATED[2]


@pytest.mark.parametrize("model", list(MODELS))
def test_each_rank_holds_the_dry_runs_train_state_bytes(run, model):
    """Each rank's local bytes of params, m, v, count and step equal the
    dry run's train ``argument_bytes`` less its inputs (3 x params + 8)."""
    _, shape, res = run
    cfg = port_cfg(MODELS[model], "f32", **OVERS[model])
    mesh = mesh_mod.make_mesh(shape, AXES)
    rules = mesh_mod.default_rules(mesh)
    cell = ShapeConfig("train_mesh", S + cfg.n_img_tokens, B, "train")
    want = (dryrun.argument_bytes(cfg, cell, mesh, rules)
            - dryrun.input_bytes(cfg, cell, mesh, rules))
    assert res[model]["bytes"] == [want] * 4


# ---------------------------------------------------------------------------
# Remat, grad_accum, compression, restore, refusals (qwen3).
# ---------------------------------------------------------------------------

def test_remat_policies_give_the_same_gradients(run):
    got = run[2]["remat"]
    for policy in ("full", "dots"):
        for k, w in got["none"].items():
            assert _rel(got[policy][k], w) <= SAME_RTOL, (policy, k)
    grads, _, _ = _ref("dense")
    _grads_close(got["full"], grads)


def test_dots_policy_sees_the_products_of_dtensors(run):
    """Under a mesh the blocks' products run on DTensors; the ``dots``
    policy is still asked about each rank's ``aten.mm`` and ``aten.bmm``
    (and so saves them)."""
    assert {"aten.mm.default", "aten.bmm.default"} <= run[2]["remat"][
        "dots_ops"]


def test_remat_recompute_on_another_thread_keeps_the_mesh(run):
    """The backward run on another thread than the forward (as the card's
    autograd engine runs it): the blocks' recompute sees the forward's
    mesh, and the gradients equal those of one thread, in the
    parameters' placements (a recompute without the mesh gives DTensors
    nested in DTensors)."""
    _, shape, res = run
    got = res["remat"]
    for k, w in got["full"].items():
        assert _rel(got["full_thread"][k], w) <= SAME_RTOL, k
    assert got["full_thread_placed"] == _want_placed("dense", shape)


def test_grad_accum_matches_the_reference_grad_accum(run):
    _, metrics, params = _ref("dense", "accum")
    got = run[2]["accum"]
    _metrics_close(got["metrics"], metrics[0])
    _params_close(got["params"], params)


def test_compressed_steps_match_the_reference(run):
    _, shape, res = run
    _, metrics, params = _ref("dense", "compress")
    got = res["compress"]
    for g, w in zip(got["metrics"], metrics):
        _metrics_close(g, w)
    _params_close(got["params"], params)
    assert got["state_placed"]["ef"] == _want_placed("dense", shape)


def test_ef_compress_on_shards_is_bit_identical_to_one_device(run):
    """The sharded ``ef_compress`` (each shard quantized with its tensor's
    global max-abs) against the unsharded port on the same gradient
    values, twice (the second time with the first's residuals): codes,
    dequantized gradients and residuals bit for bit."""
    res = run[2]
    grads = {k: torch.as_tensor(v) for k, v in res["dense"]["grads"].items()}
    ef = comp.ef_init(grads)
    for got in res["ef"]:
        codes = {k: comp.quantize(g + ef.residual[k]).q
                 for k, g in grads.items()}
        g_hat, ef = comp.ef_compress(grads, ef)
        for name, want in (("codes", codes), ("g_hat", g_hat),
                           ("residual", ef.residual)):
            for k, w in want.items():
                np.testing.assert_array_equal(got[name][k], w.numpy(),
                                              err_msg=f"{name} {k}")
    assert any(np.any(v) for v in res["ef"][1]["residual"].values())


def test_restore_onto_another_mesh_continues_the_run(run):
    """The state after one step, saved from this mesh and restored onto
    ``RESTORE``'s: placements there, and the next step there equal to the
    next step of the live state laid out on that mesh (and to this mesh's
    next step within the mesh tolerances)."""
    name, _, res = run
    got = res["restore"]
    want = _want_placed("dense", RESTORE[name])
    assert got["saved"] == 1
    for k in ("params", "m", "v"):
        assert got["placed"][k] == want, k
    assert got["placed"]["count"] == REPLICATED[2]
    for k in ("loss", "grad_norm", "acc"):
        assert abs(got["back"][k] - got["moved"][k]) <= SAME_RTOL * abs(
            got["moved"][k]), k
    for k, w in got["moved_params"].items():
        assert _rel(got["back_params"][k], w) <= SAME_RTOL, k
    _metrics_close(got["back"], got["live"])
    _params_close(got["back_params"], got["live_params"])


def test_a_step_runs_under_the_mesh_it_was_built_for_only(run):
    got = run[2]["restore"]
    assert got["other_mesh"] == "RuntimeError"
    assert got["no_mesh_step"] == "RuntimeError"


def test_train_step_on_the_multi_pod_mesh_matches_reference(run):
    """qwen3 on a (2,2,1) mesh over (pod, data, model): the batch cut
    over pod and data, the weights' FSDP cut over data."""
    grads, metrics, params = _ref("dense")
    got = run[2]["pod"]
    _grads_close(got["grads"], grads)
    for g, w in zip(got["metrics"], metrics):
        _metrics_close(g, w)
    _params_close(got["params"], params)
    want = _want_placed("dense", (2, 2, 1), POD_AXES)
    assert got["grad_placed"] == want
    assert got["state_placed"]["m"] == want
    assert got["state_placed"]["count"] == REPLICATED[3]


# ---------------------------------------------------------------------------
# compressed_psum over a mesh axis, against the JAX package's arithmetic.
# ---------------------------------------------------------------------------

def _ref_psum(xs):
    """The JAX package's ``compressed_psum`` over ranks holding ``xs``: each
    quantized with the global max-abs (``quantize`` of the stack has it),
    the int8 codes summed in int32, rescaled in f32."""
    qx = ref_comp.quantize(jnp.stack([jnp.asarray(x) for x in xs]))
    total = jnp.sum(qx.q.astype(jnp.int32), axis=0)
    n = jnp.asarray(len(xs), jnp.float32)
    return np.asarray((total.astype(jnp.float32) * qx.scale / n).astype(
        jnp.float32))


@pytest.mark.parametrize("group", ["data", "world"])
def test_compressed_psum_over_a_mesh_axis_matches_reference(run, group):
    ranks = run[2]["psum"]
    for r in ranks:
        if group == "data":     # the ranks sharing r's model coordinate
            peers = [q for q in ranks if q["coord"][1] == r["coord"][1]]
        else:
            peers = ranks
        want = _ref_psum([q["x"] for q in peers])
        np.testing.assert_array_equal(r[group], want)
