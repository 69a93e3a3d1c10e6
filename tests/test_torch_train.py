"""The port's training path against the JAX package's, on the CPU.

The loss (whole and sequence-chunked, IGNORE labels, z-loss), AdamW (three
updates, the schedule, decay on matrices only), the global norm and its
clip, int8 quantization bit for bit (half-way values round to even), error
feedback, ``compressed_psum`` on a gloo group of one, and the train step on
``tests/test_train_substrate.py``'s tiny config with the JAX package's
parameters (``torch_lm_helpers.params_pair``).

Tolerances, and why:
- f32 elementwise math (loss, schedule, AdamW moments, norms): rel 1e-6
  (a few f32 ulps: ``pow``, ``cos`` and ``sqrt`` may round differently).
- f32 forward and backward through a model: rel 1e-4 for loss and grad
  norm, gradients within 1e-4 of each leaf's largest |g| (the port's f32
  parity tolerance, ``torch_lm_helpers.F32_TOL``: products sum in another
  order).
- Parameters after AdamW steps: atol 5e-3 at lr 1e-3, the JAX package's
  own tolerance (``tests/test_train_substrate.py:65``). AdamW's first
  step moves each parameter by ≈ lr·sign(g): a gradient of ~1e-9 whose
  sign differs between the packages moves it by 2·lr.
- Remat changes memory, never values: gradients within rel 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compression as ref_comp
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.optim.adamw import global_norm as ref_global_norm
from repro.train import loss as ref_loss
from repro.train.step import _loss_fn as ref_loss_fn
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.models.module import tree_items, tree_map
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW, clip_by_global_norm, global_norm
from repro_torch.train import loss as tloss
from repro_torch.train.step import init_state, make_grad_fn, make_train_step
from torch_lm_helpers import BF16_TOL, F32_TOL, params_pair, port_cfg, \
    ref_cfg, to_numpy

ELEMENTWISE_RTOL = 1e-6
PARAM_ATOL = 5e-3       # tests/test_train_substrate.py:65, lr 1e-3
REMAT_RTOL = 1e-6
# tests/test_train_substrate.py:19-27's tiny fixture (qwen3-1.7b reduced)
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
            d_ff=128, vocab_size=128)
ARCH = "qwen3-1.7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the backward's many small ops run ~30x slower when torch's intra-op
    # threads share the cores with the JAX package's CPU thread pool
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _tiny(compute="f32", **over):
    """(reference cfg, port cfg, reference params, port params)."""
    over = dict(TINY, **over)
    ref, port = params_pair(ARCH, compute, **over)
    return ref_cfg(ARCH, compute, **over), port_cfg(ARCH, compute, **over), \
        ref, port


def _batch(vocab, b=4, s=16, seed=0):
    """tests/test_train_substrate.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaves_close(port_tree, ref_tree, **tol):
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port = dict(tree_items(port_tree))
    assert len(ref) == len(port)
    for path, want in ref:
        key = tuple(p.key for p in path)
        np.testing.assert_allclose(to_numpy(port[key]), np.asarray(want),
                                   err_msg="/".join(key), **tol)


def _grads_close(port_tree, ref_tree, tol):
    """Each leaf within ``tol`` of its largest |g|."""
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port = dict(tree_items(port_tree))
    for path, want in ref:
        key = tuple(p.key for p in path)
        err = _rel(to_numpy(port[key]), want)
        assert err < tol, ("/".join(key), err)


# -- loss ---------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_loss_with_ignore_labels_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 8)).astype(np.float32)
    labels = np.array([[1, 2, tloss.IGNORE, tloss.IGNORE],
                       [3, tloss.IGNORE, tloss.IGNORE, tloss.IGNORE]],
                      np.int32)
    want = ref_loss.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels), z_loss)
    got = tloss.softmax_cross_entropy(torch.as_tensor(logits),
                                      torch.as_tensor(labels), z_loss)
    assert tloss.IGNORE == ref_loss.IGNORE
    for g, w in zip(got, want):
        assert _rel(g, w) < ELEMENTWISE_RTOL
    if not z_loss:      # tests/test_train_substrate.py::test_loss_masking
        lf = logits.astype(np.float64)
        lse = np.log(np.exp(lf).sum(-1))
        nll = ((lse[0, 0] - lf[0, 0, 1]) + (lse[0, 1] - lf[0, 1, 2])
               + (lse[1, 0] - lf[1, 0, 3])) / 3
        np.testing.assert_allclose(float(got[0]), nll, rtol=1e-4)


def test_loss_of_all_ignored_labels_is_zero():
    logits = torch.zeros((1, 3, 5))
    labels = torch.full((1, 3), tloss.IGNORE, dtype=torch.int32)
    loss, acc = tloss.softmax_cross_entropy(logits, labels)
    assert float(loss) == 0.0 and float(acc) == 0.0


def test_accuracy_takes_the_first_maximum_as_jnp_argmax():
    logits = np.array([[[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                        [0.0, 5.0, 1.0, 5.0]]], np.float32)
    for labels in ([[1, 0, 1]], [[2, 3, 3]]):
        labels = np.array(labels, np.int32)
        _, want = ref_loss.softmax_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels))
        _, got = tloss.softmax_cross_entropy(torch.as_tensor(logits),
                                             torch.as_tensor(labels))
        assert float(got) == float(want)


@pytest.mark.parametrize("chunk,z_loss", [(4, 0.0), (8, 1e-4), (16, 0.0)])
def test_chunked_loss_matches_reference_and_the_whole_loss(chunk, z_loss):
    rng = np.random.default_rng(1)
    v, d, b, s = 64, 16, 2, 16
    w = rng.normal(size=(v, d)).astype(np.float32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 3:7] = tloss.IGNORE
    want = ref_loss.chunked_softmax_cross_entropy(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(labels), chunk, z_loss)
    wt = torch.as_tensor(w, dtype=torch.float32).requires_grad_()
    xt = torch.as_tensor(x).requires_grad_()
    lt = torch.as_tensor(labels)
    got = tloss.chunked_softmax_cross_entropy(wt, xt, lt, chunk, z_loss)
    for g, ww in zip(got, want):
        assert _rel(g.detach(), ww) < ELEMENTWISE_RTOL
    # the chunks' recompute gives the whole loss's gradients
    gw, gx = torch.autograd.grad(got[0], (wt, xt))
    whole, _ = tloss.softmax_cross_entropy(xt @ wt.t(), lt, z_loss)
    hw, hx = torch.autograd.grad(whole, (wt, xt))
    assert _rel(gw, hw) < 1e-5 and _rel(gx, hx) < 1e-5


def test_chunked_loss_refuses_a_ragged_chunk():
    with pytest.raises(ValueError, match="multiple of chunk"):
        tloss.chunked_softmax_cross_entropy(
            torch.zeros(8, 4), torch.zeros(1, 6, 4),
            torch.zeros(1, 6, dtype=torch.int32), 4)


# -- AdamW --------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blk": {"b": rng.normal(size=(5,)).astype(np.float32),
                    "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_three_updates_match_reference(schedule):
    rng = np.random.default_rng(2)
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=5,
              lr_schedule=schedule)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    p_np = _opt_tree(rng)
    ref_p = jax.tree.map(jnp.asarray, p_np)
    port_p = tree_map(torch.as_tensor, jax.tree.map(np.copy, p_np))
    ref_s, port_s = ref_opt.init(ref_p), opt.init(port_p)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape)
                            .astype(np.float32), p_np)
        ref_p, ref_s = ref_opt.update(jax.tree.map(jnp.asarray, g_np),
                                      ref_s, ref_p)
        port_p, port_s = opt.update(tree_map(torch.as_tensor, g_np), port_s,
                                    port_p)
    assert int(port_s.count) == int(ref_s.count) == 3
    assert port_s.count.dtype == torch.int32
    for port_tree, ref_tree in ((port_p, ref_p), (port_s.m, ref_s.m),
                                (port_s.v, ref_s.v)):
        _leaves_close(port_tree, ref_tree, rtol=ELEMENTWISE_RTOL, atol=1e-7)


def test_adamw_updates_in_place():
    opt = AdamW(lr=1e-2, warmup_steps=1)
    p = {"w": torch.ones(3, 3)}
    state = opt.init(p)
    w, m = p["w"], state.m["w"]
    new_p, new_s = opt.update({"w": torch.ones(3, 3)}, state, p)
    assert new_p["w"] is w and new_s.m["w"] is m
    assert float(w[0, 0]) < 1.0 and float(m[0, 0]) > 0.0


@pytest.mark.parametrize("schedule,warmup,total",
                         [("cosine", 3, 10), ("cosine", 0, 1),
                          ("constant", 4, 8)])
def test_adamw_schedule_matches_reference(schedule, warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              lr_schedule=schedule)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    for step in range(total + 3):
        want = float(ref_opt._lr_at(jnp.asarray(step, jnp.int32)))
        got = float(opt._lr_at(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=ELEMENTWISE_RTOL,
                                   atol=1e-12)


def test_adamw_weight_decay_only_on_matrices():
    # tests/test_train_substrate.py::test_adamw_weight_decay_only_on_matrices
    opt = AdamW(lr=1e-2, weight_decay=0.5, warmup_steps=1,
                lr_schedule="constant")
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = opt.init(params)
    new_params, _ = opt.update(tree_map(torch.zeros_like, params), state,
                               params)
    assert float(new_params["w"][0, 0]) < 1.0   # decayed
    assert float(new_params["b"][0]) == 1.0     # not decayed


@pytest.mark.parametrize("scale", [100.0, 1e-3])
def test_global_norm_and_clip_match_reference(scale):
    rng = np.random.default_rng(3)
    g_np = {"a": (rng.normal(size=(128,)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(4, 8)) * scale).astype(np.float32)}}
    ref_g = jax.tree.map(jnp.asarray, g_np)
    want_c, want_n = ref_clip(ref_g, 1.0)
    port_g = tree_map(torch.as_tensor, jax.tree.map(np.copy, g_np))
    assert _rel(global_norm(port_g), ref_global_norm(ref_g)) \
        < ELEMENTWISE_RTOL
    got_c, got_n = clip_by_global_norm(port_g, 1.0)
    assert _rel(got_n, want_n) < ELEMENTWISE_RTOL
    _leaves_close(got_c, want_c, rtol=ELEMENTWISE_RTOL, atol=0)
    if scale > 1:   # tests/test_train_substrate.py::test_clip_by_global_norm
        assert float(global_norm(got_c)) <= 1.0 + 1e-5 and float(got_n) > 1


# -- compression --------------------------------------------------------------

def test_quantize_matches_reference_bit_for_bit():
    rng = np.random.default_rng(4)
    # amax 127 → scale 1: the half-way codes round half to even
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                      np.float32)
    for x in (rng.normal(size=(256, 64)).astype(np.float32), halves,
              np.zeros(7, np.float32)):
        want = ref_comp.quantize(jnp.asarray(x))
        got = comp.quantize(torch.as_tensor(x))
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        assert got.scale.numpy().tobytes() == \
            np.asarray(want.scale).tobytes()
        np.testing.assert_array_equal(
            comp.dequantize(got).numpy(), np.asarray(ref_comp.dequantize(want)))
    q = comp.quantize(torch.as_tensor(halves))
    assert q.q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    # tests/test_train_substrate.py::test_quantize_roundtrip_bound
    x = torch.as_tensor(rng.normal(size=(256, 64)).astype(np.float32))
    q = comp.quantize(x)
    assert float((comp.dequantize(q) - x).abs().max()) \
        <= float(q.scale) * 0.5 + 1e-7


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(5)
    g_np = {"w": rng.normal(size=(64,)).astype(np.float32),
            "m": {"k": rng.normal(size=(8, 8)).astype(np.float32)}}
    ref_ef = ref_comp.ef_init(jax.tree.map(jnp.asarray, g_np))
    port_ef = comp.ef_init(tree_map(torch.as_tensor, g_np))
    for _ in range(3):
        ref_hat, ref_ef = ref_comp.ef_compress(
            jax.tree.map(jnp.asarray, g_np), ref_ef)
        port_hat, port_ef = comp.ef_compress(
            tree_map(torch.as_tensor, g_np), port_ef)
        _leaves_close(port_hat, ref_hat, rtol=0, atol=0)
        _leaves_close(port_ef.residual, ref_ef.residual, rtol=0, atol=0)
    # residual = exactly the quantization error
    g = {"w": torch.as_tensor(g_np["w"])}
    hat, ef = comp.ef_compress(g, comp.ef_init(g))
    np.testing.assert_allclose(ef.residual["w"].numpy(),
                               (g["w"] - hat["w"]).numpy(), atol=1e-7)


def test_compressed_psum_on_one_rank_matches_reference(tmp_path):
    from jax.sharding import Mesh, PartitionSpec

    from repro.kernels.compat import shard_map
    x = np.random.default_rng(6).normal(size=(32,)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    want = jax.jit(shard_map(
        lambda v: ref_comp.compressed_psum(v, "dp"), mesh=mesh,
        in_specs=PartitionSpec(None), out_specs=PartitionSpec(None)))(
            jnp.asarray(x))
    with pytest.raises(RuntimeError, match="process group"):
        comp.compressed_psum(torch.as_tensor(x))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = comp.compressed_psum(torch.as_tensor(x))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), x, atol=2e-2)


# -- the train step -----------------------------------------------------------

def test_gradients_match_reference():
    rcfg, pcfg, ref_p, port_p = _tiny()
    batch = _batch(pcfg.vocab_size)
    want = jax.jit(jax.grad(lambda p, b: ref_loss_fn(p, rcfg, b)[0]))(
        ref_p, _jax(batch))
    got, loss, acc = make_grad_fn(pcfg)(port_p, _torch(batch))
    _grads_close(got, want, F32_TOL)
    for _, leaf in tree_items(port_p):
        assert not leaf.requires_grad and leaf.grad is None


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_train_step_three_steps_match_reference(compute):
    # bf16 is the fixture's own compute dtype: loss and grad norm within
    # BF16_TOL, a position's argmax may flip (acc within 2 of B·S = 64);
    # parameters within the JAX package's own bf16 tolerance either way
    tol, acc_tol = (F32_TOL, 0.0) if compute == "f32" else (BF16_TOL, 2 / 64)
    rcfg, pcfg, ref_p, port_p = _tiny(compute)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    ref_step = jax.jit(ref_make_train_step(rcfg, ref_opt))
    step = make_train_step(pcfg, opt)
    ref_s, port_s = ref_init_state(ref_p, ref_opt), init_state(port_p, opt)
    for i in range(3):
        batch = _batch(pcfg.vocab_size, seed=i)
        ref_s, rm = ref_step(ref_s, _jax(batch))
        port_s, pm = step(port_s, _torch(batch))
        assert _rel(pm["loss"], rm["loss"]) < tol, i
        assert _rel(pm["grad_norm"], rm["grad_norm"]) < tol, i
        assert abs(float(pm["acc"]) - float(rm["acc"])) <= acc_tol, i
        assert int(pm["step"]) == int(rm["step"]) == i + 1
    _leaves_close(port_s.params, ref_s.params, rtol=0, atol=PARAM_ATOL)
    if compute == "f32":
        # the first moments average the gradients; bf16 gradients of the
        # two packages differ by bf16 rounding (loss and norm hold them)
        _grads_close(port_s.opt.m, ref_s.opt.m, tol)


def test_grad_accum_matches_reference():
    rcfg, pcfg, ref_p, port_p = _tiny()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    batch = _batch(pcfg.vocab_size, b=8)
    ref_s, rm = jax.jit(ref_make_train_step(rcfg, ref_opt, grad_accum=4))(
        ref_init_state(ref_p, ref_opt), _jax(batch))
    port_s, pm = make_train_step(pcfg, opt, grad_accum=4)(
        init_state(port_p, opt), _torch(batch))
    assert _rel(pm["loss"], rm["loss"]) < F32_TOL
    assert _rel(pm["grad_norm"], rm["grad_norm"]) < F32_TOL
    assert abs(float(pm["acc"]) - float(rm["acc"])) < 1e-6
    _leaves_close(port_s.params, ref_s.params, rtol=0, atol=PARAM_ATOL)


def test_grad_accum_equivalent():
    # tests/test_train_substrate.py::test_grad_accum_equivalent (bf16)
    _, cfg, _, params = _tiny("bf16")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _torch(_batch(cfg.vocab_size, b=8))
    p1 = tree_map(torch.clone, params)
    s1, m1 = make_train_step(cfg, opt)(init_state(p1, opt), batch)
    s4, m4 = make_train_step(cfg, opt, grad_accum=4)(
        init_state(params, opt), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-2)
    for (_, a), (_, b) in zip(tree_items(s1.params), tree_items(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


@pytest.mark.parametrize("arch,over", [
    ("qwen3-1.7b", TINY), ("granite-moe-1b-a400m", {}),
    ("whisper-small", {})])
def test_remat_policies_give_equal_gradients(arch, over):
    _, params = params_pair(arch, "f32", **over)
    base = port_cfg(arch, "f32", **over)
    batch = _batch(base.vocab_size, b=2, s=8)
    if base.family == "audio":
        batch["frames"] = np.random.default_rng(7).normal(
            size=(2, 8, base.d_model)).astype(np.float32)
    grads = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=policy)
        grads[policy], _, _ = make_grad_fn(cfg)(params, _torch(batch))
    for policy in ("full", "dots"):
        for (k, a), (_, b) in zip(tree_items(grads[policy]),
                                  tree_items(grads["none"])):
            assert _rel(a, b) <= REMAT_RTOL, (policy, k)


def test_loss_decreases():
    # tests/test_train_substrate.py::test_loss_decreases (bf16 compute)
    _, cfg, _, params = _tiny("bf16")
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=60)
    state = init_state(params, opt)
    step = make_train_step(cfg, opt)
    batch = _torch(_batch(cfg.vocab_size))   # overfit one batch
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::8]


def test_compressed_training_converges():
    # tests/test_train_substrate.py::test_compressed_training_converges
    _, cfg, _, params = _tiny("bf16")
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=60)
    state = init_state(params, opt, compress=True)
    step = make_train_step(cfg, opt, compress=True)
    batch = _torch(_batch(cfg.vocab_size))
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.75, losses[::8]
    assert any(float(r.abs().max()) > 0
               for _, r in tree_items(state.ef.residual))


def _smoke_batch(cfg):
    """tests/test_models_smoke.py's batch (B 2, S 32), as numpy."""
    rng = np.random.default_rng(0)
    b, s = 2, 32
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    s_total = s
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.img_embed_dim)).astype(np.float32)
        s_total = s + cfg.n_img_tokens
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s_total)) \
        .astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "jamba-v0.1-52b", "rwkv6-7b",
                                  "whisper-small"])
def test_train_step_matches_reference(arch):
    # tests/test_models_smoke.py::test_train_step_no_nans's five archs,
    # reduced, f32 compute (real MoE routing), held to the reference
    ref_p, port_p = params_pair(arch, "f32")
    rcfg, pcfg = ref_cfg(arch, "f32"), port_cfg(arch, "f32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)
    batch = _smoke_batch(pcfg)
    _, rm = jax.jit(ref_make_train_step(rcfg, ref_opt))(
        ref_init_state(ref_p, ref_opt), _jax(batch))
    before = tree_map(torch.clone, port_p)
    state, pm = make_train_step(pcfg, opt)(init_state(port_p, opt),
                                           _torch(batch))
    assert np.isfinite(float(pm["loss"])) and \
        np.isfinite(float(pm["grad_norm"]))
    assert _rel(pm["loss"], rm["loss"]) < F32_TOL, arch
    assert _rel(pm["grad_norm"], rm["grad_norm"]) < F32_TOL, arch
    moved = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tree_items(state.params), tree_items(before))]
    assert min(moved) > 0, arch
