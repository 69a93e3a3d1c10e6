"""Prefill and decode in the port against the JAX package's, on the CPU.

With the JAX package's parameters: the port's prefill logits, decode
caches and decode logits match ``repro.models.api`` for every arch on its
reduced config (f32 compute within rel 1e-4, bf16 within rel 2e-2), and
the port's ``generate`` gives the JAX package's f32 greedy tokens. The
port's own prefill → decode handoff equals its forward pass with the JAX
package's tolerances (``tests/test_decode_equiv.py``: bf16 2e-2 for the
attention archs, f32 5e-5 for the hybrid/ssm archs, 5e-4 past the
sliding window), and the SWA ring buffer wraps as the JAX package's does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.models import api as tapi
from repro_torch.models.module import tree_items
from repro_torch.serve.step import generate

from torch_lm_helpers import (
    ATTN_ARCHS, BF16_TOL, F32_TOL, MAX, S, all_experts, batch_np, first_pos,
    params_pair, port_cfg, prefix, ref_decode_fn, ref_prefill_fn, rel_err,
    to_jax, to_numpy, to_torch,
)

N_NEW = 4


def _ref_greedy(arch, compute, ref, batch, cfg, n_new, **over):
    """The JAX package's greedy loop (``repro.serve.step.generate``'s) over
    its jitted prefill and decode."""
    logits, caches = ref_prefill_fn(arch, compute, **over)(ref, batch)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    decode = ref_decode_fn(arch, compute, **over)
    for i in range(n_new - 1):
        lg, caches = decode(ref, caches, tok,
                            jnp.int32(first_pos(cfg, S) + i))
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def _check_prefill_decode(arch, compute, tol, **over):
    ref, port = params_pair(arch, compute, **over)
    cfg = port_cfg(arch, compute, **over)
    full = batch_np(cfg)
    batch = prefix(full, S)
    want_p, want_c = ref_prefill_fn(arch, compute, **over)(ref, to_jax(batch))
    got_p, got_c = tapi.prefill(port, cfg, to_torch(batch), MAX)
    assert got_p.shape == want_p.shape
    assert rel_err(to_numpy(got_p), want_p) < tol, f"{arch} prefill"
    want_leaves = dict(_leaves(want_c))
    for key, leaf in tree_items(got_c):
        w = np.asarray(want_leaves.pop(key))
        assert tuple(leaf.shape) == w.shape, key
        if key[-1] == "pos":
            np.testing.assert_array_equal(leaf.numpy(), w)
        else:
            assert rel_err(to_numpy(leaf), w) < tol, (arch, key)
    assert not want_leaves, sorted(want_leaves)

    pos = first_pos(cfg, S)
    tok = full["tokens"][:, S:S + 1]
    want_d, _ = ref_decode_fn(arch, compute, **over)(
        ref, want_c, jnp.asarray(tok), jnp.int32(pos))
    got_d, got_c2 = tapi.decode_step(port, cfg, got_c, torch.as_tensor(tok),
                                     pos)
    assert got_c2 is got_c            # updated in place
    assert rel_err(to_numpy(got_d), want_d) < tol, f"{arch} decode"
    return ref, port, cfg, batch


def _leaves(tree, prefix_=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix_ + (k,))
    else:
        yield prefix_, tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_and_greedy_tokens_match_reference_f32(arch):
    ref, port, cfg, batch = _check_prefill_decode(arch, "f32", F32_TOL)
    want = _ref_greedy(arch, "f32", ref, to_jax(batch), cfg, N_NEW)
    tb = to_torch(batch)
    prompt = tb.pop("tokens")
    got = generate(port, cfg, prompt, N_NEW, MAX, enc_batch=tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_decode_match_reference_bf16(arch):
    # every expert routed for the MoE archs (see test_torch_models.py)
    _check_prefill_decode(arch, "bf16", BF16_TOL, **all_experts(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward(arch):
    """The port's own prefill → decode handoff equals its forward pass."""
    compute = "bf16" if arch in ATTN_ARCHS else "f32"
    cfg = port_cfg(arch, compute)
    _, params = params_pair(arch, compute)
    full = batch_np(cfg)
    logits_p, caches = tapi.prefill(params, cfg, to_torch(prefix(full, S)),
                                    MAX)
    logits_d, _ = tapi.decode_step(params, cfg, caches,
                                   torch.as_tensor(full["tokens"][:, S:]),
                                   first_pos(cfg, S))
    logits_f, _ = tapi.forward(params, cfg, to_torch(full))
    tol = 5e-5 if compute == "f32" else 2e-2
    assert rel_err(to_numpy(logits_d[:, 0]), to_numpy(logits_f[:, -1])) \
        < tol, arch
    shared = to_numpy(logits_f[:, :logits_p.shape[1]])
    assert rel_err(to_numpy(logits_p), shared) < tol, arch


def test_swa_ring_buffer_wraps_correctly():
    """Decoding past the window: the ring-buffer cache equals the full
    forward, and the JAX package's decode, step by step."""
    arch = "mixtral-8x7b"
    over = dict(sliding_window=16, moe=None)
    ref, port = params_pair(arch, "f32", **over)
    cfg = port_cfg(arch, "f32", **over)
    rng = np.random.default_rng(2)
    total = 40  # prefill 24, decode 16 more (wraps the 16-slot ring)
    toks = rng.integers(1, cfg.vocab_size, (1, total)).astype(np.int32)
    _, caches = tapi.prefill(port, cfg, {"tokens": torch.as_tensor(
        toks[:, :24])}, max_seq=total)
    _, want_c = ref_prefill_fn(arch, "f32", total, **over)(
        ref, {"tokens": jnp.asarray(toks[:, :24])})
    np.testing.assert_array_equal(
        caches["pos0"]["pos"].numpy(), np.asarray(want_c["pos0"]["pos"]))
    decode = ref_decode_fn(arch, "f32", **over)
    logits_f, _ = tapi.forward(port, cfg, {"tokens": torch.as_tensor(toks)})
    for i in range(24, total):
        tok = toks[:, i:i + 1]
        lg, caches = tapi.decode_step(port, cfg, caches,
                                      torch.as_tensor(tok), i)
        want, want_c = decode(ref, want_c, jnp.asarray(tok), jnp.int32(i))
        assert rel_err(to_numpy(lg), want) < F32_TOL, i
        np.testing.assert_array_equal(caches["pos0"]["pos"].numpy(),
                                      np.asarray(want_c["pos0"]["pos"]))
        if i + 1 < total:
            assert rel_err(to_numpy(lg[0, 0]), to_numpy(logits_f[0, i])) \
                < 5e-4, i
    # the ring holds the last 16 positions, position p at slot p % 16
    pos = caches["pos0"]["pos"][0, 0].numpy()
    np.testing.assert_array_equal(np.sort(pos), np.arange(total - 16, total))
    assert all(p % 16 == slot for slot, p in enumerate(pos))
