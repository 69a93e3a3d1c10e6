"""Shared helpers of the LM parity tests (``test_torch_models.py``,
``test_torch_decode.py``, ``test_torch_serve_step.py``).

The JAX package draws its parameters with ``init_params(jax.random.key(0),
...)``; they reach the port as numpy arrays through
``params_from_reference``. Inputs are numpy arrays from a seed. The JAX
side runs jitted on the CPU; every jitted function and parameter tree is
cached per (arch, compute dtype), so the three files share them when they
run in one process.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import api as ref_api
from repro.models.module import init_params as ref_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import api as tapi

B, S, MAX = 2, 32, 64
ATTN_ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b", "command-r-plus-104b",
              "qwen2.5-14b", "stablelm-12b", "qwen3-1.7b",
              "phi-3-vision-4.2b", "whisper-small")
F32_TOL = 1e-4      # f32 compute, the port against the JAX package
BF16_TOL = 2e-2     # bf16 compute (tests/test_decode_equiv.py:53)

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _replace(cfg, compute, over):
    """``cfg`` with ``over`` applied; ``moe=(("field", value), ...)`` and
    ``ssm=(...)`` replace fields of the MoE and SSM configs (each package
    has its own classes)."""
    over = dict(over)
    for sub in ("moe", "ssm"):
        if isinstance(over.get(sub), tuple):
            over[sub] = dataclasses.replace(getattr(cfg, sub),
                                            **dict(over[sub]))
    return dataclasses.replace(cfg, compute_dtype=compute, **over)


def ref_cfg(arch: str, compute: str, **over):
    return _replace(ref_reduced(ref_get_config(arch)), _JNP[compute], over)


def port_cfg(arch: str, compute: str, **over):
    return _replace(reduced(get_config(arch)), _TORCH[compute], over)


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch: str, over: tuple):
    # the parameter tree does not depend on the compute dtype
    cfg = ref_cfg(arch, "f32", **dict(over))
    params = ref_init_params(jax.random.key(0), ref_api.spec(cfg))
    return jax.tree.map(np.asarray, params)


def ref_params_np(arch: str, **over):
    return _ref_params_np(arch, tuple(sorted(over.items())))


def params_pair(arch: str, compute: str, device="cpu", **over):
    """(reference params as jnp, port params on ``device``) — the same
    numbers."""
    np_tree = ref_params_np(arch, **over)
    ref = jax.tree.map(jnp.asarray, np_tree)
    port = tapi.params_from_reference(np_tree, port_cfg(arch, compute,
                                                        **over), device)
    return ref, port


def batch_np(cfg, seed: int = 1, b: int = B, s: int = S + 1):
    """tokens [b, s] (+ frames [b, S] / image embeddings) from
    ``default_rng``, as ``tests/test_decode_equiv.py`` draws them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(b, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.img_embed_dim)).astype(np.float32)
    return out


def prefix(batch, s: int):
    """The batch cut to its first ``s`` tokens (frames stay whole)."""
    return dict(batch, tokens=batch["tokens"][:, :s])


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def all_experts(arch: str) -> dict:
    """For the MoE archs, the override that routes every token to every
    expert (top_k = n_experts): no discrete routing choice is left for bf16
    rounding to flip. {} for the others."""
    moe = reduced(get_config(arch)).moe
    return {} if moe is None else {"moe": (("top_k", moe.n_experts),)}


@functools.lru_cache(maxsize=None)
def _ref_fn(kind: str, arch: str, compute: str, over: tuple, max_seq: int):
    cfg = ref_cfg(arch, compute, **dict(over))
    if kind == "forward":
        return jax.jit(lambda p, b: ref_api.forward(p, cfg, b))
    if kind == "prefill":
        return jax.jit(lambda p, b: ref_api.prefill(p, cfg, b, max_seq))
    return jax.jit(lambda p, c, t, pos: ref_api.decode_step(p, cfg, c, t,
                                                            pos))


def ref_forward_fn(arch: str, compute: str, **over):
    return _ref_fn("forward", arch, compute, tuple(sorted(over.items())), 0)


def ref_prefill_fn(arch: str, compute: str, max_seq: int = MAX, **over):
    return _ref_fn("prefill", arch, compute, tuple(sorted(over.items())),
                   max_seq)


def ref_decode_fn(arch: str, compute: str, **over):
    return _ref_fn("decode", arch, compute, tuple(sorted(over.items())), 0)


def first_pos(cfg, s: int) -> int:
    return s + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
