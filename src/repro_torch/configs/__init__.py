"""Architecture registry: ``--arch <id>`` resolution + input_specs().

``input_specs(cfg, shape)`` returns ``meta``-device tensors standing in for
every model input of the given shape cell: the right shapes and dtypes,
no storage (what the JAX package's ``jax.ShapeDtypeStruct`` stand-ins are
there).
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mixtral-8x7b": "mixtral_8x7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2.5-14b": "qwen2_5_14b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-1.7b": "qwen3_1_7b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-small": "whisper_small",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; know {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(supported, reason) for an (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(full-attn): 500k decode needs sub-quadratic state"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Model-input stand-ins (``meta`` tensors) for one (arch × shape) cell.

    train:   {tokens, labels} (+frontend stubs)
    prefill: {tokens} (+frontend stubs)
    decode:  {token, pos} — the KV/state caches come from the model's
             cache_abstract (carried state, not per-step inputs).
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "audio":
        if shape.kind == "train":
            return {
                "frames": _meta((b, s, cfg.d_model), torch.float32),
                "tokens": _meta((b, s), i32),
                "labels": _meta((b, s), i32),
            }
        if shape.kind == "prefill":
            return {
                "frames": _meta((b, s, cfg.d_model), torch.float32),
                "tokens": _meta((b, s), i32),
            }
        return {"token": _meta((b, 1), i32), "pos": _meta((), i32)}
    if cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        if shape.kind == "train":
            return {
                "tokens": _meta((b, s - n_img), i32),
                "img_embeds": _meta((b, n_img, cfg.img_embed_dim),
                                    torch.float32),
                "labels": _meta((b, s), i32),
            }
        if shape.kind == "prefill":
            return {
                "tokens": _meta((b, s - n_img), i32),
                "img_embeds": _meta((b, n_img, cfg.img_embed_dim),
                                    torch.float32),
            }
        return {"token": _meta((b, 1), i32), "pos": _meta((), i32)}
    if shape.kind == "train":
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), i32)}
    return {"token": _meta((b, 1), i32), "pos": _meta((), i32)}


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "all_configs", "cell_supported", "input_specs", "reduced"]
