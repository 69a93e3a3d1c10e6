"""Architecture configuration schema + the shape suite.

Every architecture gets a ``ModelConfig`` in its own module; the registry
in ``repro_torch.configs`` resolves ``--arch <id>``. Shapes: train_4k /
prefill_32k / decode_32k / long_500k. Dtypes are ``torch`` dtypes:
parameters are stored in ``param_dtype`` and cast to ``compute_dtype`` at
use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    every: int = 1                 # MoE layer every N layers (jamba: 2)
    router_aux_weight: float = 0.01
    # PERF: dispatch per batch-row group (sort/scatter stay DP-local; no
    # global-order collectives) instead of one global token pool
    grouped_dispatch: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"            # mamba | rwkv6
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    activation: str = "swiglu"              # swiglu | gelu | sq_relu
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2.5 / stablelm(partial)
    attn_out_bias: bool = False
    sliding_window: Optional[int] = None    # mixtral SWA
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None        # hybrid: 1 attention per N layers
    attn_index: int = 4                     # position of attn inside a block
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # multimodal stub frontends
    n_img_tokens: int = 0
    img_embed_dim: int = 0                  # CLIP hidden dim (stub input)
    n_audio_frames: int = 0                 # whisper stub frame count factor
    # numerics
    param_dtype: object = torch.float32
    compute_dtype: object = torch.bfloat16
    # remat policy: none | dots | full
    remat: str = "full"
    # sub-quadratic attention chunking threshold (online-softmax schedule)
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 2048
    chunked_attn_threshold: int = 8192
    # PERF knobs. Defaults = paper-faithful naive baseline; ``perf_variant``
    # flips them. ``ssm_unroll`` only changes the JAX package's scan schedule:
    # the port's recurrences are loops over time and ignore it.
    ssm_unroll: int = 1
    prefill_last_only: bool = False  # unembed only the last prefill position
    loss_chunk: int = 0            # seq-chunked CE (0 = materialize logits)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid / sliding-window.)"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return tuple([self.ssm.kind] * self.n_layers)
        if self.family == "hybrid":
            period = self.attn_every or 8
            return tuple(
                "attn" if (i % period) == self.attn_index else "mamba"
                for i in range(self.n_layers))
        return tuple(["attn"] * self.n_layers)

    def ffn_kinds(self) -> Tuple[str, ...]:
        if self.moe is None:
            return tuple(["mlp"] * self.n_layers)
        ev = self.moe.every
        return tuple("moe" if (i % ev) == (ev - 1) or ev == 1 else "mlp"
                     for i in range(self.n_layers))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 8),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_img_tokens=min(cfg.n_img_tokens, 16),
        img_embed_dim=min(cfg.img_embed_dim, 64) if cfg.img_embed_dim else 0,
        sliding_window=min(cfg.sliding_window, 64)
        if cfg.sliding_window else None,
        remat="none",
        chunked_attn_threshold=1 << 30,
    )
    if cfg.moe is not None:
        # capacity_factor high enough that smoke tests are drop-free: token
        # dropping makes outputs depend on the batch grouping, which would
        # break exact prefill↔forward equivalence checks
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff=128, capacity_factor=8.0)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=8,
                                           rwkv_decay_lora=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def perf_variant(cfg: ModelConfig) -> ModelConfig:
    """Beyond-paper optimized configuration: the knobs the JAX package's
    perf loop kept (flash@4k and remat=dots are deliberately not in it)."""
    over = dict(
        ssm_unroll=32,                 # chunked-remat recurrences (32-step)
        prefill_last_only=True,        # serve-prefill: last-position unembed
        loss_chunk=512,                # CE without [B,S,V] materialization
    )
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, grouped_dispatch=True)
    return dataclasses.replace(cfg, **over)


def apply_variant(cfg: ModelConfig, name: str) -> ModelConfig:
    """Named config variants (single knobs isolate one change each;
    'perf' = all of them)."""
    if name == "baseline":
        return cfg
    if name == "perf":
        return perf_variant(cfg)
    if name.startswith("unroll"):
        return dataclasses.replace(cfg, ssm_unroll=int(name[6:]))
    if name == "flash":
        return dataclasses.replace(cfg, chunked_attn_threshold=2048)
    if name == "grouped":
        assert cfg.moe is not None
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, grouped_dispatch=True))
    if name == "losschunk":
        return dataclasses.replace(cfg, loss_chunk=512)
    if name == "rematdots":
        return dataclasses.replace(cfg, remat="dots")
    if name == "lastonly":
        return dataclasses.replace(cfg, prefill_last_only=True)
    raise KeyError(name)
