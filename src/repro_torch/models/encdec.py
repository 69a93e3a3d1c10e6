"""Whisper-style encoder-decoder backbone (audio family).

The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings [B, S_frames, d_model] (what the two conv layers would emit).
Encoder: bidirectional self-attention + GELU MLP with sinusoidal
positions. Decoder: causal self-attention + cross-attention to the
encoder memory + GELU MLP, sinusoidal positions, tied unembedding.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm, embed, embed_spec, norm_spec, sinusoid, sinusoidal_positions,
    unembed,
)
from repro_torch.models.lm import _stacked_norm
from repro_torch.models.mlp import apply_mlp, mlp_spec
from repro_torch.models.module import tree_index


def encdec_spec(cfg: ModelConfig) -> Dict:
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "enc": {
            "layers": {
                "ln1": _stacked_norm(cfg, ne),
                "attn": attn.attn_spec(cfg, layers=ne),
                "ln2": _stacked_norm(cfg, ne),
                "mlp": mlp_spec(cfg, layers=ne),
            },
            "final_norm": norm_spec(cfg.d_model, cfg.norm),
        },
        "dec": {
            "layers": {
                "ln1": _stacked_norm(cfg, nd),
                "self_attn": attn.attn_spec(cfg, layers=nd),
                "ln_x": _stacked_norm(cfg, nd),
                "cross_attn": attn.attn_spec(cfg, layers=nd),
                "ln2": _stacked_norm(cfg, nd),
                "mlp": mlp_spec(cfg, layers=nd),
            },
            "final_norm": norm_spec(cfg.d_model, cfg.norm),
        },
    }


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Decoder input: token embeddings + sinusoidal positions 0..S-1."""
    dt = cfg.compute_dtype
    x = embed(params["embed"], tokens, dt)
    return x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                    tokens.device).to(dt)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S, d_model] (stubbed conv output) → memory [B, S, d]."""
    dt = cfg.compute_dtype
    s = frames.shape[1]
    x = frames.to(dt) + sinusoidal_positions(s, cfg.d_model,
                                             frames.device).to(dt)
    layers = params["enc"]["layers"]
    for i in range(cfg.n_enc_layers):
        pp = tree_index(layers, i)
        h = apply_norm(pp["ln1"], x, cfg.norm)
        x = x + attn.attention(pp["attn"], cfg, h, causal=False)
        h = apply_norm(pp["ln2"], x, cfg.norm)
        x = x + apply_mlp(pp["mlp"], cfg, h)
    return apply_norm(params["enc"]["final_norm"], x, cfg.norm)


def decoder_layer(pp, cfg: ModelConfig, x: torch.Tensor,
                  memory: torch.Tensor) -> torch.Tensor:
    """One teacher-forced decoder layer (self, cross, MLP)."""
    h = apply_norm(pp["ln1"], x, cfg.norm)
    x = x + attn.attention(pp["self_attn"], cfg, h, causal=True)
    h = apply_norm(pp["ln_x"], x, cfg.norm)
    x = x + attn.attention(pp["cross_attn"], cfg, h, causal=False,
                           kv_x=memory)
    h = apply_norm(pp["ln2"], x, cfg.norm)
    return x + apply_mlp(pp["mlp"], cfg, h)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass → logits [B, S, V]."""
    x = embed_tokens(params, cfg, tokens)
    for i in range(cfg.n_layers):
        x = decoder_layer(tree_index(params["dec"]["layers"], i), cfg, x,
                          memory)
    x = apply_norm(params["dec"]["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x, cfg.compute_dtype)


def encdec_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    memory = encode(params, cfg, frames)
    logits = decode_train(params, cfg, tokens, memory)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Serving: self-attn KV cache + precomputed cross K/V.
# ---------------------------------------------------------------------------

def encdec_cache_abstract(cfg: ModelConfig, batch: int, max_seq: int,
                          enc_len: int) -> Dict:
    """The cache tree's shapes and dtypes as ``meta`` tensors."""
    nd = cfg.n_layers
    self_c = attn.cache_abstract(cfg, batch, max_seq, nd)
    kv = (nd, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    cross_c = {
        "k": torch.empty(kv, dtype=cfg.compute_dtype, device="meta"),
        "v": torch.empty(kv, dtype=cfg.compute_dtype, device="meta"),
        "pos": torch.empty((nd, batch, enc_len), dtype=torch.int32,
                           device="meta"),
    }
    return {"self": self_c, "cross": cross_c}


def build_cross_cache(params, cfg: ModelConfig, memory: torch.Tensor
                      ) -> Dict:
    """Precompute per-layer cross-attention K/V from the encoder memory."""
    dt = cfg.compute_dtype
    b, s, _ = memory.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        pp = tree_index(params["dec"]["layers"]["cross_attn"], i)
        k = memory @ pp["wk"].to(dt)
        v = memory @ pp["wv"].to(dt)
        if cfg.qkv_bias:
            k = k + pp["bk"].to(dt)
            v = v + pp["bv"].to(dt)
        ks.append(k.reshape(b, s, cfg.n_kv_heads, cfg.hd))
        vs.append(v.reshape(b, s, cfg.n_kv_heads, cfg.hd))
    pos = torch.arange(s, dtype=torch.int32, device=memory.device)
    return {"k": torch.stack(ks), "v": torch.stack(vs),
            "pos": pos[None, None].expand(cfg.n_layers, b, s).contiguous()}


def encdec_decode_step(params, cfg: ModelConfig, caches,
                       token: torch.Tensor, pos) -> Tuple[torch.Tensor, Any]:
    """One decoder token; the self-attention caches are updated in place."""
    dt = cfg.compute_dtype
    x = embed(params["embed"], token, dt)
    # sinusoidal position of the current decode position
    pe = sinusoid(torch.tensor(float(pos), device=token.device), cfg.d_model)
    x = x + pe.to(dt)
    layers = params["dec"]["layers"]
    for i in range(cfg.n_layers):
        pp = tree_index(layers, i)
        self_c = tree_index(caches["self"], i)
        cross_c = tree_index(caches["cross"], i)
        h = apply_norm(pp["ln1"], x, cfg.norm)
        mx, _ = attn.decode_attention(pp["self_attn"], cfg, h, self_c, pos)
        x = x + mx
        h = apply_norm(pp["ln_x"], x, cfg.norm)
        mx, _ = attn.decode_attention(pp["cross_attn"], cfg, h, cross_c,
                                      pos, cross=True)
        x = x + mx
        h = apply_norm(pp["ln2"], x, cfg.norm)
        x = x + apply_mlp(pp["mlp"], cfg, h)
    x = apply_norm(params["dec"]["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x, dt), caches
