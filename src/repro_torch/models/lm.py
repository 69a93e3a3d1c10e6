"""Decoder-only LM assembly for every non-enc-dec architecture.

Heterogeneous depth patterns (jamba's 1-attention-per-8 interleave, MoE
every-other-layer, RWKV's paired mixers) are expressed as a *block
program*: the minimal repeating period of (mixer, ffn) positions.
Parameters for each period position are stacked over the n_blocks repeats
(a leading dim on every leaf) and the model loops over blocks — the JAX
package scans over it. Every loop takes the blocks once with
``tree_unbind`` (one gradient stack a leaf in the backward); a training
forward wraps each in ``cfg.remat``'s recompute policy.

Decode writes the stacked caches in place: block i's slice of every cache
leaf is a view, and each mixer updates its view (under a device mesh,
each rank its own shard: ``ctx.write_slot`` for the KV caches,
``ctx.write_state`` for the recurrent states).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import apply_norm, embed, embed_spec, \
    norm_spec, unembed
from repro_torch.models.mlp import apply_mlp, mlp_spec
from repro_torch.models.moe import apply_moe, moe_spec
from repro_torch.models.module import ParamSpec, remat, tree_map, \
    tree_unbind
from repro_torch.sharding.ctx import shard_act, weight, write_state
from repro_torch.sharding.specs import pin_caches


@dataclasses.dataclass(frozen=True)
class PositionSpec:
    mixer: str   # attn | mamba | rwkv
    ffn: str     # mlp | moe | rwkv_cm | none


@dataclasses.dataclass(frozen=True)
class BlockProgram:
    period: int
    n_blocks: int
    positions: Tuple[PositionSpec, ...]

    @property
    def attn_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, p in enumerate(self.positions)
                     if p.mixer == "attn")


def build_program(cfg: ModelConfig) -> BlockProgram:
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        pattern = [PositionSpec("rwkv", "rwkv_cm")] * cfg.n_layers
    else:
        pattern = [PositionSpec(m, f)
                   for m, f in zip(cfg.layer_kinds(), cfg.ffn_kinds())]
    n = len(pattern)
    period = n
    for p in range(1, n + 1):
        if n % p == 0 and pattern[:p] * (n // p) == pattern:
            period = p
            break
    return BlockProgram(period, n // period, tuple(pattern[:period]))


# ---------------------------------------------------------------------------
# Parameter specs.
# ---------------------------------------------------------------------------

def _position_spec(cfg: ModelConfig, ps: PositionSpec, n_blocks: int) -> Dict:
    # params are ALWAYS stacked with a leading n_blocks dim (which may be
    # 1): uniform treatment keeps decode caches and params congruent
    L = n_blocks
    spec: Dict[str, Any] = {"ln1": _stacked_norm(cfg, L)}
    if ps.mixer == "attn":
        spec["attn"] = attn.attn_spec(cfg, layers=L)
    elif ps.mixer == "mamba":
        spec["mamba"] = mamba_mod.mamba_spec(cfg, layers=L)
    elif ps.mixer == "rwkv":
        spec["rwkv_t"] = rwkv_mod.rwkv_time_spec(cfg, layers=L)
    if ps.ffn != "none":
        spec["ln2"] = _stacked_norm(cfg, L)
    if ps.ffn == "mlp":
        spec["mlp"] = mlp_spec(cfg, layers=L)
    elif ps.ffn == "moe":
        spec["moe"] = moe_spec(cfg, layers=L)
    elif ps.ffn == "rwkv_cm":
        spec["rwkv_c"] = rwkv_mod.rwkv_channel_spec(cfg, layers=L)
    return spec


def _stacked_norm(cfg: ModelConfig, L: int) -> Dict:
    base = norm_spec(cfg.d_model, cfg.norm)
    return {k: ParamSpec((L,) + s.shape, ("layers",) + s.axes, s.init)
            for k, s in base.items()}


def lm_spec(cfg: ModelConfig) -> Dict:
    prog = build_program(cfg)
    spec: Dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "final_norm": norm_spec(cfg.d_model, cfg.norm),
        "blocks": {f"pos{i}": _position_spec(cfg, ps, prog.n_blocks)
                   for i, ps in enumerate(prog.positions)},
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"), "normal", scale=0.02)
    if cfg.n_img_tokens:
        spec["img_proj"] = {"w": ParamSpec(
            (cfg.img_embed_dim, cfg.d_model), (None, "embed"))}
    return spec


# ---------------------------------------------------------------------------
# Forward (train / prefill-without-cache).
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                  img_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = embed(params["embed"], tokens, dt)
    if cfg.n_img_tokens and img_embeds is not None:
        img = img_embeds.to(dt) @ weight(params["img_proj"]["w"], dt)
        x = torch.cat([img, x], dim=1)
    return x


def _apply_position(cfg: ModelConfig, ps: PositionSpec, pp, x, aux):
    x = shard_act(x, "batch", None, None)
    h = apply_norm(pp["ln1"], x, cfg.norm)
    if ps.mixer == "attn":
        mx = attn.attention(pp["attn"], cfg, h)
    elif ps.mixer == "mamba":
        mx = mamba_mod.apply_mamba(pp["mamba"], cfg, h)
    else:
        mx = rwkv_mod.apply_rwkv_time(pp["rwkv_t"], cfg, h)
    x = x + mx
    if ps.ffn != "none":
        h = apply_norm(pp["ln2"], x, cfg.norm)
        if ps.ffn == "mlp":
            y = apply_mlp(pp["mlp"], cfg, h)
        elif ps.ffn == "moe":
            y, a = apply_moe(pp["moe"], cfg, h)
            aux = aux + a
        else:
            y = rwkv_mod.apply_rwkv_channel(pp["rwkv_c"], cfg, h)
        x = x + y
    return x, aux


def _block_fn(cfg: ModelConfig, prog: BlockProgram):
    """One block (every position of the program) under ``cfg.remat``."""
    def block(x, aux, blk_params):
        for i, ps in enumerate(prog.positions):
            x, aux = _apply_position(cfg, ps, blk_params[f"pos{i}"], x, aux)
        return x, aux

    return remat(block, cfg.remat)


def lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
              img_embeds: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward without the unembedding: (x [B,S,d], aux).

    Under grad mode each block runs under ``cfg.remat`` (``full``: only its
    inputs are kept for the backward; ``dots``: its products' outputs
    too); the values do not depend on it."""
    prog = build_program(cfg)
    x = shard_act(_embed_inputs(params, cfg, tokens, img_embeds),
                  "batch", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _block_fn(cfg, prog)
    for blk in tree_unbind(params["blocks"], prog.n_blocks):
        x, aux = block(x, aux, blk)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


def output_weight(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def lm_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
               img_embeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S(-n_img)] (+ optional image patch embeddings) → logits.

    Returns (logits [B,S,V], moe aux loss scalar).
    """
    x, aux = lm_hidden(params, cfg, tokens, img_embeds)
    logits = shard_act(unembed(output_weight(params, cfg), x,
                               cfg.compute_dtype), "batch", None, "vocab")
    return logits, aux


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int,
               img_embeds: Optional[torch.Tensor] = None):
    """Full forward that also extracts the decode caches (prefill step).

    Returns (logits [B,S,V], caches) where caches match cache_abstract();
    under a device mesh they are laid out by ``cache_partition_specs``
    (the recurrent states come out of their mixers in that layout, so
    ``pin_caches`` moves none of them).
    """
    prog = build_program(cfg)
    x = _embed_inputs(params, cfg, tokens, img_embeds)
    per_block = []
    for blk in tree_unbind(params["blocks"], prog.n_blocks):
        caches = {}
        for i, ps in enumerate(prog.positions):
            pp = blk[f"pos{i}"]
            h = apply_norm(pp["ln1"], x, cfg.norm)
            if ps.mixer == "attn":
                mx = attn.attention(pp["attn"], cfg, h)
                cache = attn.prefill_kv(pp["attn"], cfg, h, max_seq)
            elif ps.mixer == "mamba":
                mx, cache = mamba_mod.apply_mamba(pp["mamba"], cfg, h,
                                                  return_state=True)
            else:
                mx, wkv, sh_t = rwkv_mod.apply_rwkv_time(
                    pp["rwkv_t"], cfg, h, return_state=True)
                cache = {"wkv": wkv, "shift_t": sh_t}
            x = x + mx
            if ps.ffn != "none":
                h = apply_norm(pp["ln2"], x, cfg.norm)
                if ps.ffn == "mlp":
                    y = apply_mlp(pp["mlp"], cfg, h)
                elif ps.ffn == "moe":
                    y, _ = apply_moe(pp["moe"], cfg, h)
                else:
                    y = rwkv_mod.apply_rwkv_channel(pp["rwkv_c"], cfg, h)
                    cache = dict(cache, shift_c=h[:, -1])
                x = x + y
            caches[f"pos{i}"] = cache
        per_block.append(caches)
    caches = pin_caches(cfg, tree_map(lambda *xs: torch.stack(xs),
                                      *per_block))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.prefill_last_only:
        x = x[:, -1:]   # serve-prefill only needs the next-token logits
    logits = unembed(output_weight(params, cfg), x, cfg.compute_dtype)
    return logits, caches


# ---------------------------------------------------------------------------
# Decode: single-token step over stacked per-block caches.
# ---------------------------------------------------------------------------

def cache_abstract(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """The cache tree's shapes and dtypes as ``meta`` tensors."""
    prog = build_program(cfg)
    nb = prog.n_blocks
    out: Dict[str, Any] = {}
    for i, ps in enumerate(prog.positions):
        key = f"pos{i}"
        if ps.mixer == "attn":
            out[key] = attn.cache_abstract(cfg, batch, max_seq, nb)
        elif ps.mixer == "mamba":
            out[key] = mamba_mod.mamba_state_abstract(cfg, batch, nb)
        else:
            out[key] = rwkv_mod.rwkv_state_abstract(cfg, batch, nb)
    return out


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zero caches (positions included, as the JAX package's)."""
    return tree_map(lambda st: torch.zeros(st.shape, dtype=st.dtype,
                                           device=device),
                    cache_abstract(cfg, batch, max_seq))


def _decode_position(cfg, ps: PositionSpec, pp, cache_slice, x, pos):
    """One position of one block; writes ``cache_slice`` in place."""
    h = apply_norm(pp["ln1"], x, cfg.norm)
    if ps.mixer == "attn":
        mx, _ = attn.decode_attention(pp["attn"], cfg, h, cache_slice, pos)
    elif ps.mixer == "mamba":
        mx, _ = mamba_mod.decode_mamba(pp["mamba"], cfg, h, cache_slice)
    else:
        mx, wkv, sh_t = rwkv_mod.decode_rwkv_time(
            pp["rwkv_t"], cfg, h, cache_slice["wkv"],
            cache_slice["shift_t"])
        write_state(cache_slice["wkv"], wkv)
        write_state(cache_slice["shift_t"], sh_t)
    x = x + mx
    if ps.ffn != "none":
        h = apply_norm(pp["ln2"], x, cfg.norm)
        if ps.ffn == "mlp":
            y = apply_mlp(pp["mlp"], cfg, h)
        elif ps.ffn == "moe":
            y, _ = apply_moe(pp["moe"], cfg, h)
        else:
            y, sh_c = rwkv_mod.decode_rwkv_channel(
                pp["rwkv_c"], cfg, h, cache_slice["shift_c"])
            write_state(cache_slice["shift_c"], sh_c)
        x = x + y
    return x


def lm_decode_step(params, cfg: ModelConfig, caches,
                   token: torch.Tensor, pos) -> Tuple[torch.Tensor, Any]:
    """token [B,1] int; pos int → (logits [B,1,V], caches).

    The caches are updated in place and returned."""
    prog = build_program(cfg)
    x = embed(params["embed"], token, cfg.compute_dtype)
    for blk, blk_cache in zip(tree_unbind(params["blocks"], prog.n_blocks),
                              tree_unbind(caches, prog.n_blocks)):
        for i, ps in enumerate(prog.positions):
            x = _decode_position(cfg, ps, blk[f"pos{i}"],
                                 blk_cache[f"pos{i}"], x, pos)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(output_weight(params, cfg), x, cfg.compute_dtype)
    return logits, caches
