"""Attention: GQA/MHA with qk-norm, QKV bias, sliding window, RoPE;
full / chunked (online-softmax schedule) / decode paths; ring-buffer SWA
cache.

Plain tensor ops that follow the JAX package's arithmetic: f32 logits
from the compute-dtype q and k, a finite ``NEG_INF`` mask value, and the
softmax cast back to the compute dtype before the product with v. The
chunked path is the same online-softmax schedule over KV chunks, for
sequences at or above ``cfg.chunked_attn_threshold``.

Decode writes the new key and value into the layer's cache tensors in
place (slot ``pos % n``; for sliding-window configs ``n`` is the window
and the writes wrap as a ring buffer, with per-slot positions keeping the
mask exact).

Under a device mesh (``sharding.ctx``) the projections run on DTensors
with the weights gathered over the FSDP axes, the activation sites pin
the JAX package's specs, and each rank writes its own shard of a cache
(only the rank holding the slot, for a cache cut along the sequence).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rms_head_norm
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import (
    from_local_like, local, local_cut_like, per_shard, reduce_partial,
    shard_act, shard_unflatten, weight, write_slot,
)

NEG_INF = -2.0 ** 20  # large-but-finite mask value (bf16-safe)


def attn_spec(cfg: ModelConfig, layers: Optional[int] = None,
              cross: bool = False) -> Dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    spec = {
        "wq": ParamSpec(lead + (d, hq * hd), la + ("embed", "heads")),
        "wk": ParamSpec(lead + (d, hkv * hd), la + ("embed", "kv_heads")),
        "wv": ParamSpec(lead + (d, hkv * hd), la + ("embed", "kv_heads")),
        "wo": ParamSpec(lead + (hq * hd, d), la + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec(lead + (hq * hd,), la + ("heads",), "zeros")
        spec["bk"] = ParamSpec(lead + (hkv * hd,), la + ("kv_heads",),
                               "zeros")
        spec["bv"] = ParamSpec(lead + (hkv * hd,), la + ("kv_heads",),
                               "zeros")
    if cfg.attn_out_bias:
        spec["bo"] = ParamSpec(lead + (d,), la + ("embed",), "zeros")
    if cfg.qk_norm:
        spec["q_norm"] = ParamSpec(lead + (hd,), la + (None,), "ones")
        spec["k_norm"] = ParamSpec(lead + (hd,), la + (None,), "ones")
    return spec


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    dt = cfg.compute_dtype
    kv_x = x if kv_x is None else kv_x
    q = x @ weight(p["wq"], dt)
    k = kv_x @ weight(p["wk"], dt)
    v = kv_x @ weight(p["wv"], dt)
    if cfg.qkv_bias:
        q = q + weight(p["bq"], dt)
        k = k + weight(p["bk"], dt)
        v = v + weight(p["bv"], dt)
    heads = ("batch", None, "act_heads", None)
    q = shard_unflatten(q, 2, (cfg.n_heads, cfg.hd), *heads)
    k = shard_unflatten(k, 2, (cfg.n_kv_heads, cfg.hd), *heads)
    v = shard_unflatten(v, 2, (cfg.n_kv_heads, cfg.hd), *heads)
    if cfg.qk_norm:
        q = rms_head_norm(weight(p["q_norm"], torch.float32), q)
        k = rms_head_norm(weight(p["k_norm"], torch.float32), k)
    return q, k, v


def _out_proj(p, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    dt = cfg.compute_dtype
    y = reduce_partial(o.reshape(b, s, -1) @ weight(p["wo"], dt))
    if cfg.attn_out_bias:
        y = y + weight(p["bo"], dt)
    return y


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """[..., S, T] bool allowed-attention mask."""
    diff = qpos[..., :, None] - kpos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    return ok


def _expand_kv(q, k, v):
    """Repeat each KV head to the query head count (GQA)."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        # each cut of the KV heads (or of the cache's slots) repeats alone
        k, v = (per_shard(lambda t: t.repeat_interleave(g, dim=2), x,
                          x.shape[:2] + (x.shape[2] * g,) + x.shape[3:])
                for x in (k, v))
    return k, v


# Under a device mesh every rank attends over its own batch rows and heads:
# q, k and v are laid out alike (the sites pin them so) and the products,
# mask and softmax run on the shards; the result takes q's cut. DTensor
# would have to flatten a batch cut and a head cut into one dim for bmm.
_BATCH_HEADS = {0: 0, 2: 2}
_TO_LOGITS = {0: 0, 2: 1}      # q's batch and heads → logits [B,H,S,T]


def _shards(q, k, v):
    return (local(q), local_cut_like(k, q, _BATCH_HEADS),
            local_cut_like(v, q, _BATCH_HEADS))


def _pin_logits(lg, q, shape):
    """The logits site (``batch``, ``act_heads``) on this rank's shard."""
    return local(shard_act(from_local_like(lg, q, _TO_LOGITS, shape),
                           "batch", "act_heads", None, None))


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q [B,S,Hq,hd], k/v [B,T,Hkv,hd], mask [B?,S,T] → [B,S,Hq,hd]."""
    b, s, h, hd = q.shape
    k, v = _expand_kv(q, k, v)
    k = shard_act(k, "batch", None, "act_heads", None)
    v = shard_act(v, "batch", None, "act_heads", None)
    t = k.shape[1]
    ql, kl, vl = _shards(q, k, v)
    mask = local_cut_like(mask, q, {0: 0} if mask.shape[0] == b else {})
    scale = hd ** -0.5
    # f32 logits from the compute-dtype operands (products exact in f32)
    logits = torch.einsum("bshd,bthd->bhst", ql.float(), kl.float()) * scale
    while mask.ndim < logits.ndim:
        mask = mask[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    logits = _pin_logits(logits, q, (b, h, s, t))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhst,bthd->bshd", w, vl)
    return from_local_like(o, q, {0: 0, 1: 1, 2: 2, 3: 3}, q.shape)


def _chunked_sdpa(q, k, v, q_offset: int, causal: bool,
                  window: Optional[int], qc: int, kc: int) -> torch.Tensor:
    """Online softmax over KV chunks, one query chunk at a time: the
    working set is O(qc·kc) logits, not O(S·T)."""
    b, s, hq, hd = q.shape
    k, v = _expand_kv(q, k, v)
    t, h = k.shape[1], k.shape[2]
    qc = min(qc, s)
    kc = min(kc, t)
    if s % qc or t % kc:
        raise ValueError(f"chunks must divide the sequences: S={s} qc={qc} "
                         f"T={t} kc={kc}")
    scale = hd ** -0.5
    dev = q.device
    ql, kl, vl = _shards(q, k, v)
    lb, lh = ql.shape[0], ql.shape[2]    # this rank's rows and heads
    outs = []
    for qi in range(s // qc):
        qb = ql[:, qi * qc:(qi + 1) * qc]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((lb, lh, qc), float("-inf"), device=dev)
        l = torch.zeros((lb, lh, qc), device=dev)
        acc = torch.zeros((lb, qc, lh, hd), device=dev)   # f32 accumulator
        for ki in range(t // kc):
            kb = kl[:, ki * kc:(ki + 1) * kc]
            vb = vl[:, ki * kc:(ki + 1) * kc]
            kpos = ki * kc + torch.arange(kc, device=dev)
            msk = _mask(qpos, kpos, causal, window)       # [qc, kc]
            lg = torch.einsum("bshd,bthd->bhst", qb.float(),
                              kb.float()) * scale
            lg = torch.where(msk[None, None], lg, NEG_INF)
            lg = _pin_logits(lg, q, (b, h, qc, kc))
            m2 = torch.maximum(m, lg.amax(dim=-1))
            corr = torch.exp(m - m2)
            pr = torch.exp(lg - m2[..., None])
            l = l * corr + pr.sum(dim=-1)
            pv = torch.einsum("bhst,bthd->bshd", pr.to(q.dtype), vb)
            acc = acc * corr.transpose(1, 2)[..., None] + pv.float()
            m = m2
        l = torch.clamp_min(l, 1e-20)
        outs.append((acc / l.transpose(1, 2)[..., None]).to(q.dtype))
    return from_local_like(torch.cat(outs, dim=1), q,
                           {0: 0, 1: 1, 2: 2, 3: 3}, q.shape)


def attention(p, cfg: ModelConfig, x: torch.Tensor, *,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    s, t = q.shape[1], k.shape[1]
    dev = x.device
    if causal and kv_x is None:
        qpos = q_offset + torch.arange(s, device=dev)
        kpos = torch.arange(t, device=dev)
        q = apply_rope(q, qpos[None], cfg.rope_theta)
        k = apply_rope(k, kpos[None], cfg.rope_theta)
    if max(s, t) >= cfg.chunked_attn_threshold:
        o = _chunked_sdpa(q, k, v, q_offset, causal, cfg.sliding_window,
                          cfg.attn_chunk_q, cfg.attn_chunk_kv)
    else:
        qpos = (q_offset + torch.arange(s, device=dev))[None]
        kpos = torch.arange(t, device=dev)[None]
        msk = _mask(qpos, kpos, causal, cfg.sliding_window)
        o = _sdpa(q, k, v, msk)
    return _out_proj(p, cfg, o)


# ---------------------------------------------------------------------------
# KV cache (decode): plain cache for full attention; ring buffer for SWA.
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def cache_abstract(cfg: ModelConfig, batch: int, max_seq: int, layers: int,
                   dtype=None) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtypes as ``meta`` tensors."""
    n = cache_len(cfg, max_seq)
    dt = dtype or cfg.compute_dtype
    kv = (layers, batch, n, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.empty(kv, dtype=dt, device="meta"),
        "v": torch.empty(kv, dtype=dt, device="meta"),
        "pos": torch.empty((layers, batch, n), dtype=torch.int32,
                           device="meta"),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, layers: int,
               device, dtype=None) -> Dict[str, torch.Tensor]:
    n = cache_len(cfg, max_seq)
    dt = dtype or cfg.compute_dtype
    kv = (layers, batch, n, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "pos": torch.full((layers, batch, n), -1, dtype=torch.int32,
                          device=device),
    }


def decode_attention(p, cfg: ModelConfig, x: torch.Tensor,
                     layer_cache: Dict[str, torch.Tensor],
                     pos: Union[int, torch.Tensor],
                     cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x [B,1,d]; layer_cache k/v [B,N,Hkv,hd], pos [B,N].

    Writes the new key, value and position into slot ``pos % N`` of
    ``layer_cache`` in place and returns it. For cross-attention the cache
    holds the (precomputed) encoder K/V and is left untouched.
    """
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if cross:
        # cache holds precomputed encoder K/V; no rope (whisper-style)
        msk = layer_cache["pos"][:, None, :] >= 0
        o = _sdpa(q, layer_cache["k"], layer_cache["v"], msk)
        return _out_proj(p, cfg, o), layer_cache
    pos = int(pos)
    n = layer_cache["k"].shape[1]
    qpos = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k_new = apply_rope(k_new, qpos, cfg.rope_theta)
    slot = pos % n
    k, v, cpos = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    write_slot(k, slot, k_new[:, 0])
    write_slot(v, slot, v_new[:, 0])
    write_slot(cpos, slot, pos)
    valid = cpos >= 0
    allowed = cpos <= pos
    if cfg.sliding_window is not None:
        allowed &= (pos - cpos) < cfg.sliding_window
    msk = (valid & allowed)[:, None, :]
    o = _sdpa(q, k, v, msk)
    return _out_proj(p, cfg, o), layer_cache


def prefill_kv(p, cfg: ModelConfig, x: torch.Tensor, max_seq: int
               ) -> Dict[str, torch.Tensor]:
    """Build a decode cache from a full prefill pass over x [B,S,d]."""
    _, k, v = _project_qkv(p, cfg, x)
    b, s = k.shape[0], k.shape[1]
    dev = x.device
    kpos = torch.arange(s, device=dev)[None]
    k = apply_rope(k, kpos, cfg.rope_theta)
    n = cache_len(cfg, max_seq)
    # the sites pin the sequence whole (uncut), so under a device mesh
    # each shard is rolled or padded along it alone
    if s >= n:
        ks, vs = k[:, s - n:], v[:, s - n:]
        ps = torch.arange(s - n, s, device=dev)[None].expand(b, n)
        # ring-buffer invariant: position p lives at slot p % n
        shift = (s - n) % n
        if shift:
            ks, vs = (per_shard(lambda t: torch.roll(t, shift, dims=1), x,
                                x.shape) for x in (ks, vs))
            ps = torch.roll(ps, shift, dims=1)
    else:
        pad = n - s
        ks, vs = (per_shard(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), x,
                            (b, n) + tuple(x.shape[2:])) for x in (k, v))
        ps = F.pad(torch.arange(s, device=dev)[None].expand(b, s),
                   (0, pad), value=-1)
    return {"k": ks.contiguous(), "v": vs.contiguous(),
            "pos": ps.to(torch.int32).contiguous()}
