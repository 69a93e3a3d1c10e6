"""Mixture-of-Experts: top-k token-choice routing with sort-based grouped
dispatch (MegaBlocks-style) and a per-expert capacity.

The dispatch is, relationally, a D2D join + group-by between the token
matrix and the expert assignment matrix: only the (token, expert) pairs
selected by the router are computed, with a capacity bound playing the
role of the paper's block-skip. Same capacity, drop slot and aux loss as
the JAX package.

The combine is deterministic on the card: instead of a scatter-add of
the assignments into their tokens (atomics in CUDA, so bf16 results that
change from run to run), the per-assignment rows go back to their
``[T, k]`` order through the sort's permutation and are summed over k in
a fixed order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import shard_act


def moe_spec(cfg: ModelConfig, layers: Optional[int] = None) -> Dict:
    if cfg.moe is None:
        raise ValueError(f"{cfg.arch_id} has no MoE config")
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.n_experts
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "router": ParamSpec(lead + (d, e), la + ("embed", None)),
        "w_gate": ParamSpec(lead + (e, d, f), la + ("experts", "embed",
                                                    "ffn")),
        "w_up": ParamSpec(lead + (e, d, f), la + ("experts", "embed",
                                                  "ffn")),
        "w_down": ParamSpec(lead + (e, f, d), la + ("experts", "ffn",
                                                    "embed")),
    }


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] → (y [B,S,d], aux_loss scalar).

    Sort-based grouped dispatch:
      1. router logits → top-k (expert_idx, weight) per token
      2. flatten to T·k assignments, sort by expert id
      3. positions within each expert group via rank arithmetic; drop
         beyond capacity
      4. scatter token activations into [G, E, C, d]; batched expert einsum
      5. gather back, weight, and sum per token

    With ``moe.grouped_dispatch`` the token pool is split per batch row
    (G = B), with per-group capacity. (The JAX package's shard_map
    dispatch, behind ``REPRO_MOE_SHARDMAP`` with a mesh installed, has no
    counterpart: the port runs on one device.)
    """
    m = cfg.moe
    dt = cfg.compute_dtype
    b, s, d = x.shape
    g = b if m.grouped_dispatch else 1
    t = (b * s) // g
    e_num = m.n_experts
    k = m.top_k
    xt = x.reshape(g, t, d)

    logits = (xt @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)   # [G, T, k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # aux load-balancing loss (Switch-style), averaged over groups
    me = probs.mean(dim=1)                                  # [G, E]
    flat_idx = idx.reshape(g, t * k)
    ce = torch.zeros((g, e_num), dtype=torch.float32, device=x.device)
    ce.scatter_add_(1, flat_idx, torch.full(flat_idx.shape, 1.0 / (t * k),
                                            device=x.device))
    aux = e_num * torch.mean(torch.sum(me * ce, dim=-1)) \
        * m.router_aux_weight

    c = _capacity(t, m)
    out = _dispatch_block(xt, idx, gate, p["w_gate"].to(dt),
                          p["w_up"].to(dt), p["w_down"].to(dt), m=m, dt=dt,
                          c=c)
    return out.reshape(b, s, d), aux


def _dispatch_block(xt, idx, gate, w_gate, w_up, w_down, *, m, dt, c):
    """Sort-based dispatch + expert einsum + combine over [G, T, ...]."""
    g, t, d = xt.shape
    k = m.top_k
    e_num = m.n_experts
    dev = xt.device
    gi = torch.arange(g, device=dev)[:, None]
    flat_e = idx.reshape(g, t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)[None] \
        .expand(g, t * k)
    flat_g = gate.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_tok, 1, order)
    sg = torch.gather(flat_g, 1, order)
    # rank within each expert group: start offset of expert e is the count
    # of assignments with expert id < e
    experts = torch.arange(e_num, device=dev)
    starts = torch.sum(se[:, None, :] < experts[None, :, None], dim=-1)
    pos = torch.arange(t * k, device=dev)[None] - torch.gather(starts, 1, se)
    keep = pos < c
    target = torch.where(keep, se * c + pos, e_num * c)    # drop slot
    gathered = xt[gi, st].to(dt)                           # [G, T·k, d]
    buf = torch.zeros((g, e_num * c + 1, d), dtype=dt, device=dev)
    buf[gi, target] = gathered
    grouped = shard_act(buf[:, :-1].reshape(g, e_num, c, d),
                        "batch", "act_experts", None, None)

    # --- expert FFN (batched over the expert axis) --------------------------
    g_ = torch.einsum("gecd,edf->gecf", grouped, w_gate)
    u_ = torch.einsum("gecd,edf->gecf", grouped, w_up)
    h = shard_act(F.silu(g_) * u_, "batch", "act_experts", None, "act_ffn")
    y_e = torch.einsum("gecf,efd->gecd", h, w_down)

    # --- combine ------------------------------------------------------------
    flat_y = y_e.reshape(g, e_num * c, d)
    safe_target = torch.clamp_max(target, e_num * c - 1)
    per_assign = torch.where(keep[..., None], flat_y[gi, safe_target],
                             torch.zeros((), dtype=dt, device=dev))
    weighted = per_assign * sg[..., None].to(dt)           # sorted order
    # back to [T, k] order (``order`` is a permutation: no collisions)
    unsorted = torch.empty_like(weighted)
    unsorted[gi, order] = weighted
    unsorted = unsorted.reshape(g, t, k, d)
    out = torch.zeros((g, t, d), dtype=dt, device=dev)
    for j in range(k):                                     # fixed order
        out = out + unsorted[:, :, j]
    return shard_act(out, "batch", None, None)
