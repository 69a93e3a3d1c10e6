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

Under a device mesh (``sharding.ctx``) the expert weights carry the
``experts`` logical axis, cut over the tensor axis when the expert count
divides it (EP), else their per-expert ``ffn`` dim is cut (ETP), as the
JAX package's specs give them; each is gathered over the FSDP axes only
(``ctx.weight``). The routing and the dispatch's index ops never mix
groups, so each rank runs them on local tensors over its own groups:
with ``grouped_dispatch`` (G = B) the batch rows its cut of the batch
axes holds, the program the JAX package's ``REPRO_MOE_SHARDMAP`` branch
writes as a ``shard_map`` manual over the batch axes (that branch and
the default one compute the same values, so the port has no flag); with
the global pool (G = 1) all tokens, gathered over the batch axes, every
rank dispatching the whole pool as GSPMD replicates it. The expert FFN
runs on each rank's experts (EP) or cut of ``ffn`` (ETP); the pinned
sites are the JAX package's five, and ``flat_y``'s pin gathers the
experts (EP) or all-reduces the products contracted over a cut ``ffn``
(ETP). The aux loss is whole on every rank: its mean over groups cut
over the batch axes is a sum reduced over them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import (
    device_mesh, from_local_like, from_shard, gather_dim, local,
    local_cut_like, per_shard, reduce_partial, shard_act, site_layout,
    sum_over, weight,
)


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
    (G = B), with per-group capacity. Under a device mesh ``x`` and ``y``
    are DTensors laid out alike and the aux loss a plain tensor, the same
    on every rank.
    """
    m = cfg.moe
    dt = cfg.compute_dtype
    b, s, d = x.shape
    g = b if m.grouped_dispatch else 1
    t = (b * s) // g
    e_num = m.n_experts
    k = m.top_k
    xt = _token_groups(x, g, t)
    xl = local(xt)                          # this rank's groups, whole

    # the router's gradient: a partial sum where the groups are cut
    logits = (xl @ local_cut_like(weight(p["router"], dt), xt, {})).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)   # [G, T, k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # aux load-balancing loss (Switch-style), averaged over groups
    me = probs.mean(dim=1)                                  # [G, E]
    flat_idx = idx.reshape(xl.shape[0], t * k)
    ce = torch.zeros((xl.shape[0], e_num), dtype=torch.float32,
                     device=xl.device)
    ce.scatter_add_(1, flat_idx, torch.full(flat_idx.shape, 1.0 / (t * k),
                                            device=xl.device))
    aux = e_num * _group_mean(torch.sum(me * ce, dim=-1), xt) \
        * m.router_aux_weight

    c = _capacity(t, m)
    out = _dispatch_block(xt, idx, gate, weight(p["w_gate"], dt),
                          weight(p["w_up"], dt), weight(p["w_down"], dt),
                          m=m, dt=dt, c=c)
    out = out.reshape(b, s, d)
    if device_mesh() is not None:
        out = out.redistribute(x.device_mesh, x.placements)
    return out, aux


def _token_groups(x, g: int, t: int):
    """x [B,S,d] as the dispatch's groups [G,T,d]. Under a device mesh
    each rank holds the whole of each of its groups: G cut over the batch
    axes where it divides them (G = B keeps the batch rows' cut), else
    every group on every rank (the global pool, gathered)."""
    b, s, d = x.shape
    lay = site_layout((g, t, d), "batch", None, None)
    if lay is None:
        return x.reshape(g, t, d)
    if g != b:
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x.reshape(g, t, d).redistribute(lay.device_mesh, lay.placements)


def _group_mean(v, xt):
    """The mean over all groups of ``v`` [rank's groups]: under a device
    mesh a sum over the batch axes that cut them, whole on every rank."""
    if device_mesh() is None:
        return torch.mean(v)
    axes = tuple(a for a, p in zip(xt.device_mesh.mesh_dim_names,
                                   xt.placements) if p.is_shard(0))
    return sum_over(v.sum(), xt.device_mesh, axes) / xt.shape[0]


def _dispatch_block(xt, idx, gate, w_gate, w_up, w_down, *, m, dt, c):
    """Sort-based dispatch + expert einsum + combine over [G, T, ...].

    ``xt`` [G,T,d] (a DTensor under a device mesh), ``idx`` and ``gate``
    the rank's groups' routing; the index ops run on the rank's groups."""
    xl = local(xt)
    g, t, d = xl.shape
    k = m.top_k
    e_num = m.n_experts
    dev = xl.device
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
    gathered = xl[gi, st].to(dt)                           # [G, T·k, d]
    buf = torch.zeros((g, e_num * c + 1, d), dtype=dt, device=dev)
    buf[gi, target] = gathered
    whole = (xt.shape[0], e_num, c, d)
    grouped = shard_act(from_local_like(buf[:, :-1].reshape(g, e_num, c, d),
                                        xt, {0: 0}, whole),
                        "batch", "act_experts", None, None)

    y_e = _experts(grouped, w_gate, w_up, w_down)

    # --- combine ------------------------------------------------------------
    # the experts gathered (EP), the products over a cut ffn summed (ETP)
    y_e = reduce_partial(gather_dim(y_e, 1))
    flat_y = shard_act(per_shard(lambda y: y.reshape(y.shape[0], -1, d), y_e,
                                 (whole[0], e_num * c, d)),
                       "batch", None, None)
    fl = local(flat_y)
    safe_target = torch.clamp_max(target, e_num * c - 1)
    per_assign = torch.where(keep[..., None], fl[gi, safe_target],
                             torch.zeros((), dtype=dt, device=dev))
    per_assign = local(shard_act(
        from_local_like(per_assign, xt, {0: 0}, (whole[0], t * k, d)),
        "batch", None, None))
    weighted = per_assign * sg[..., None].to(dt)           # sorted order
    # back to [T, k] order (``order`` is a permutation: no collisions)
    unsorted = torch.empty_like(weighted)
    unsorted[gi, order] = weighted
    unsorted = unsorted.reshape(g, t, k, d)
    out = torch.zeros((g, t, d), dtype=dt, device=dev)
    for j in range(k):                                     # fixed order
        out = out + unsorted[:, :, j]
    return shard_act(from_local_like(out, xt, {0: 0}, (whole[0], t, d)),
                     "batch", None, None)


def _experts(grouped, w_gate, w_up, w_down):
    """The batched expert FFN: grouped [G,E,C,d] → [G,E,C,d]. Under a
    device mesh each rank computes its groups' rows (the ``h`` site's
    layout): its experts (EP) or its cut of ``ffn`` (ETP), every operand
    cut so on local tensors, whose gradient is a partial sum over the axes
    it is whole on but the work is cut; the result a partial sum over a
    cut ``ffn``."""
    f = w_gate.shape[-1]
    work = site_layout(tuple(grouped.shape[:3]) + (f,),
                       "batch", "act_experts", None, "act_ffn")
    gl = local_cut_like(grouped, work, {0: 0, 1: 1})
    wg, wu = (local_cut_like(w, work, {1: 0, 3: 2}) for w in (w_gate, w_up))
    wd = local_cut_like(w_down, work, {1: 0, 3: 1})
    g_ = torch.einsum("gecd,edf->gecf", gl, wg)
    u_ = torch.einsum("gecd,edf->gecf", gl, wu)
    h = shard_act(from_local_like(F.silu(g_) * u_, work,
                                  {0: 0, 1: 1, 2: 2, 3: 3},
                                  tuple(grouped.shape[:3]) + (f,)),
                  "batch", "act_experts", None, "act_ffn")
    y = torch.einsum("gecf,efd->gecd", local(h), wd)
    if work is None:
        return y
    from torch.distributed.tensor import Partial
    return from_shard(y, work.device_mesh,
                      tuple(Partial() if p.is_shard(3) else p
                            for p in work.placements), tuple(grouped.shape))
