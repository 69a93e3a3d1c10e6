"""Plan-time block-mask / nnz propagation over the physical DAG (paper §4.7).

The builder's cost annotations come from the logical estimators (leaf
sparsity propagated under independence). Once the session environment is
known, this pass replaces those guesses with *certified* information
computed bottom-up from the actual leaf block masks, using the block-mask
algebra of ``repro_torch.core.matrix`` and the sparsity-inducing profiles of
``repro_torch.core.sparsity``:

* every order-2 node gets a propagated **block mask** — a conservative
  certificate (False ⇒ the block is all zeros, no false negatives) the
  staged executor uses to skip dead blocks in gathered vmaps and to gate
  masked matmuls with a *static* mask (traceable, unlike the data-derived
  runtime mask);
* every node gets a propagated **nnz upper bound**, which re-gates the
  plan-time cost decisions (Bloom-vs-sortmerge for entry joins, the SDDMM
  demotion) with per-node numbers instead of leaf-only sparsity products;
* every COO-producing join gets a **static buffer capacity** for the
  device tier (``repro_torch.core.joins_device``): exact when both inputs are
  catalog leaves (one O(nnz) host scan), a mask-derived bound otherwise.
  Joins whose bound exceeds ``device_cap_limit()`` are marked host-only
  and the whole plan falls back to the eager oracle.

Results are written into ``node.meta`` (``mask`` / ``nnz_bound`` /
``cap`` / ``device`` / ``demote_dense``) and keyed by a fingerprint of
the leaf block masks, so repeated ``collect()`` calls skip the pass and
re-binding a leaf to differently-shaped data re-annotates (and restages).
Value drift under an unchanged mask can invalidate an exact capacity —
the staged executor's runtime overflow guard catches that and forces a
re-annotation.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import cost as costmod
from repro_torch.core.executor import env_device
from repro_torch.core.expr import ElemWise, EWOp, Join, MatScalar, Select
from repro_torch.core.matrix import (
    BlockMatrix, compute_block_mask, mask_band_nnz_caps, mask_matmul,
    mask_nnz_cap, mask_ones, mask_overlay,
)
from repro_torch.core.predicates import Field, JoinKind
from repro_torch.core.sparsity import SparsityProfile, analyze_merge
from repro_torch.plan import ops as P

_CAP_ENV = "REPRO_SPARSE_CAP"


def device_cap_limit() -> int:
    """Largest COO expansion buffer the device tier will allocate."""
    return int(os.environ.get(_CAP_ENV, costmod.SPARSE_DEVICE_CAP))


@dataclasses.dataclass
class MaskInfo:
    """Propagated certificate for one node: a conservative block mask
    (order-2 nodes; None above rank 2) and an nnz upper bound."""

    mask: Optional[np.ndarray]
    nnz: float


# ---------------------------------------------------------------------------
# Leaf access.
# ---------------------------------------------------------------------------

class _Leaves:
    """Host views of the catalog leaves, fetched lazily and at most once.

    An instance may be shared across *many* plans over the same catalog —
    the memo optimizer costs every candidate rewrite of one query against
    a single ``Leaves`` (``core.cost.physical_cost``), so each array,
    block mask and join-capacity scan is fetched once per optimize()
    call, not once per candidate. The capacity memo is therefore keyed by
    the join's logical expression, which is stable across plans (physical
    op ids are not)."""

    def __init__(self, env: Dict[str, BlockMatrix], block_size: int):
        self.env = env
        self.bs = block_size
        self._arrays: Dict[str, np.ndarray] = {}
        self._masks: Dict[str, np.ndarray] = {}
        self.caps: Dict[object, Optional[int]] = {}  # per-join capacity memo

    def array(self, node: P.PhysicalNode) -> np.ndarray:
        name = node.expr.name
        hit = self._arrays.get(name)
        if hit is None:
            if name in self.env:
                hit = self.env[name].value.detach().cpu().numpy()
            elif name.startswith("ones("):
                hit = np.ones(node.shape, np.float32)
            else:
                raise KeyError(f"unbound matrix {name!r}")
            self._arrays[name] = hit
        return hit

    def mask(self, node: P.PhysicalNode) -> np.ndarray:
        name = node.expr.name
        hit = self._masks.get(name)
        if hit is not None:
            return hit
        if name in self.env:
            bm = self.env[name]
            if bm.block_size == self.bs:
                hit = bm.block_mask.cpu().numpy()
            else:
                hit = compute_block_mask(bm.value, self.bs).cpu().numpy()
        elif name.startswith("ones("):
            hit = mask_ones(node.shape, self.bs)
        else:
            raise KeyError(f"unbound matrix {name!r}")
        self._masks[name] = hit
        return hit


def fingerprint(plan: P.PhysicalPlan, env: Dict[str, BlockMatrix],
                leaves: Optional[_Leaves] = None) -> tuple:
    """Key of the leaf state this annotation was computed from: names,
    shapes and block-mask bytes (values may drift under the same mask —
    the runtime overflow guard covers that residual)."""
    leaves = leaves or _Leaves(env, plan.block_size)
    parts = []
    for node in plan.nodes:
        if node.kind == P.LEAF:
            m = np.packbits(leaves.mask(node))
            parts.append((node.expr.name, node.shape,
                          zlib.crc32(m.tobytes())))
    return (plan.block_size, tuple(parts))


# ---------------------------------------------------------------------------
# Bottom-up propagation.
# ---------------------------------------------------------------------------

def propagate(plan: P.PhysicalPlan, env: Dict[str, BlockMatrix],
              leaves: Optional[_Leaves] = None) -> Dict[int, MaskInfo]:
    leaves = leaves or _Leaves(env, plan.block_size)
    infos: Dict[int, MaskInfo] = {}
    for node in plan.nodes:
        infos[node.op_id] = _info(node, plan, infos, leaves)
    return infos


def _clip(info: MaskInfo, shape: Tuple[int, ...], bs: int) -> MaskInfo:
    """Tighten the nnz bound with whatever the mask certifies."""
    size = float(np.prod(shape)) if shape else 1.0
    nnz = min(info.nnz, size)
    if info.mask is not None:
        nnz = min(nnz, mask_nnz_cap(info.mask, shape, bs))
    return MaskInfo(info.mask, nnz)


def _info(node: P.PhysicalNode, plan: P.PhysicalPlan,
          infos: Dict[int, MaskInfo], leaves: _Leaves) -> MaskInfo:
    bs = plan.block_size
    k = node.kind
    ch = [infos[c] for c in node.children]

    if k == P.LEAF:
        mask = leaves.mask(node)
        nnz = float(np.count_nonzero(leaves.array(node)))
        return MaskInfo(mask, nnz)

    if k == P.TRANSPOSE:
        return MaskInfo(ch[0].mask.T.copy(), ch[0].nnz)

    if k == P.MATSCALAR:
        e: MatScalar = node.expr
        if e.op is EWOp.MUL:
            if e.beta == 0:
                return MaskInfo(np.zeros_like(ch[0].mask), 0.0)
            return MaskInfo(ch[0].mask, ch[0].nnz)
        if e.beta == 0:
            return MaskInfo(ch[0].mask, ch[0].nnz)
        return _clip(MaskInfo(mask_ones(node.shape, bs), np.inf),
                     node.shape, bs)

    if k == P.ELEMWISE:
        e: ElemWise = node.expr
        if e.op is EWOp.ADD:
            out = MaskInfo(ch[0].mask | ch[1].mask, ch[0].nnz + ch[1].nnz)
        else:  # MUL and DIV both require a nonzero entry on each side
            out = MaskInfo(ch[0].mask & ch[1].mask,
                           min(ch[0].nnz, ch[1].nnz))
        return _clip(out, node.shape, bs)

    if k == P.MASKED_ELEMWISE:
        sp, w, h = ch
        mm = mask_matmul(w.mask, h.mask)
        return _clip(MaskInfo(sp.mask & mm, sp.nnz), node.shape, bs)

    if k == P.MATMUL:
        return _clip(MaskInfo(mask_matmul(ch[0].mask, ch[1].mask), np.inf),
                     node.shape, bs)

    if k == P.INVERSE:
        return _clip(MaskInfo(mask_ones(node.shape, bs), np.inf),
                     node.shape, bs)

    if k == P.SELECT:
        e: Select = node.expr
        child = plan.node(node.children[0])
        if (node.shape == child.shape and e.pred.special is None
                and not e.pred.is_diagonal()):
            # value predicates only zero entries: the mask stays valid
            return MaskInfo(ch[0].mask, ch[0].nnz)
        return _clip(MaskInfo(mask_ones(node.shape, bs), ch[0].nnz),
                     node.shape, bs)

    if k in (P.AGG, P.MASKED_AGG):
        # aggregation outputs (vectors / scalars) certify nothing useful
        # at block granularity; the fused masked-agg's win is in the
        # *intermediate* it never materializes, not in its tiny output
        return _clip(MaskInfo(mask_ones(node.shape, bs), np.inf),
                     node.shape, bs)

    if k == P.JOIN:
        return _join_info(node, plan, ch, leaves)

    raise TypeError(f"no mask rule for node kind {k!r}")


def _join_info(node: P.PhysicalNode, plan: P.PhysicalPlan,
               ch: list, leaves: _Leaves) -> MaskInfo:
    e: Join = node.expr
    bs = plan.block_size
    prof = analyze_merge(e.merge)
    kind = e.pred.kind
    if kind in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        ma, mb = ch[0].mask, ch[1].mask
        if kind is JoinKind.TRANSPOSE_OVERLAY:
            mb = mb.T
        if ma.shape != mb.shape:  # ragged overlay: certify nothing
            return _clip(MaskInfo(mask_ones(node.shape, bs), np.inf),
                         node.shape, bs)
        mask = mask_overlay(prof.inducing_x, prof.inducing_y, ma, mb)
        if prof.inducing_x and prof.inducing_y:
            nnz = min(ch[0].nnz, ch[1].nnz)
        elif prof.inducing_x:
            nnz = ch[0].nnz
        elif prof.inducing_y:
            nnz = ch[1].nnz
        else:
            nnz = np.inf
        return _clip(MaskInfo(mask, nnz), node.shape, bs)
    # order-3/4 COO output: the bound is the expansion-slot count the
    # device tier would need (post-merge filtering only shrinks it)
    cap = _join_capacity(node, plan, ch, leaves, prof)
    return MaskInfo(None, float(cap) if cap is not None
                    else float(np.prod(node.shape)))


# ---------------------------------------------------------------------------
# COO capacities (static buffer sizes for the device tier).
# ---------------------------------------------------------------------------

def _bound_capacity(node: P.PhysicalNode, plan: P.PhysicalPlan,
                    ch: list, prof: SparsityProfile) -> float:
    """Mask-derived upper bound when the inputs are not catalog leaves."""
    e: Join = node.expr
    kind = e.pred.kind
    bs = plan.block_size
    na_node = plan.node(node.children[0])
    nb_node = plan.node(node.children[1])
    size_a, size_b = float(np.prod(na_node.shape)), float(np.prod(nb_node.shape))
    if kind is JoinKind.CROSS:
        na = ch[0].nnz if prof.inducing_x else size_a
        nb = ch[1].nnz if prof.inducing_y else size_b
        return na * nb
    if kind is JoinKind.V2V:
        skip = prof.inducing_x or prof.inducing_y
        na = ch[0].nnz if skip else size_a
        nb = ch[1].nnz if skip else size_b
        return na * nb
    if kind is JoinKind.D2D:
        ma = ch[0].mask if e.pred.left is Field.RID else ch[0].mask.T
        mb = ch[1].mask if e.pred.right is Field.RID else ch[1].mask.T
        # a non-inducing side joins its ZERO cells too — the block mask
        # only bounds nonzeros, so that side must count full bands
        if not prof.inducing_x:
            ma = np.ones_like(ma)
        if not prof.inducing_y:
            mb = np.ones_like(mb)
        sa = na_node.shape if e.pred.left is Field.RID \
            else na_node.shape[::-1]
        sb = nb_node.shape if e.pred.right is Field.RID \
            else nb_node.shape[::-1]
        ba = mask_band_nnz_caps(ma, sa, bs).astype(np.float64)
        bb = mask_band_nnz_caps(mb, sb, bs).astype(np.float64)
        d = min(ba.shape[0], bb.shape[0])
        return float((ba[:d] * bb[:d]).sum())
    if kind is JoinKind.D2V:
        d2 = na_node.shape[1] if e.pred.left is Field.RID \
            else na_node.shape[0]
        return ch[1].nnz * d2
    if kind is JoinKind.V2D:
        d2 = nb_node.shape[1] if e.pred.right is Field.RID \
            else nb_node.shape[0]
        return ch[0].nnz * d2
    raise ValueError(kind)


def _join_capacity(node: P.PhysicalNode, plan: P.PhysicalPlan, ch: list,
                   leaves: _Leaves,
                   prof: SparsityProfile) -> Optional[int]:
    """Static buffer capacity for a COO join, or None (host-only)."""
    if node.expr in leaves.caps:
        return leaves.caps[node.expr]
    limit = device_cap_limit()
    a_node = plan.node(node.children[0])
    b_node = plan.node(node.children[1])
    if a_node.kind == P.LEAF and b_node.kind == P.LEAF:
        from repro_torch.core.joins_device import exact_capacity
        cap = exact_capacity(leaves.array(a_node), leaves.array(b_node),
                             node.expr.pred, prof)
    else:
        bound = _bound_capacity(node, plan, ch, prof)
        if not np.isfinite(bound):
            return None
        cap = int(bound)
    from repro_torch.core.joins_device import round_capacity
    # rounding avoids zero-size buffers and hair-trigger retraces
    out = None if cap > limit else round_capacity(cap)
    leaves.caps[node.expr] = out
    return out


# ---------------------------------------------------------------------------
# Annotation: write the results onto the plan + re-gate cost decisions.
# ---------------------------------------------------------------------------

def annotate(plan: P.PhysicalPlan, env: Dict[str, BlockMatrix],
             leaves: Optional[_Leaves] = None) -> Dict[int, MaskInfo]:
    """Propagate masks/nnz and refresh the plan's cost gates in place.

    Idempotent per leaf-mask fingerprint; called by the staged sparse
    executor, by ``explain(physical=True)`` on sparse-tier sessions, and
    by the optimizer's cost-only dry-lowerings (which pass a shared
    ``leaves`` so candidate plans reuse one set of host views).
    """
    from repro_torch.obs.trace import span
    leaves = leaves or _Leaves(env, plan.block_size)
    key = fingerprint(plan, env, leaves)
    if plan._mask_key == key and plan._mask_infos is not None:
        return plan._mask_infos
    with span("mask_propagation", nodes=plan.n_nodes):
        infos = propagate(plan, env, leaves)
    for node in plan.nodes:
        info = infos[node.op_id]
        node.meta["mask"] = info.mask
        node.meta["nnz_bound"] = info.nnz
        if node.kind == P.JOIN:
            _annotate_join(node, plan, infos, leaves)
        elif node.kind in (P.MASKED_ELEMWISE, P.MASKED_AGG):
            sp = infos[node.children[0]]
            from repro_torch.plan.builder import MASKED_PATTERN_MAX_SPARSITY
            node.meta["demote_dense"] = \
                float(sp.mask.mean()) > MASKED_PATTERN_MAX_SPARSITY
    plan._mask_key = key
    plan._mask_infos = infos
    return infos


def _annotate_join(node: P.PhysicalNode, plan: P.PhysicalPlan,
                   infos: Dict[int, MaskInfo], leaves: _Leaves) -> None:
    e: Join = node.expr
    kind = e.pred.kind
    prof = analyze_merge(e.merge)
    if kind in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        node.meta["device"] = True
        return
    ch = [infos[c] for c in node.children]
    cap = _join_capacity(node, plan, ch, leaves, prof)
    node.meta["cap"] = cap
    node.meta["device"] = cap is not None
    if cap is not None:
        node.meta["cap_sides"] = _side_caps(node, plan, ch, leaves, prof)
    if kind is JoinKind.V2V and plan.mode == "sparse":
        # re-gate Bloom-vs-sortmerge with the propagated entry counts
        # instead of the builder's leaf-sparsity product
        skip = prof.inducing_x or prof.inducing_y
        na = ch[0].nnz if skip else float(np.prod(
            plan.node(node.children[0]).shape))
        nb = ch[1].nnz if skip else float(np.prod(
            plan.node(node.children[1]).shape))
        choice = costmod.choose_v2v_strategy(na, nb,
                                             use_bloom=plan.use_bloom)
        node.strategy = choice.strategy
        if choice.strategy == costmod.BLOOM_SORTMERGE:
            node.kernel = "bloom_probe"
            if node.backend is None:
                from repro_torch.kernels import registry
                node.backend = registry.planned_backend(
                    "bloom_probe", device=env_device(leaves.env))
        else:
            # plain sortmerge still runs the fused segment-expand kernel
            # on the device tier; keep the backend threaded so dispatch
            # and EXPLAIN agree
            node.kernel = "coo_expand"
            if node.backend is None:
                from repro_torch.kernels import registry
                node.backend = registry.planned_backend(
                    "coo_expand", device=env_device(leaves.env))


def _side_caps(node: P.PhysicalNode, plan: P.PhysicalPlan, ch: list,
               leaves: _Leaves, prof: SparsityProfile) -> Tuple[int, int]:
    """Static entry-buffer sizes for the compacted join sides — exact nnz
    for catalog leaves, the propagated bound otherwise. V2V skips zeros
    on both sides iff the merge induces on either; the other families
    compact each side by its own inducing flag."""
    e: Join = node.expr
    if e.pred.kind is JoinKind.V2V:
        skip = prof.inducing_x or prof.inducing_y
        skips = (skip, skip)
    else:
        skips = (prof.inducing_x, prof.inducing_y)

    def one(child_id: int, info: MaskInfo, skip: bool) -> int:
        from repro_torch.core.joins_device import round_capacity
        cnode = plan.node(child_id)
        size = int(np.prod(cnode.shape))
        if not skip:
            c = size
        elif cnode.kind == P.LEAF:
            c = int(np.count_nonzero(leaves.array(cnode)))
        else:
            c = min(size, int(np.ceil(info.nnz)))
        return round_capacity(c)

    return (one(node.children[0], ch[0], skips[0]),
            one(node.children[1], ch[1], skips[1]))


# Public name for the shared-leaf-view cache (see _Leaves docstring).
Leaves = _Leaves


def stageable(plan: P.PhysicalPlan) -> bool:
    """All COO joins fit their device capacities (post-``annotate``)."""
    return all(n.meta.get("device", True) for n in plan.nodes
               if n.kind == P.JOIN)
