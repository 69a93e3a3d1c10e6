"""Lower a logical ``Expr`` tree into a hash-consed physical operator DAG.

Hash-consing is the CSE mechanism: each distinct subplan gets exactly one
``PhysicalNode`` (keyed on operator kind + parameters + *physical* child
ids), so a subexpression like ``XᵀX`` used twice in one query appears once
in the DAG and is computed once by the DAG executor.

All strategy decisions the tree-walk executor used to make per visit are
made here, once, at plan time:

* the SDDMM pattern ``sparse ∘ (W×H)`` is detected structurally and lowered
  to a ``MASKED_ELEMWISE`` node wired straight to the matmul's factors;
* entry joins (V2V) are cost-gated between Bloom-filtered and plain
  sort-merge (``core.cost.choose_v2v_strategy``);
* kernel-dispatching nodes are annotated with the registry backend
  (``kernels.registry.planned_backend``);
* on a multi-worker plan, joins get the partitioning-scheme pair from the
  paper's communication cost model (``core.partitioner.plan_join_static``)
  and every node a propagated partition scheme (``plan.schemes``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import cost as costmod
from repro_torch.core import partitioner as partmod
from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Inverse, Join, Leaf, MatMul,
    MatScalar, Select, Transpose, count_nodes,
)
from repro_torch.core.predicates import JoinKind
from repro_torch.device import card_count
from repro_torch.plan import ops as P

# The SDDMM rewrite only pays when the gating side is block-sparse enough;
# same threshold the tree-walk executor applied per visit.
MASKED_PATTERN_MAX_SPARSITY = 0.5


def _strategy_for_join(e: Join, mode: str, use_bloom: bool) -> str:
    k = e.pred.kind
    if mode == "dense":
        return "dense"
    if k is JoinKind.CROSS:
        return "coo-cross"
    if k in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        return "block-skip-overlay"
    if k is JoinKind.D2D:
        return "coo-group-join"
    if k is JoinKind.V2V:
        return costmod.choose_v2v_strategy(
            e.a.nnz_est, e.b.nnz_est, use_bloom=use_bloom).strategy
    return "coo-route"  # D2V / V2D


def _select_jit_safe(e: Select) -> bool:
    # special predicates drop rows/cols data-dependently (dynamic shapes)
    # and value atoms evaluate through numpy ufuncs; neither traces.
    return e.pred.special is None and not e.pred.val_atoms()


class _Builder:
    def __init__(self, mode: str, block_size: int, use_bloom: bool,
                 kernel_backend: Optional[str], n_workers: int,
                 cost_only: bool = False,
                 shared: Optional["SharedBuildState"] = None,
                 device="cpu"):
        self.mode = mode
        self.block_size = block_size
        self.use_bloom = use_bloom
        self.kernel_backend = kernel_backend
        self.n_workers = n_workers
        self.cost_only = cost_only
        # kernel nodes run on the backend of the session's device
        self.device = torch.device(device)
        # with a shared arena, lowering appends to the cross-query node
        # list and consults the cross-query memo: a subplan another query
        # already lowered hash-conses to the *same* shared node id
        self.nodes: List[P.PhysicalNode] = \
            shared.nodes if shared is not None else []
        self.memo: Dict[tuple, int] = \
            shared.memo if shared is not None else {}

    # -- hash-consing core ----------------------------------------------------
    def emit(self, kind: str, expr: Expr, children: Tuple[int, ...],
             params: tuple, est_flops: float, **ann) -> int:
        key = (kind, children, params)
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        if any(len(self.nodes[c].shape) > 2 for c in children):
            # an operator over an order-3/4 join output: the executors
            # reject this at runtime (tensors must be aggregated first), so
            # it must not be staged into jit where it would silently
            # compute over the dense tensor instead of raising
            ann["jit_safe"] = False
        op_id = len(self.nodes)
        self.nodes.append(P.PhysicalNode(
            op_id=op_id, kind=kind, expr=expr, children=children,
            shape=expr.shape, sparsity=expr.sparsity,
            est_flops=est_flops, **ann))
        self.memo[key] = op_id
        return op_id

    # -- lowering -------------------------------------------------------------
    def lower(self, e: Expr) -> int:
        if isinstance(e, Leaf):
            return self.emit(P.LEAF, e, (), (e.name, e.shape, e.sparsity),
                             0.0)
        if isinstance(e, Transpose):
            return self.emit(P.TRANSPOSE, e, (self.lower(e.x),), (),
                             costmod.node_flops(e))
        if isinstance(e, MatScalar):
            return self.emit(P.MATSCALAR, e, (self.lower(e.x),),
                             (e.op, e.beta), costmod.node_flops(e))
        if isinstance(e, ElemWise):
            return self._lower_elemwise(e)
        if isinstance(e, MatMul):
            return self.emit(P.MATMUL, e,
                             (self.lower(e.a), self.lower(e.b)), (),
                             costmod.node_flops(e))
        if isinstance(e, Inverse):
            return self.emit(P.INVERSE, e, (self.lower(e.x),), (),
                             costmod.node_flops(e))
        if isinstance(e, Select):
            return self.emit(P.SELECT, e, (self.lower(e.x),), (e.pred,),
                             costmod.node_flops(e),
                             jit_safe=_select_jit_safe(e))
        if isinstance(e, Agg):
            fused = self._lower_masked_agg(e)
            if fused is not None:
                return fused
            return self.emit(P.AGG, e, (self.lower(e.x),), (e.fn, e.dim),
                             costmod.node_flops(e))
        if isinstance(e, Join):
            return self._lower_join(e)
        raise TypeError(type(e))

    def _lower_elemwise(self, e: ElemWise) -> int:
        if self.mode == "sparse" and e.op in (EWOp.MUL, EWOp.DIV):
            # the tree-walk executor re-detected this pattern on every
            # visit; the planner decides once, structurally
            for sparse_side, mm_side, flip in ((e.a, e.b, False),
                                               (e.b, e.a, True)):
                if (isinstance(mm_side, MatMul)
                        and sparse_side.sparsity
                        < MASKED_PATTERN_MAX_SPARSITY):
                    sp = self.lower(sparse_side)
                    w = self.lower(mm_side.a)
                    h = self.lower(mm_side.b)
                    # cost: the matmul gated down to live blocks + the merge
                    flops = (costmod.node_flops(mm_side)
                             * max(sparse_side.sparsity, 1e-3)
                             + float(e.size))
                    # jit-safe: the staged sparse path gates the matmul
                    # with the plan-time propagated mask (a static array,
                    # unlike the runtime block mask) — see repro.plan.masks
                    return self.emit(
                        P.MASKED_ELEMWISE, e, (sp, w, h), (e.op, flip),
                        flops, kernel="masked_matmul",
                        backend=self._backend("masked_matmul"),
                        strategy="sddmm", meta={"flip": flip})
        return self.emit(P.ELEMWISE, e,
                         (self.lower(e.a), self.lower(e.b)), (e.op,),
                         costmod.node_flops(e))

    def _lower_masked_agg(self, e: Agg) -> Optional[int]:
        """Σ(sparse ∘ (W×H)) → one fused SDDMM+aggregation node.

        The structural check runs BEFORE the child is lowered: lowering
        the ElemWise first would leave an orphan MASKED_ELEMWISE node in
        the DAG that the eager walk (which evaluates every node) would
        execute — materializing exactly the m×n product the fusion
        exists to avoid. Only SUM over ROW/COL/ALL factorizes
        (``kernels.sddmm_agg``); everything else takes the generic
        AGG-over-MASKED_ELEMWISE pair.
        """
        if (self.mode != "sparse" or e.fn is not AggFn.SUM
                or e.dim not in (AggDim.ROW, AggDim.COL, AggDim.ALL)):
            return None
        x = e.x
        if not (isinstance(x, ElemWise) and x.op is EWOp.MUL):
            return None
        for sparse_side, mm_side in ((x.a, x.b), (x.b, x.a)):
            if (isinstance(mm_side, MatMul)
                    and sparse_side.sparsity
                    < MASKED_PATTERN_MAX_SPARSITY):
                sp = self.lower(sparse_side)
                w = self.lower(mm_side.a)
                h = self.lower(mm_side.b)
                # cost: the gated contraction + one pass over the live
                # entries for the reduction — the m×n intermediate of the
                # unfused pair never exists, in flops or bytes
                flops = (costmod.node_flops(mm_side)
                         * max(sparse_side.sparsity, 1e-3)
                         + float(x.size))
                return self.emit(
                    P.MASKED_AGG, e, (sp, w, h), (e.fn, e.dim), flops,
                    kernel="sddmm_agg",
                    backend=self._backend("sddmm_agg"),
                    strategy="sddmm-agg")
        return None

    def _lower_join(self, e: Join) -> int:
        strategy = _strategy_for_join(e, self.mode, self.use_bloom)
        kernel = backend = None
        if strategy == "block-skip-overlay":
            kernel = "merge_join"
        elif strategy == costmod.BLOOM_SORTMERGE:
            kernel = "bloom_probe"
        elif strategy in ("coo-group-join", costmod.SORTMERGE):
            # the device COO tier's expansion loop dispatches the fused
            # segment-expand kernel; annotate it so EXPLAIN shows the
            # planned backend and the staged path threads it through
            kernel = "coo_expand"
        if kernel is not None:
            backend = self._backend(kernel)
        partition = None
        if self.n_workers > 1 and not self.cost_only:
            partition = partmod.plan_join_static(
                e.pred, costmod.size_of(e.a), costmod.size_of(e.b),
                self.n_workers).choice
        # every join family now has a jittable implementation: the dense
        # reference on the dense tier, and the device-resident COO /
        # block-skip machinery (core.joins_device, staged with plan-time
        # capacities and masks) on the sparse tier. The mask pass can
        # still veto staging per plan when a COO capacity bound exceeds
        # the device limit (the guarded host fallback).
        return self.emit(
            P.JOIN, e, (self.lower(e.a), self.lower(e.b)),
            (e.pred, e.merge), costmod.node_flops(e),
            kernel=kernel, backend=backend, strategy=strategy,
            partition=partition)

    def _backend(self, kernel: str) -> Optional[str]:
        if self.cost_only:
            return None
        from repro_torch.kernels import registry
        return registry.planned_backend(kernel, self.kernel_backend,
                                        device=self.device)


def build_plan(e: Expr, *, mode: str = "sparse", block_size: int = 256,
               use_bloom: bool = True,
               kernel_backend: Optional[str] = None,
               n_workers: Optional[int] = None,
               cost_only: bool = False,
               device="cpu") -> P.PhysicalPlan:
    """Lower (already-optimized) logical plan ``e`` into a physical DAG.

    ``cost_only=True`` is the optimizer's dry-lowering mode: the DAG is
    built purely to be costed (``core.cost.physical_cost``), so kernel
    backend resolution and the per-join static partition annotation are
    skipped — strategy selection, hash-consing and the scheme DP (the
    inputs of the cost) still run, and nothing is ever staged.
    ``device`` is the session's device: it decides the kernel backend
    each kernel node is annotated with, and ``n_workers`` (None: every
    device it sees, ``device.card_count``).
    """
    from repro_torch.obs.trace import span
    assert mode in ("sparse", "dense")
    if n_workers is None:
        # the JAX package's default: every device the session sees
        n_workers = card_count(device)
    b = _Builder(mode, block_size, use_bloom, kernel_backend, n_workers,
                 cost_only=cost_only, device=device)
    with span("lower", mode=mode, cost_only=cost_only):
        root = b.lower(e)
    plan = P.PhysicalPlan(
        nodes=tuple(b.nodes), root=root, mode=mode, block_size=block_size,
        n_workers=n_workers, logical_nodes=count_nodes(e),
        use_bloom=use_bloom)
    if n_workers > 1:
        # plan-wide scheme propagation: every node gets an output scheme
        # chosen knowing its consumers, so op boundaries compose without
        # resharding wherever the cost model says they can
        from repro_torch.plan import schemes as schemesmod
        schemesmod.annotate(plan)
    return plan


# ---------------------------------------------------------------------------
# Cross-query hash-consing (the serving tier's shared DAG).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SharedBuildState:
    """One hash-consing arena shared by *many* queries over one catalog
    version (``repro_torch.serve.engine``).

    Intra-query, the builder memo dedupes subplans of a single ``Expr``;
    giving successive ``lower_shared`` calls the same arena extends that
    to inter-query CSE: a subplan any earlier query lowered (same
    operator, same params, same child *shared ids*) resolves to the same
    shared node id, which the serving tier uses as the key for shared
    materialized results. The arena is only coherent for one catalog
    version × one set of session settings (``device`` among them: it
    decides each kernel node's backend) — the engine keys arenas
    accordingly and retires them on rebind.
    """

    mode: str
    block_size: int
    use_bloom: bool
    n_workers: int
    device: torch.device
    nodes: List[P.PhysicalNode] = dataclasses.field(default_factory=list)
    memo: Dict[tuple, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SharedLowering:
    """Result of lowering one query into a shared arena: the extracted
    per-query ``PhysicalPlan`` (renumbered, self-contained — annotation
    and execution passes index nodes positionally), the root's shared id,
    and the inter-query CSE accounting."""

    plan: P.PhysicalPlan
    root_shared_id: int
    reused_nodes: int      # distinct pre-existing shared nodes this query hit
    new_nodes: int         # shared nodes this query added to the arena


def lower_shared(shared: SharedBuildState, e: Expr,
                 kernel_backend: Optional[str] = None) -> SharedLowering:
    """Lower (already-optimized) ``e`` into the shared arena.

    Not thread-safe — the serving engine serializes arena access.
    """
    from repro_torch.obs.trace import span
    base = len(shared.nodes)
    b = _Builder(shared.mode, shared.block_size, shared.use_bloom,
                 kernel_backend, shared.n_workers, shared=shared,
                 device=shared.device)
    with span("lower", mode=shared.mode, shared=True):
        root = b.lower(e)
    # reachable shared ids, ascending = children-first (emit ids increase)
    keep: set = set()
    stack = [root]
    while stack:
        i = stack.pop()
        if i in keep:
            continue
        keep.add(i)
        stack.extend(shared.nodes[i].children)
    order = sorted(keep)
    renum = {old: new for new, old in enumerate(order)}
    nodes = tuple(
        dataclasses.replace(
            shared.nodes[old], op_id=renum[old],
            children=tuple(renum[c] for c in shared.nodes[old].children),
            # fresh meta per extracted plan: annotation passes mutate it,
            # and concurrent queries must not share mutable state. The
            # shared id rides along as the engine's cross-query result key.
            meta=dict(shared.nodes[old].meta, shared_id=old))
        for old in order)
    plan = P.PhysicalPlan(
        nodes=nodes, root=renum[root], mode=shared.mode,
        block_size=shared.block_size, n_workers=shared.n_workers,
        logical_nodes=count_nodes(e), use_bloom=shared.use_bloom)
    if shared.n_workers > 1:
        from repro_torch.plan import schemes as schemesmod
        schemesmod.annotate(plan)
    return SharedLowering(
        plan=plan, root_shared_id=root,
        reused_nodes=sum(1 for i in keep if i < base),
        new_nodes=len(shared.nodes) - base)
