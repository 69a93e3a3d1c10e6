"""Physical operator DAG nodes (the layer between logical plans and kernels).

A ``PhysicalPlan`` is the hash-consed lowering of an optimized logical
``Expr`` tree: one node per *distinct* subplan, children listed before
parents (topological order by construction), every node annotated at plan
time with

* estimated cost / sparsity (``core.cost``, the logical estimators),
* the chosen execution strategy — e.g. Bloom-filtered vs. plain sort-merge
  for entry joins (cost-gated per paper §4.5/§4.7),
* the kernel backend the registry would dispatch to (``kernels.registry``),
* the partitioning-scheme pair from the communication cost model when the
  plan targets a multi-device mesh (``core.partitioner``).

The DAG is data: building it performs no FLOPs and touches no matrices, so
plans can be built, inspected (``repro_torch.plan.explain``) and tested without
executing anything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.cost import PartitionChoice
from repro_torch.core.expr import Expr, Shape

# Node kinds (one per physical operator, not per logical Expr class: the
# masked-elemwise SDDMM pattern exists only physically).
LEAF = "leaf"
TRANSPOSE = "transpose"
MATSCALAR = "matscalar"
ELEMWISE = "elemwise"
MASKED_ELEMWISE = "masked_elemwise"   # A ∘ (W×H) with sparse A (paper §6)
MASKED_AGG = "masked_agg"             # Σ(A ∘ (W×H)) fused: no m×n product
MATMUL = "matmul"
INVERSE = "inverse"
SELECT = "select"
AGG = "agg"
JOIN = "join"


@dataclasses.dataclass
class PhysicalNode:
    """One operator of the physical DAG.

    ``expr`` is the originating logical node and carries the operator
    payload (predicate, aggregation function, merge function, ...); the
    *wiring* is ``children`` — physical op ids, which may differ from the
    logical children (e.g. ``MASKED_ELEMWISE`` wires the matmul's factors
    directly). ``meta`` holds per-kind execution flags (e.g. ``flip`` for
    masked division).
    """

    op_id: int
    kind: str
    expr: Expr
    children: Tuple[int, ...]
    shape: Shape
    sparsity: float
    est_flops: float
    kernel: Optional[str] = None      # logical kernel name, if one is used
    backend: Optional[str] = None     # registry backend resolved at plan time
    strategy: Optional[str] = None    # join / operator strategy tag
    partition: Optional[PartitionChoice] = None
    jit_safe: bool = True
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # plan-wide SPMD annotations (repro.plan.schemes, multi-worker plans):
    scheme: Optional[str] = None          # output partitioning scheme
    in_schemes: Tuple[str, ...] = ()      # scheme each child is consumed in
    comm_est: float = 0.0                 # predicted entries moved here

    def label(self) -> str:
        if self.kind == MASKED_ELEMWISE:
            return f"MaskedElemWise[{self.expr._label()[9:-1]}]"
        if self.kind == MASKED_AGG:
            return f"MaskedAgg[{self.expr._label()[4:-1]}]"
        return self.expr._label()


@dataclasses.dataclass
class PhysicalPlan:
    """Hash-consed operator DAG in topological order (children first)."""

    nodes: Tuple[PhysicalNode, ...]
    root: int
    mode: str                          # "sparse" | "dense"
    block_size: int
    n_workers: int
    logical_nodes: int                 # node count of the source Expr tree
    total_comm_est: float = 0.0        # predicted entries moved, whole plan
    use_bloom: bool = True             # session Bloom preference (V2V gate)

    # staged-execution caches, populated lazily by the DAG executor
    # (one per path: plain jit, SPMD jit over the session mesh; the sparse
    # tier additionally keys on the leaf-mask fingerprint — see
    # ``repro_torch.plan.masks`` — so data changes restage)
    _staged_fn: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _staged_spmd_fn: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _staged_sparse_fn: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _staged_sparse_spmd_fn: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    # mask-propagation cache (repro.plan.masks.annotate)
    _mask_key: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _mask_infos: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    # scheme-propagation cache (repro.plan.schemes.annotate): the DP is a
    # pure function of the immutable node structure + worker count, so
    # one assignment per plan — cost-only dry-lowerings and EXPLAIN reuse
    # it instead of re-running the DP per call
    _scheme_assignment: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def shared_nodes(self) -> int:
        """Logical nodes eliminated by hash-consing (the CSE win)."""
        return self.logical_nodes - self.n_nodes

    @property
    def jit_safe(self) -> bool:
        return all(n.jit_safe for n in self.nodes)

    @property
    def est_flops(self) -> float:
        return sum(n.est_flops for n in self.nodes)

    def node(self, op_id: int) -> PhysicalNode:
        return self.nodes[op_id]

    def count(self, kind: str) -> int:
        return sum(1 for n in self.nodes if n.kind == kind)
