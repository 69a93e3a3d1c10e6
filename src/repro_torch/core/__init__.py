"""MatRel core: relational query processing over big matrix data.

Logical plan IR + transformation rules (§3), join operators and their
optimizations (§4), the communication cost model (§4.7) and the
block-matrix execution layer (§5), over torch tensors.
"""
from repro_torch.core.api import Matrix, Session, catalog_from_numpy
from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Inverse, Join, Leaf, MatMul,
    MatScalar, MergeFn, Select, Transpose,
)
from repro_torch.core.cost import PhysicalCost, physical_cost
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.optimizer import optimize, optimize_greedy, optimize_memo
from repro_torch.core.predicates import (
    Atom, CmpOp, Conjunction, Field, JoinKind, JoinPred, parse_join,
    parse_select,
)

__all__ = [
    "Matrix", "Session", "catalog_from_numpy", "BlockMatrix",
    "optimize", "optimize_greedy", "optimize_memo", "PhysicalCost",
    "physical_cost", "Agg", "AggDim", "AggFn", "ElemWise", "EWOp", "Expr",
    "Inverse", "Join", "Leaf", "MatMul", "MatScalar", "MergeFn", "Select",
    "Transpose", "Atom", "CmpOp", "Conjunction", "Field", "JoinKind",
    "JoinPred", "parse_join", "parse_select",
]
