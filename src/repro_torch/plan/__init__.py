"""Physical query planner: CSE'd operator DAG + plan-time strategy selection.

The layer between the logical optimizer (``repro_torch.core.optimizer``)
and the kernels (``repro_torch.kernels``):

    api → optimizer → **plan** (builder → PhysicalPlan → DAG executor) → kernels

``build_plan`` hash-conses the logical tree into a DAG (one node per
distinct subplan → shared subexpressions computed once), annotating every
node with estimated cost/sparsity, the chosen join strategy and the kernel
backend of the session's device. ``PlanExecutor`` evaluates the DAG
topologically with memoization; ``render`` is the physical EXPLAIN.
"""
from repro_torch.plan.builder import build_plan
from repro_torch.plan.executor import PlanExecutor
from repro_torch.plan.explain import render
from repro_torch.plan.ops import PhysicalNode, PhysicalPlan
from repro_torch.plan.schemes import SchemeAssignment, propagate, transpose_scheme

__all__ = [
    "build_plan", "PlanExecutor", "PhysicalNode",
    "PhysicalPlan", "render", "SchemeAssignment", "propagate",
    "transpose_scheme",
]
