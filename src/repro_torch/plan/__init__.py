"""Physical query planner: CSE'd operator DAG + plan-time strategy selection.

The layer between the logical optimizer (``repro_torch.core.optimizer``)
and the kernels (``repro_torch.kernels``):

    api → optimizer → **plan** (builder → PhysicalPlan → DAG executor) → kernels

``build_plan`` hash-conses the logical tree into a DAG (one node per
distinct subplan → shared subexpressions computed once), annotating every
node with estimated cost/sparsity, the chosen join strategy, the kernel
backend of the session's device, and — on a multi-worker plan — the
partition schemes from the communication cost model. ``PlanExecutor``
evaluates the DAG topologically with memoization (on the workers of a
mesh for multi-worker plans); ``render`` is the physical EXPLAIN.
"""
from repro_torch.plan.builder import (
    SharedBuildState, SharedLowering, build_plan, lower_shared,
)
from repro_torch.plan.executor import (
    PlanExecutor, execute_plan, staged_collective_bytes,
)
from repro_torch.plan.explain import render
from repro_torch.plan.ops import PhysicalNode, PhysicalPlan
from repro_torch.plan.schemes import SchemeAssignment, propagate, transpose_scheme

__all__ = [
    "build_plan", "execute_plan", "lower_shared", "PlanExecutor",
    "PhysicalNode", "PhysicalPlan", "render", "SharedBuildState",
    "SharedLowering", "staged_collective_bytes",
    "SchemeAssignment", "propagate", "transpose_scheme",
]
