"""Partition schemes, the worker mesh and §4.7 per-join planning.

The JAX package's module of this name maps the paper's schemes onto
GSPMD shardings. The port has no GSPMD: a mesh here is N workers, each
on a device of its own where the session sees cards enough (worker i on
card i, as the reference's mesh takes ``jax.devices()[:n]``) and in
contiguous groups on a card beyond that (``repro_torch.device.
worker_devices``); on the CPU every worker is the CPU. A scheme is
realized on the workers' own shards by ``repro_torch.core.spmd`` (Row
splits dim 0, Column dim 1, Broadcast replicates, ξ is Row, order-3/4
outputs split their leading dimension), each shard on its worker's
device. This module keeps the reference's surface over that layer: the
mesh (``worker_mesh``), the scheme → placement mapping with the
transpose rule and the rank rules (``scheme_spec``), the §4.7
assignment the planner annotates joins with (``plan_join_static``), the
legacy per-call distributed joins, and the measurement of collective
bytes — counted as the shards move instead of parsed from HLO.

Unlike the reference, ``worker_mesh`` does not refuse more workers than
devices: the workers beyond the card count are logical workers sharing
a card, so any N ≥ 1 is realizable. A card the machine does not have
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import cost as costmod
from repro_torch.core import spmd
from repro_torch.core.expr import MergeFn
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.predicates import Field, JoinKind, JoinPred
from repro_torch.device import worker_devices

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """Workers along one axis: ``devices[i]`` is worker i's device."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (WORKER_AXIS,)

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Worker 0's device."""
        return self.devices[0]


def worker_mesh(n: int, device) -> WorkerMesh:
    """A 1-D mesh of ``n`` workers for a session on ``device`` (both
    explicit), mapped onto its cards by ``worker_devices``."""
    if n is None or int(n) < 1:
        raise ValueError(f"a worker mesh needs n >= 1 workers, got {n!r}")
    return WorkerMesh(worker_devices(int(n), device))


def mesh_workers(mesh: WorkerMesh) -> int:
    """Worker count of a mesh — the single place this is derived."""
    return mesh.n


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a value of rank ``ndim`` lives on the mesh: split along
    ``dim`` over the workers axis, or replicated (``dim`` None). ``spec``
    spells it as a ``PartitionSpec`` would (one entry a dimension)."""

    dim: Optional[int]
    ndim: int = 2
    axis: str = WORKER_AXIS

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        return tuple(self.axis if d == self.dim else None
                     for d in range(self.ndim))


def scheme_spec(scheme: str, ndim: int = 2,
                axis: str = WORKER_AXIS) -> Placement:
    """Map a paper partitioning scheme onto a placement.

    Row → split dim 0; Column → split dim 1; Broadcast → replicated; ξ
    (random) → Row. Order-3/4 join outputs split the leading dimension
    (the §5.1 D1-first layout), so Row generalizes to dim 0 at any rank
    and Column only exists for matrices.
    """
    return Placement(spmd.scheme_dim(scheme, ndim), ndim, axis)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A placement on a particular mesh (the ``NamedSharding`` analogue)."""

    mesh: WorkerMesh
    placement: Placement


def sharding_for(mesh: WorkerMesh, scheme: str,
                 ndim: int = 2) -> MeshSharding:
    return MeshSharding(mesh, scheme_spec(scheme, ndim, mesh.axis_names[0]))


@dataclasses.dataclass
class DistributedJoinPlan:
    choice: costmod.PartitionChoice
    spec_a: Placement
    spec_b: Placement
    n_workers: int

    def describe(self) -> str:
        c = self.choice
        return (f"schemes=({c.scheme_a},{c.scheme_b}) "
                f"comm={c.comm_cost:.3g} conv={c.conversion_cost:.3g} "
                f"entries over N={self.n_workers}")


def plan_join_static(pred: JoinPred, size_a: float, size_b: float,
                     n_workers: int, s_a: str = costmod.RANDOM,
                     s_b: str = costmod.RANDOM, eta_a: float = 0.1,
                     eta_b: float = 0.1) -> DistributedJoinPlan:
    """Assign partition schemes from *size estimates* alone.

    The plan-time entry point used by ``repro_torch.plan.builder``: only
    the |A|/|B| estimates (nnz for sparse, m·n for dense) and the current
    schemes, so joins are annotated with their scheme pair before
    anything is materialized.
    """
    choice = costmod.assign_schemes(
        pred, size_a, size_b, n_workers, s_a=s_a, s_b=s_b,
        eta_a=eta_a, eta_b=eta_b)
    return DistributedJoinPlan(
        choice,
        scheme_spec(choice.scheme_a),
        scheme_spec(choice.scheme_b),
        n_workers,
    )


def plan_join(pred: JoinPred, a: BlockMatrix, b: BlockMatrix,
              n_workers: int, eta_a: float = 0.1,
              eta_b: float = 0.1) -> DistributedJoinPlan:
    return plan_join_static(pred, float(a.nnz()), float(b.nnz()),
                            n_workers, s_a=a.scheme, s_b=b.scheme,
                            eta_a=eta_a, eta_b=eta_b)


def distributed_overlay(mesh: WorkerMesh, a: BlockMatrix, b: BlockMatrix,
                        merge: MergeFn, transpose: bool = False,
                        plan: Optional[DistributedJoinPlan] = None,
                        ) -> Tuple[torch.Tensor, DistributedJoinPlan]:
    """Per-call distributed two-dimension join (§4.3).

    A and B are placed in the chosen schemes, B is moved to A's layout
    (the counted collective the cost model predicts) and each worker
    merges its slice. One call per join — the whole-plan SPMD path
    (``repro_torch.plan.executor``) supersedes this for multi-op queries.
    """
    from repro_torch.plan.schemes import transpose_scheme
    pred = JoinPred(JoinKind.TRANSPOSE_OVERLAY if transpose
                    else JoinKind.DIRECT_OVERLAY)
    plan = plan or plan_join(pred, a, b, mesh_workers(mesh))
    bv = b.value.T if transpose else b.value
    # the §4.7 scheme was chosen for B; Bᵀ takes its transpose-rule image
    scheme_b = transpose_scheme(plan.choice.scheme_b) if transpose \
        else plan.choice.scheme_b
    av = spmd.place(a.value, plan.choice.scheme_a, mesh.devices)
    bvv = spmd.place(bv, scheme_b, mesh.devices)
    out = spmd.elementwise(merge.fn, av, bvv)
    return spmd.assemble(out, a.value.device), plan


def distributed_d2d(mesh: WorkerMesh, a: BlockMatrix, b: BlockMatrix,
                    left: Field, right: Field, merge: MergeFn,
                    plan: Optional[DistributedJoinPlan] = None,
                    ) -> Tuple[torch.Tensor, DistributedJoinPlan]:
    """Per-call distributed single-dimension join (§4.4): the matched
    dimension is split across workers; each worker emits its slice of
    the order-3 output (D1-leading layout)."""
    pred = JoinPred(JoinKind.D2D, left, right)
    plan = plan or plan_join(pred, a, b, mesh_workers(mesh))
    av = a.value if left is Field.RID else a.value.T
    bv = b.value if right is Field.RID else b.value.T
    aa = spmd.place(av, costmod.ROW, mesh.devices)
    bb = spmd.align(spmd.place(bv, costmod.ROW, mesh.devices), aa)
    out = aa.map(lambda x, y: merge.fn(x[:, :, None], y[:, None, :]), bb)
    return spmd.assemble(out, a.value.device), plan


def measured_collective_bytes(fn, *args) -> int:
    """Run ``fn(*args)`` counting its collectives, and report the operand
    bytes worker 0 hands them — the per-device figure the JAX package
    reads from one device's optimized HLO."""
    with spmd.recording() as rec:
        fn(*args)
    return rec.per_worker


def measured_network_bytes(fn, *args, n_workers: int) -> int:
    """Network-wide collective wire bytes of ``fn(*args)`` — the quantity
    the paper's cost model predicts (entries moved × dtype bytes),
    counted by the collectives as they move the shards (``core.spmd``;
    ``n_workers`` is the mesh the function runs on)."""
    with spmd.recording() as rec:
        fn(*args)
    return rec.total
