"""Cost model: computation cost of plans + the paper's communication model.

Computation cost (flop estimates with sparsity) drives the rewrite engine;
the communication model implements the paper's §4.7 cost functions verbatim:
cross-product, direct/transpose overlay, Table 1 (D2D), Table 2 (D2V/V2D) and
Table 3 (partition-scheme conversion). Sizes |A| follow the paper: nnz(A) for
sparse matrices, m·n for dense.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Inverse, Join, Leaf, MatMul,
    MatScalar, Select,
    Transpose,
)
from repro_torch.core.predicates import Field, JoinKind, JoinPred

# Partitioning schemes (paper §4.7): Row, Column, Broadcast (+ ξ = random).
ROW, COL, BCAST, RANDOM = "r", "c", "b", "xi"
SCHEMES = (ROW, COL, BCAST)

# A matrix is "tiny" (broadcastable for free) below this entry count; mirrors
# the paper's "Broadcast is only used for a matrix of low dimensions".
BROADCAST_LIMIT = 1 << 22


# ---------------------------------------------------------------------------
# Computation cost (drives logical rewrites).
# ---------------------------------------------------------------------------

def node_flops(e: Expr) -> float:
    """Estimated scalar ops to materialize node ``e`` from its children."""
    if isinstance(e, Leaf):
        return 0.0
    if isinstance(e, Transpose):
        return float(e.size)  # data movement; count as 1 op/entry
    if isinstance(e, (MatScalar,)):
        return float(e.x.size * max(e.x.sparsity, 1e-12)) \
            if e.op is EWOp.MUL else float(e.x.size)
    if isinstance(e, ElemWise):
        sa, sb = e.a.sparsity, e.b.sparsity
        if e.op is EWOp.MUL:
            dens = min(sa, sb)          # sparsity-inducing both sides
        elif e.op is EWOp.DIV:
            dens = sa                   # numerator-side inducing (Eq. 20)
        else:
            dens = min(1.0, sa + sb)
        return float(e.size) * max(dens, 1e-12)
    if isinstance(e, MatMul):
        m, k = e.a.shape
        _, n = e.b.shape
        dens = max(e.a.sparsity * e.b.sparsity, 1e-12)
        return 2.0 * m * k * n * dens
    if isinstance(e, Inverse):
        n = e.shape[0]
        return 2.0 * n ** 3
    if isinstance(e, Select):
        return float(e.size)  # slice/mask pass over the (output) region
    if isinstance(e, Agg):
        if e.dim is AggDim.DIAG:
            return float(e.x.shape[0])
        return float(e.x.size * max(e.x.sparsity, 1e-12))
    if isinstance(e, Join):
        return join_flops(e)
    raise TypeError(f"unknown node {type(e)}")


def join_flops(e: Join) -> float:
    sa, sb = e.a.sparsity, e.b.sparsity
    k = e.pred.kind
    if k is JoinKind.CROSS:
        return float(e.a.size * sa) * float(e.b.size * sb)
    if k in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        return float(e.size) * min(1.0, sa + sb)
    if k is JoinKind.D2D:
        d1, d2, d3 = e.shape
        return float(d1) * (d2 * sa) * (d3 * sb)
    if k is JoinKind.V2V:
        return float(e.a.size * sa) * float(e.b.size * sb)
    # D2V/V2D: each matched entry of the val side joins a row/col of the other
    eta = 0.1
    if k is JoinKind.D2V:
        return float(e.b.size * sb * eta) * max(e.a.shape)
    return float(e.a.size * sa * eta) * max(e.b.shape)


def plan_flops(e: Expr) -> float:
    return node_flops(e) + sum(plan_flops(c) for c in e.children())


def plan_memory(e: Expr) -> float:
    """Peak intermediate entries (coarse): sum of all materialized nodes."""
    own = 0.0 if isinstance(e, Leaf) else float(e.size) * max(e.sparsity, 0.0)
    return own + sum(plan_memory(c) for c in e.children())


# ---------------------------------------------------------------------------
# Unified physical cost (the memo search's objective).
#
# One number per candidate rewrite, produced by actually lowering the
# expression through the physical layer: builder strategy selection +
# scheme DP (comm entries) + mask-propagated nnz bounds. The weights put
# the three ledgers in a common "scalar op" unit: moving an entry across
# the interconnect costs ~COMM_FLOPS_PER_ENTRY ops worth of time, and
# materializing an intermediate entry costs ~1 write.
# ---------------------------------------------------------------------------

COMM_FLOPS_PER_ENTRY = 16.0
MATERIALIZE_FLOPS_PER_ENTRY = 1.0


@dataclasses.dataclass(frozen=True)
class PhysicalCost:
    """flops / comm-entries / materialized-nnz breakdown of one lowering,
    optionally blended with a calibrated wall-time prediction
    (``core.calibrate.CostModel``). ``calibrated_s`` is the predicted
    wall seconds for this lowering on the session's device key (None when
    no fitted coefficients exist), and ``alpha`` the analytic blend
    weight — 1.0 means pure analytic (the cold-machine fallback)."""

    flops: float
    comm: float
    nnz: float
    calibrated_s: Optional[float] = None
    alpha: float = 1.0
    # seconds→scalar-op unit for the blend: the model's fitted
    # per-device throughput when available, else the static default
    cal_unit: Optional[float] = None

    @property
    def analytic(self) -> float:
        return (self.flops + COMM_FLOPS_PER_ENTRY * self.comm
                + MATERIALIZE_FLOPS_PER_ENTRY * self.nnz)

    @property
    def total(self) -> float:
        """``alpha·analytic + (1-alpha)·calibrated`` in scalar-op units;
        falls back to the pure analytic total when uncalibrated."""
        if self.calibrated_s is None or self.alpha >= 1.0:
            return self.analytic
        unit = self.cal_unit
        if not unit:
            from repro_torch.core.calibrate import calibrated_unit_flops
            unit = calibrated_unit_flops()
        cal = self.calibrated_s * unit
        return self.alpha * self.analytic + (1.0 - self.alpha) * cal

    def breakdown(self) -> str:
        base = f"{self.flops:.4g}/{self.comm:.4g}/{self.nnz:.4g}"
        if self.calibrated_s is not None and self.alpha < 1.0:
            base += (f" cal={self.calibrated_s*1e3:.3g}ms"
                     f"@a={self.alpha:.2f}")
        return base


def physical_cost(e: Expr, session=None, *, mode: Optional[str] = None,
                  block_size: Optional[int] = None,
                  use_bloom: Optional[bool] = None,
                  n_workers: Optional[int] = None, leaves=None,
                  cost_model=None) -> PhysicalCost:
    """Cost ``e`` by dry-lowering it through the physical layer.

    Builds the hash-consed physical DAG (``plan.builder`` in cost-only
    mode: no kernel-backend resolution, nothing staged), runs the scheme
    DP for the communication total on multi-worker sessions, and — when a
    session with bound leaves is given — the mask propagation pass for
    certified per-node nnz bounds. ``leaves`` may carry a shared
    ``plan.masks.Leaves`` so one optimize() call fetches each catalog
    array and block mask at most once across all candidate lowerings.

    ``cost_model`` (or ``session.cost_model``) is an optional
    ``core.calibrate.CostModel``: when it holds fitted coefficients for
    the session's device key (``calibrate.device_key``), the returned
    cost carries a calibrated wall-time prediction and ``total`` blends
    it with the analytic terms.
    """
    from repro_torch.obs.trace import span
    from repro_torch.plan import builder as buildermod
    from repro_torch.plan import ops as P
    if session is not None:
        mode = mode or session.mode
        block_size = block_size or session.block_size
        use_bloom = session.use_bloom if use_bloom is None else use_bloom
        n_workers = n_workers or session.n_workers
        if cost_model is None:
            cost_model = getattr(session, "cost_model", None)
    with span("physical_cost"):
        plan = buildermod.build_plan(
            e, mode=mode or "sparse", block_size=block_size or 256,
            use_bloom=True if use_bloom is None else use_bloom,
            n_workers=n_workers, cost_only=True)
        bounds = {}
        if session is not None:
            from repro_torch.plan import masks as masksmod
            try:
                infos = masksmod.annotate(plan, session.env, leaves=leaves)
                bounds = {i: info.nnz for i, info in infos.items()}
            except KeyError:
                pass  # unbound leaves: fall back to the logical estimators
    nnz = 0.0
    for node in plan.nodes:
        if node.kind == P.LEAF:
            continue
        size = 1.0
        for d in node.shape:
            size *= d
        # entries this operator materializes: the logical estimate,
        # tightened by the mask-certified bound where one exists — so a
        # rewrite that destroys a sparsity mask (densifies an
        # intermediate) pays for it here even when flops tie
        est = size * max(node.sparsity, 0.0)
        cert = bounds.get(node.op_id)
        if cert is not None:
            est = min(est, float(cert))
        nnz += est
    calibrated_s = None
    alpha = 1.0
    cal_unit = None
    if cost_model is not None:
        from repro_torch.core.calibrate import device_key, features_from_plan
        key = device_key(getattr(session, "device", None))
        calibrated_s = cost_model.predict(
            features_from_plan(plan, nnz=nnz), device=key)
        if calibrated_s is not None:
            alpha = cost_model.alpha(device=key)
            cal_unit = cost_model.unit_flops(device=key)
    return PhysicalCost(flops=plan.est_flops, comm=plan.total_comm_est,
                        nnz=nnz, calibrated_s=calibrated_s, alpha=alpha,
                        cal_unit=cal_unit)


# ---------------------------------------------------------------------------
# Entry-join strategy gate (paper §4.5/§4.7): Bloom-filtered vs. plain
# sort-merge. Chosen at plan time from the nnz estimates.
# ---------------------------------------------------------------------------

# Below this many entries on either side the Bloom build/probe overhead
# exceeds the sorting work it can save.
V2V_BLOOM_MIN_ENTRIES = 256

BLOOM_SORTMERGE = "bloom-sortmerge"
SORTMERGE = "sortmerge"

# Largest static COO expansion buffer the device-resident sparse tier will
# allocate for one join (entries; idx+val ≈ 20 B each). Joins whose
# plan-time capacity bound exceeds this run on the host oracle instead —
# the "guarded fallback" of the mask-propagation pass (repro.plan.masks,
# which also honors the REPRO_SPARSE_CAP env override).
SPARSE_DEVICE_CAP = 1 << 23


@dataclasses.dataclass(frozen=True)
class JoinStrategyChoice:
    strategy: str
    cost_sortmerge: float
    cost_bloom: float


def choose_v2v_strategy(nnz_a: float, nnz_b: float,
                        match_frac: float = 0.1,
                        use_bloom: bool = True) -> JoinStrategyChoice:
    """Cost-gate the Bloom pre-filter for entry joins.

    Plain sort-merge sorts both entry sets; the Bloom variant first builds
    a filter over B's values and probes A's entries, so only the expected
    ``match_frac`` survivors of A enter the sort. The filter pays off when
    the avoided ``n_a log n_a`` sorting work exceeds the linear build +
    probe cost — i.e. for large, selective entry joins (the paper's Fig.
    11d regime). Tiny inputs always take plain sort-merge.
    """
    import math
    na, nb = max(float(nnz_a), 1.0), max(float(nnz_b), 1.0)
    survivors = max(na * match_frac, 1.0)
    c_merge = na * math.log2(na + 1) + nb * math.log2(nb + 1)
    c_bloom = (na + nb                               # probe + build
               + survivors * math.log2(survivors + 1)
               + nb * math.log2(nb + 1))
    if (use_bloom and min(na, nb) >= V2V_BLOOM_MIN_ENTRIES
            and c_bloom < c_merge):
        return JoinStrategyChoice(BLOOM_SORTMERGE, c_merge, c_bloom)
    return JoinStrategyChoice(SORTMERGE, c_merge, c_bloom)


# ---------------------------------------------------------------------------
# Communication cost model (paper §4.7). Units: matrix entries moved.
# ---------------------------------------------------------------------------

def size_of(e: Expr) -> float:
    """|A|: nnz for sparse, m·n for dense (paper's convention)."""
    return e.nnz_est if e.sparsity < 1.0 else float(e.size)


def conversion_cost(size: float, s_from: str, s_to: str, n_workers: int) -> float:
    """Paper Table 3: cost of re-partitioning a matrix between schemes."""
    n = n_workers
    if s_from == BCAST:
        return 0.0
    if s_from == s_to:
        return 0.0
    if s_from in (ROW, COL):
        if s_to in (ROW, COL):
            return (n - 1) / n * size
        if s_to == BCAST:
            return (n - 1) * size
    if s_from == RANDOM:
        if s_to in (ROW, COL):
            return size
        if s_to == BCAST:
            return n * size
    raise ValueError(f"unknown conversion {s_from}->{s_to}")


def _d2d_cost(gamma: Tuple[Field, Field], s_a: str, s_b: str,
              size_a: float, size_b: float, n: int) -> float:
    """Paper Table 1. γ is (dim of A, dim of B)."""
    if BCAST in (s_a, s_b):
        return 0.0
    la, rb = gamma
    # The scheme "aligned" with the predicate on each side:
    align_a = ROW if la is Field.RID else COL
    align_b = ROW if rb is Field.RID else COL
    a_ok, b_ok = (s_a == align_a), (s_b == align_b)
    if a_ok and b_ok:
        return 0.0
    if a_ok and not b_ok:
        # B mispartitioned: broadcast A or re-slot B's blocks
        return min((n - 1) * size_a, (n - 1) / n * size_b)
    if b_ok and not a_ok:
        return min((n - 1) / n * size_a, (n - 1) * size_b)
    return (n - 1) * min(size_a, size_b)


def _dv_cost(kind: JoinKind, gamma_dim: Field, s_a: str, s_b: str,
             size_a: float, size_b: float, n: int,
             eta_a: float, eta_b: float) -> float:
    """Paper Table 2 (D2V and V2D)."""
    if BCAST in (s_a, s_b):
        return 0.0
    if kind is JoinKind.D2V:
        # γ: dim_A = val_B. A aligned if its scheme matches the dim.
        align_a = ROW if gamma_dim is Field.RID else COL
        mult = 1.0 if s_a == align_a else float(n)
        return min((n - 1) * size_a, mult * eta_b * size_b)
    # V2D: val_A = dim_B
    align_b = ROW if gamma_dim is Field.RID else COL
    mult = 1.0 if s_b == align_b else float(n)
    return min(mult * eta_a * size_a, (n - 1) * size_b)


def join_comm_cost(pred: JoinPred, s_a: str, s_b: str, size_a: float,
                   size_b: float, n_workers: int,
                   eta_a: float = 0.1, eta_b: float = 0.1) -> float:
    """C_comm(A ⋈_{γ,f} B | s_A, s_B): the paper's full §4.7 model."""
    n = n_workers
    k = pred.kind
    if k is JoinKind.CROSS or k is JoinKind.V2V:
        if BCAST in (s_a, s_b):
            return 0.0
        return (n - 1) * min(size_a, size_b)
    if k is JoinKind.DIRECT_OVERLAY:
        if BCAST in (s_a, s_b):
            return 0.0
        if (s_a, s_b) in ((ROW, COL), (COL, ROW)):
            return (n - 1) / n * min(size_a, size_b)
        return 0.0
    if k is JoinKind.TRANSPOSE_OVERLAY:
        if BCAST in (s_a, s_b):
            return 0.0
        if (s_a, s_b) in ((ROW, ROW), (COL, COL)):
            return (n - 1) / n * min(size_a, size_b)
        return 0.0
    if k is JoinKind.D2D:
        return _d2d_cost((pred.left, pred.right), s_a, s_b, size_a, size_b, n)
    if k is JoinKind.D2V:
        return _dv_cost(k, pred.left, s_a, s_b, size_a, size_b, n,
                        eta_a, eta_b)
    if k is JoinKind.V2D:
        return _dv_cost(k, pred.right, s_a, s_b, size_a, size_b, n,
                        eta_a, eta_b)
    raise ValueError(k)


@dataclasses.dataclass(frozen=True)
class PartitionChoice:
    scheme_a: str
    scheme_b: str
    comm_cost: float          # join communication under the chosen schemes
    conversion_cost: float    # Table-3 conversion cost to reach them
    total: float


def broadcastable(size: float) -> bool:
    return size <= BROADCAST_LIMIT


def assign_schemes(pred: JoinPred, size_a: float, size_b: float,
                   n_workers: int, s_a: str = RANDOM, s_b: str = RANDOM,
                   eta_a: float = 0.1, eta_b: float = 0.1) -> PartitionChoice:
    """Grid-search (s'_A, s'_B) minimizing C_comm + C_vt (paper §4.7 algo)."""
    best = None
    for sa2 in SCHEMES:
        if sa2 == BCAST and not broadcastable(size_a):
            continue
        for sb2 in SCHEMES:
            if sb2 == BCAST and not broadcastable(size_b):
                continue
            cc = join_comm_cost(pred, sa2, sb2, size_a, size_b, n_workers,
                                eta_a, eta_b)
            vt = (conversion_cost(size_a, s_a, sa2, n_workers)
                  + conversion_cost(size_b, s_b, sb2, n_workers))
            tot = cc + vt
            if best is None or tot < best.total:
                best = PartitionChoice(sa2, sb2, cc, vt, tot)
    assert best is not None
    return best

