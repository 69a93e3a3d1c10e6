"""User-facing fluent API mirroring the paper's Scala interface (Codes 1–5).

    s = Session()                                      # on the card
    X = s.load(x_array, name="X")
    tr = X.t().multiply(X).trace().collect()           # Code 1
    g11 = X.t().multiply(X).select("RID=1 AND CID=1")  # Code 2
    kron = A.cross_prod(B, lambda x, y: x * y)         # Code 3
    C = A.join(B, "RID=RID AND CID=CID", f)            # Code 4
    C = A.join(B, "VAL=VAL", f)                        # Code 5

``collect()`` runs the cost-based optimizer — a memoized search over the
paper's rewrite rules in which every candidate is costed by dry-lowering
it through the physical layer (``Session(search="greedy")`` keeps the
fixed-point rewriter as the oracle) — lowers the winner into a
hash-consed physical operator DAG (``repro_torch.plan``) and executes it.
``collect(optimize=False)`` skips the logical rewrites;
``collect(engine="tree")`` runs the recursive tree-walk executor, kept as
the correctness oracle.

A session lives on one device: ``Session()`` is the card (and raises
without one); ``Session(device="cpu")`` runs the plain PyTorch versions
of the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import plan as planmod
from repro_torch.core import executor as exmod
from repro_torch.core import optimizer as optmod
from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Inverse, Join, Leaf, MatMul,
    MatScalar, MergeFn, Select, Transpose,
)
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.plancache import VersionedLRU
from repro_torch.core.predicates import parse_join, parse_select
from repro_torch.device import resolve_device


def catalog_from_numpy(arrays: Dict[str, np.ndarray], block_size: int = 256,
                       device=None) -> Dict[str, BlockMatrix]:
    """``{name: BlockMatrix}`` of float32 tensors on ``device`` — e.g. the
    JAX package's catalog as ``{name: np.asarray(bm.value)}``."""
    dev = resolve_device(device)
    return {name: BlockMatrix.from_dense(
                torch.as_tensor(np.array(v, np.float32), device=dev),
                block_size)
            for name, v in arrays.items()}


class Session:
    """Holds named base matrices (the catalog) and execution settings.

    ``engine`` selects the default ``collect()`` path: ``"dag"`` (the
    physical planner, default) or ``"tree"`` (the recursive executor,
    kept as the oracle the planner is tested against). ``device`` is
    where every tensor of the session lives (``None`` → ``"cuda"``).
    """

    def __init__(self, block_size: int = 256, mode: str = "sparse",
                 use_bloom: bool = True, engine: str = "dag",
                 n_workers: Optional[int] = None, search: str = "memo",
                 ledger=None, cost_model=None, device=None):
        if engine not in ("dag", "tree"):
            raise ValueError(f"unknown engine {engine!r}")
        if search not in ("memo", "greedy"):
            raise ValueError(f"unknown search {search!r}")
        if n_workers is not None and n_workers > 1:
            raise NotImplementedError(
                "multi-worker sessions are not ported yet (ROADMAP: "
                "multi-worker schemes)")
        self.device = resolve_device(device)
        self.env: Dict[str, BlockMatrix] = {}
        self.block_size = block_size
        self.mode = mode
        self.use_bloom = use_bloom
        self.engine = engine
        self.search = search
        self.n_workers = n_workers
        # optional ``obs.ledger.CostLedger``: when set, every plan this
        # session executes through the DAG engine appends one
        # predicted-vs-actual row (the serving tier installs its own)
        self.ledger = ledger
        # optional ``core.calibrate.CostModel``: candidate costing blends
        # its calibrated wall-time prediction into ``physical_cost``
        # (analytic-only when unset or unfitted for this device key)
        self.cost_model = cost_model
        self._auto = 0
        self._env_version = 0
        self._plan_cache = VersionedLRU(_PLAN_CACHE_LIMIT)
        self._opt_cache = VersionedLRU(_PLAN_CACHE_LIMIT)

    def load(self, value, name: Optional[str] = None,
             sparsity: Optional[float] = None) -> "Matrix":
        if name is None:
            self._auto += 1
            name = f"_m{self._auto}"
        if isinstance(value, BlockMatrix):
            bm = value
            if bm.value.device != self.device:
                raise ValueError(f"matrix on {bm.value.device}, session on "
                                 f"{self.device}")
        else:
            bm = BlockMatrix.from_dense(
                torch.as_tensor(value, dtype=torch.float32,
                                device=self.device), self.block_size)
        self.env[name] = bm
        # (re)binding a leaf invalidates memoized optimize results: the
        # memo search costs candidates against the bound leaf masks
        self._env_version += 1
        if sparsity is None:
            sparsity = float(bm.nnz()) / max(1, bm.value.numel())
        return Matrix(self, Leaf(name, bm.shape, sparsity))

    def load_catalog(self, arrays: Dict[str, np.ndarray]) -> Dict[str, "Matrix"]:
        """Load ``{name: array}`` (``catalog_from_numpy``) → ``{name: Matrix}``."""
        cat = catalog_from_numpy(arrays, self.block_size, self.device)
        return {name: self.load(bm, name) for name, bm in cat.items()}

    def execute(self, plan: Expr, optimize: bool = True,
                engine: Optional[str] = None):
        import time
        from repro_torch.obs.trace import span
        opt = None
        if optimize:
            opt = self.optimize_result(plan)
            plan = opt.plan
        engine = engine or self.engine
        if engine not in ("dag", "tree"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "tree":
            with span("execute", path="tree"):
                return exmod.execute(plan, self.env, mode=self.mode,
                                     block_size=self.block_size,
                                     use_bloom=self.use_bloom,
                                     device=self.device)
        pplan = self.physical_plan(plan)
        ex = planmod.PlanExecutor(self.env, device=self.device)
        t0 = time.perf_counter()
        out = ex.run(pplan)
        if self.device.type == "cuda":
            # launches are asynchronous: the query is done when its device
            # work is, so a caller's clock around collect() (and the
            # ledger's wall) times execution, not the enqueue
            torch.cuda.synchronize(self.device)
        if self.ledger is not None:
            from repro_torch.core.expr import signature
            from repro_torch.obs.ledger import exec_path_of
            self.ledger.record(
                query=signature(plan), plan=pplan,
                exec_path=exec_path_of(ex.stats),
                wall_s=time.perf_counter() - t0,
                compile_s=ex.timings["compile_s"],
                overflow=ex.stats["sparse_overflows"] > 0, opt=opt)
        return out

    def optimize_result(self, plan: Expr,
                        search: Optional[str] = None) -> optmod.OptimizeResult:
        """Session-aware optimization with a bounded per-session memo, keyed
        on the plan, the search, the catalog version and the settings the
        memo search costs against (mode, block size, Bloom preference).
        The calibrated cost-model version is in the key too: a
        (background) refit re-optimizes instead of serving decisions
        made under retired coefficients."""
        search = search or self.search
        key = (plan, search, self._env_version, self.mode,
               self.block_size, self.use_bloom, self.n_workers,
               self._costmodel_key())
        return self._opt_cache.get_or_create(
            key, lambda: optmod.optimize(plan, search=search, session=self))

    def _costmodel_key(self):
        """Cache-key component for the calibrated cost model: identity +
        fit version (bumped per successful refit)."""
        if self.cost_model is None:
            return None
        return (id(self.cost_model), self.cost_model.version)

    def _optimized(self, plan: Expr) -> Expr:
        return self.optimize_result(plan).plan

    def physical_plan(self, plan: Expr) -> "planmod.PhysicalPlan":
        """Lower ``plan`` (assumed already optimized) into a physical DAG.

        Plans are cached per (expr, catalog version, mode, block_size,
        use_bloom, n_workers): plan annotations derive from the expression,
        those settings *and the bound leaf data* (mask/nnz propagation and
        COO capacity sizing read the catalog), so a leaf rebind replans.
        The cache is a bounded LRU (``core.plancache.VersionedLRU``).
        """
        key = (plan, self._env_version, self.mode, self.block_size,
               self.use_bloom, self.n_workers)
        return self._plan_cache.get_or_create(
            key, lambda: planmod.build_plan(
                plan, mode=self.mode, block_size=self.block_size,
                use_bloom=self.use_bloom, n_workers=self.n_workers,
                device=self.device))


# Bounds the per-session physical-plan cache (sessions issuing dynamically
# generated queries would otherwise grow it without bound).
_PLAN_CACHE_LIMIT = 128


def _merge_of(f: Union[MergeFn, Callable], name: str = "f") -> MergeFn:
    return f if isinstance(f, MergeFn) else MergeFn(name, f)


@dataclasses.dataclass
class Matrix:
    session: Session
    plan: Expr

    # -- matrix operators (paper §2) -----------------------------------------
    def t(self) -> "Matrix":
        return Matrix(self.session, Transpose(self.plan))

    def multiply(self, other: "Matrix") -> "Matrix":
        return Matrix(self.session, MatMul(self.plan, other.plan))

    def add(self, other: Union["Matrix", float]) -> "Matrix":
        if isinstance(other, Matrix):
            return Matrix(self.session,
                          ElemWise(self.plan, other.plan, EWOp.ADD))
        return Matrix(self.session,
                      MatScalar(self.plan, EWOp.ADD, float(other)))

    def emul(self, other: Union["Matrix", float]) -> "Matrix":
        if isinstance(other, Matrix):
            return Matrix(self.session,
                          ElemWise(self.plan, other.plan, EWOp.MUL))
        return Matrix(self.session,
                      MatScalar(self.plan, EWOp.MUL, float(other)))

    def ediv(self, other: "Matrix") -> "Matrix":
        return Matrix(self.session, ElemWise(self.plan, other.plan, EWOp.DIV))

    def inverse(self) -> "Matrix":
        return Matrix(self.session, Inverse(self.plan))

    # -- relational operators (paper §3, §4) ----------------------------------
    def select(self, pred: str) -> "Matrix":
        return Matrix(self.session, Select(self.plan, parse_select(pred)))

    def agg(self, fn: str, dim: str) -> "Matrix":
        return Matrix(self.session,
                      Agg(self.plan, AggFn(fn), AggDim(dim)))

    def sum(self, dim: str = "a") -> "Matrix":
        return self.agg("sum", dim)

    def nnz(self, dim: str = "a") -> "Matrix":
        return self.agg("nnz", dim)

    def avg(self, dim: str = "a") -> "Matrix":
        return self.agg("avg", dim)

    def max(self, dim: str = "a") -> "Matrix":
        return self.agg("max", dim)

    def min(self, dim: str = "a") -> "Matrix":
        return self.agg("min", dim)

    def trace(self) -> "Matrix":
        return self.agg("sum", "d")

    def join(self, other: "Matrix", pred: str,
             f: Union[MergeFn, Callable]) -> "Matrix":
        return Matrix(self.session,
                      Join(self.plan, other.plan, parse_join(pred),
                           _merge_of(f)))

    def cross_prod(self, other: "Matrix",
                   f: Union[MergeFn, Callable]) -> "Matrix":
        return self.join(other, "CROSS", f)

    # -- execution -------------------------------------------------------------
    def optimized_plan(self,
                       search: Optional[str] = None) -> optmod.OptimizeResult:
        """Optimize against the owning session; ``search`` overrides the
        session default ("memo" | "greedy")."""
        return self.session.optimize_result(self.plan, search=search)

    def physical_plan(self, optimize: bool = True) -> planmod.PhysicalPlan:
        plan = self.optimized_plan().plan if optimize else self.plan
        return self.session.physical_plan(plan)

    def explain(self, physical: bool = False, trace: bool = False) -> str:
        """Logical EXPLAIN (rewrites + costs) or, with ``physical=True``,
        the physical DAG with per-node cost, strategy and backend, headed
        by the optimizer's decision record. ``trace=True`` additionally
        runs the query once under a forced-sample trace (bypassing the
        session's optimize/plan caches) and appends the span tree."""
        trace_txt = ""
        if trace:
            trace_txt = "\n" + self._traced_run().render()
        if physical:
            result = self.optimized_plan()
            plan = self.session.physical_plan(result.plan)
            if plan.mode == "sparse":
                # annotate propagated masks / nnz bounds / COO capacities
                # from the session catalog so EXPLAIN shows the numbers
                # the cost gates actually used (repro_torch.plan.masks)
                from repro_torch.plan import masks as masksmod
                try:
                    masksmod.annotate(plan, self.session.env)
                except KeyError:
                    pass  # unbound leaves: render the un-annotated plan
            return planmod.render(plan, opt=result) + trace_txt
        return self.optimized_plan().describe(self.plan) + trace_txt

    def _traced_run(self):
        """Execute once under a forced-sample trace, hitting every
        lifecycle phase."""
        from repro_torch.core.expr import signature
        from repro_torch.obs.trace import TRACER
        s = self.session
        tr = TRACER.start("query", sample=True, query=signature(self.plan))
        with TRACER.activate(tr):
            opt = optmod.optimize(self.plan, search=s.search, session=s)
            pplan = planmod.build_plan(
                opt.plan, mode=s.mode, block_size=s.block_size,
                use_bloom=s.use_bloom, n_workers=s.n_workers,
                device=s.device)
            planmod.PlanExecutor(s.env, device=s.device).run(pplan)
        tr.finish()
        return tr

    def collect(self, optimize: bool = True, engine: Optional[str] = None):
        return self.session.execute(self.plan, optimize=optimize,
                                    engine=engine)

    def to_numpy(self, optimize: bool = True) -> np.ndarray:
        out = self.collect(optimize=optimize)
        if isinstance(out, BlockMatrix):
            return out.value.cpu().numpy()
        return out.to_dense()
