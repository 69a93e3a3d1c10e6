"""Recursive tree-walk execution of logical plans (paper §5).

Since the physical planner (``repro_torch.plan``) exists, this module is
the **oracle** (``collect(engine="tree")``): the default ``collect()``
path lowers plans into a hash-consed operator DAG and executes that,
while this executor keeps the original per-node recursive semantics. The
shared primitive semantics (``agg_dense``, ``select_dense``) are defined
here and reused by both.

Two execution tiers:

* ``mode="sparse"`` (default) — block masks and COO entry sets gate every
  operator, the PNMF-style masked-matmul pattern (sparse ∘ (W×H)) is
  detected and routed to the masked kernel, and joins go through
  ``repro_torch.core.joins`` sparse implementations.
* ``mode="dense"``  — plain tensor reference semantics.

Zero ≡ NULL (absent) everywhere, matching the paper's sparse-matrix
relational semantics: Γnnz counts nonzeros, Γavg divides by nnz,
Γmax/Γmin ignore absent entries.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.core import joins as joinsmod
from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Inverse, Join, Leaf, MatMul,
    MatScalar, Select, Transpose,
)
from repro_torch.core.joins import COOTensor
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.predicates import CmpOp, Conjunction, Field, SpecialPred

Result = Union[BlockMatrix, COOTensor]

_CMP = {
    CmpOp.LT: torch.lt, CmpOp.LE: torch.le, CmpOp.EQ: torch.eq,
    CmpOp.NE: torch.ne, CmpOp.GE: torch.ge, CmpOp.GT: torch.gt,
}


# ---------------------------------------------------------------------------
# Shared primitive semantics (zero == NULL).
# ---------------------------------------------------------------------------

def agg_dense(v: torch.Tensor, fn: AggFn, dim: AggDim) -> torch.Tensor:
    axis = {AggDim.ROW: 1, AggDim.COL: 0}.get(dim)
    if dim is AggDim.DIAG:
        v = torch.diagonal(v)[None, :]
        axis = 1
    if dim is AggDim.ALL:
        v = v.reshape(1, -1)
        axis = 1
    present = v != 0
    if fn is AggFn.SUM:
        out = torch.sum(v, dim=axis)
    elif fn is AggFn.NNZ:
        out = torch.sum(present, dim=axis).to(v.dtype)
    elif fn is AggFn.AVG:
        cnt = torch.clamp(torch.sum(present, dim=axis), min=1)
        out = torch.sum(v, dim=axis) / cnt
    elif fn is AggFn.MAX:
        out = torch.amax(torch.where(present, v, -torch.inf), dim=axis)
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif fn is AggFn.MIN:
        out = torch.amin(torch.where(present, v, torch.inf), dim=axis)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        raise ValueError(fn)
    # outputs follow the paper's conventions: row-agg → m×1, col-agg → 1×n,
    # diag/all → 1×1
    if dim is AggDim.ROW:
        return out[:, None]
    return out[None, :] if out.ndim == 1 else out


def ew_values(op: EWOp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise merge on raw tensors (0/0 := 0 for division)."""
    if op is EWOp.ADD:
        return a + b
    if op is EWOp.MUL:
        return a * b
    return torch.where(b == 0, 0.0, a / torch.where(b == 0, 1.0, b))


def leaf_value(e: Leaf, env: Dict[str, BlockMatrix], block_size: int,
               device: Union[str, torch.device] = "cpu") -> BlockMatrix:
    """Resolve a leaf: catalog lookup or synthesized ``ones(m,n)``."""
    if e.name in env:
        return env[e.name]
    if e.name.startswith("ones("):
        return BlockMatrix.from_dense(
            torch.ones(e.shape, dtype=torch.float32, device=device),
            block_size)
    raise KeyError(f"unbound matrix {e.name!r}")


def env_device(env: Dict[str, BlockMatrix]) -> torch.device:
    """The device of a catalog's tensors (the CPU for an empty one)."""
    for bm in env.values():
        return bm.value.device
    return torch.device("cpu")


def as_matrix(r: Result) -> BlockMatrix:
    if isinstance(r, BlockMatrix):
        return r
    raise TypeError(
        "operator expected a matrix but got an order-"
        f"{r.order} tensor; aggregate it first")


def dense_join_result(out: torch.Tensor, block_size: int) -> Result:
    """Wrap a dense-tier join output: matrix, or COO view for order 3/4."""
    if out.ndim == 2:
        return BlockMatrix.from_dense(out, block_size)
    host = out.cpu().numpy()
    idx = np.argwhere(host != 0)
    return COOTensor(idx, host[tuple(idx.T)], tuple(out.shape))


def select_dense(v: torch.Tensor, pred: Conjunction) -> torch.Tensor:
    if pred.special is SpecialPred.ROWS_NONNULL:
        keep = torch.nonzero(torch.any(v != 0, dim=1)).reshape(-1)
        return v[keep, :]
    if pred.special is SpecialPred.COLS_NONNULL:
        keep = torch.nonzero(torch.any(v != 0, dim=0)).reshape(-1)
        return v[:, keep]
    if pred.is_diagonal():
        out = torch.diagonal(v)[:, None]
        # conjunct val predicates still apply on the diagonal vector
        for a in pred.val_atoms():
            out = torch.where(_CMP[a.op](out, a.rhs), out, 0.0)
        return out
    m, n = v.shape
    rr = pred.dim_range(Field.RID)
    cr = pred.dim_range(Field.CID)
    if rr is not None:
        lo = max(rr[0] if rr[0] is not None else 0, 0)
        hi = min(rr[1] if rr[1] is not None else m - 1, m - 1)
        v = v[lo:hi + 1, :]
    if cr is not None:
        lo = max(cr[0] if cr[0] is not None else 0, 0)
        hi = min(cr[1] if cr[1] is not None else n - 1, n - 1)
        v = v[:, lo:hi + 1]
    for a in pred.val_atoms():
        v = torch.where(_CMP[a.op](v, a.rhs), v, 0.0)
    return v


# ---------------------------------------------------------------------------
# Executor.
# ---------------------------------------------------------------------------

class Executor:
    def __init__(self, env: Dict[str, BlockMatrix], mode: str = "sparse",
                 block_size: int = 256, use_bloom: bool = True,
                 device=None):
        assert mode in ("sparse", "dense")
        self.env = env
        self.mode = mode
        self.block_size = block_size
        self.use_bloom = use_bloom
        self.device = env_device(env) if device is None \
            else torch.device(device)
        self.stats: Dict[str, int] = {"masked_matmuls": 0, "joins": 0}

    # -- public ---------------------------------------------------------------
    def run(self, plan: Expr) -> Result:
        return self._eval(plan)

    # -- dispatch -------------------------------------------------------------
    def _eval(self, e: Expr) -> Result:
        bs = self.block_size
        if isinstance(e, Leaf):
            return leaf_value(e, self.env, bs, self.device)
        if isinstance(e, Transpose):
            x = as_matrix(self._eval(e.x))
            return BlockMatrix.from_dense(x.value.T, bs)
        if isinstance(e, MatScalar):
            x = as_matrix(self._eval(e.x))
            v = x.value + e.beta if e.op is EWOp.ADD else x.value * e.beta
            return BlockMatrix.from_dense(v, bs)
        if isinstance(e, ElemWise):
            return self._elemwise(e)
        if isinstance(e, MatMul):
            a = as_matrix(self._eval(e.a))
            b = as_matrix(self._eval(e.b))
            return BlockMatrix.from_dense(torch.matmul(a.value, b.value), bs)
        if isinstance(e, Inverse):
            x = as_matrix(self._eval(e.x))
            return BlockMatrix.from_dense(torch.linalg.inv(x.value), bs)
        if isinstance(e, Select):
            x = as_matrix(self._eval(e.x))
            return BlockMatrix.from_dense(select_dense(x.value, e.pred), bs)
        if isinstance(e, Agg):
            x = as_matrix(self._eval(e.x))
            return BlockMatrix.from_dense(agg_dense(x.value, e.fn, e.dim), bs)
        if isinstance(e, Join):
            return self._join(e)
        raise TypeError(type(e))

    # -- sparsity-aware elementwise (the PNMF masked-matmul pattern) ----------
    def _elemwise(self, e: ElemWise) -> BlockMatrix:
        if self.mode == "sparse" and e.op in (EWOp.MUL, EWOp.DIV):
            # A ∘ (W×H) with sparse A: only compute the W×H blocks that land
            # under nonzero blocks of A (paper §6, PNMF discussion)
            for sparse_side, mm_side, flip in ((e.a, e.b, False),
                                               (e.b, e.a, True)):
                if isinstance(mm_side, MatMul) and sparse_side.sparsity < 0.5:
                    sp = as_matrix(self._eval(sparse_side))
                    w = as_matrix(self._eval(mm_side.a))
                    h = as_matrix(self._eval(mm_side.b))
                    from repro_torch.kernels import registry
                    prod = registry.dispatch(
                        "masked_matmul", w.value, h.value, sp.block_mask,
                        block_size=self.block_size)
                    self.stats["masked_matmuls"] += 1
                    if e.op is EWOp.MUL:
                        v = sp.value * prod
                    else:
                        num, den = (prod, sp.value) if flip \
                            else (sp.value, prod)
                        v = torch.where((num == 0) | (den == 0), 0.0,
                                        num / torch.where(den == 0, 1.0, den))
                    return BlockMatrix(v, sp.block_mask, self.block_size)
        a = as_matrix(self._eval(e.a))
        b = as_matrix(self._eval(e.b))
        return BlockMatrix.from_dense(ew_values(e.op, a.value, b.value),
                                      self.block_size)

    def _join(self, e: Join) -> Result:
        a = as_matrix(self._eval(e.a))
        b = as_matrix(self._eval(e.b))
        self.stats["joins"] += 1
        if self.mode == "dense":
            out = joinsmod.join_dense(a.value, b.value, e.pred, e.merge)
            return dense_join_result(out, self.block_size)
        return joinsmod.join_sparse(a, b, e.pred, e.merge,
                                    use_bloom=self.use_bloom)


def execute(plan: Expr, env: Dict[str, BlockMatrix],
            mode: str = "sparse", **kw) -> Result:
    return Executor(env, mode=mode, **kw).run(plan)
