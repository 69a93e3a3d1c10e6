"""Logical plan IR for relational + matrix operations (paper §2–§4).

Nodes are immutable; every node carries shape and sparsity estimates used by
the optimizer's cost model. Sparsity propagation follows the MatFast-style
estimator the paper builds on (leaf sparsity is known; operators propagate
under an independence assumption).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Tuple, Union

from repro_torch.core.predicates import (
    Conjunction, Field, JoinKind, JoinPred, SpecialPred,
)

Shape = Tuple[int, ...]


class EWOp(enum.Enum):
    ADD = "+"
    MUL = "*"
    DIV = "/"


class AggFn(enum.Enum):
    SUM = "sum"
    NNZ = "nnz"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


class AggDim(enum.Enum):
    ROW = "r"      # m×n → m×1 (aggregate along each row)
    COL = "c"      # m×n → 1×n
    DIAG = "d"     # square only → scalar (trace for SUM)
    ALL = "a"      # → scalar


class Expr:
    """Base class; concrete nodes are frozen dataclasses below."""

    shape: Shape
    sparsity: float  # expected fraction of nonzero entries in [0, 1]

    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nnz_est(self) -> float:
        """|A| in the paper's cost model: nnz for sparse, m·n for dense."""
        return self.size * self.sparsity

    def children(self) -> Tuple["Expr", ...]:
        return ()

    def with_children(self, *ch: "Expr") -> "Expr":
        raise NotImplementedError

    # small readable repr for plan printing / EXPERIMENTS logs
    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        label = self._label()
        lines = [f"{pad}{label}  shape={self.shape} sp={self.sparsity:.3g}"]
        for c in self.children():
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def _label(self) -> str:
        return type(self).__name__


def _clamp(s: float) -> float:
    return max(0.0, min(1.0, s))


@dataclasses.dataclass(frozen=True)
class Leaf(Expr):
    name: str
    shape: Shape
    sparsity: float = 1.0

    def _label(self) -> str:
        return f"Leaf[{self.name}]"

    def with_children(self) -> "Leaf":
        return self


@dataclasses.dataclass(frozen=True)
class Transpose(Expr):
    x: Expr

    def __post_init__(self):
        if self.x.order != 2:
            raise ValueError("transpose is defined on matrices")

    @property
    def shape(self) -> Shape:
        m, n = self.x.shape
        return (n, m)

    @property
    def sparsity(self) -> float:
        return self.x.sparsity

    def children(self):
        return (self.x,)

    def with_children(self, x):
        return Transpose(x)


@dataclasses.dataclass(frozen=True)
class MatScalar(Expr):
    """Matrix-scalar op: A + β or A * β (paper §2)."""

    x: Expr
    op: EWOp
    beta: float

    @property
    def shape(self) -> Shape:
        return self.x.shape

    @property
    def sparsity(self) -> float:
        if self.op is EWOp.ADD:
            return 1.0 if self.beta != 0 else self.x.sparsity
        return self.x.sparsity if self.beta != 0 else 0.0

    def children(self):
        return (self.x,)

    def with_children(self, x):
        return MatScalar(x, self.op, self.beta)

    def _label(self):
        return f"MatScalar[{self.op.value}{self.beta}]"


@dataclasses.dataclass(frozen=True)
class ElemWise(Expr):
    """Element-wise A ⋆ B with ⋆ ∈ {+, *, /} (paper §2)."""

    a: Expr
    b: Expr
    op: EWOp

    def __post_init__(self):
        if self.a.shape != self.b.shape:
            raise ValueError(
                f"elemwise shape mismatch {self.a.shape} vs {self.b.shape}")

    @property
    def shape(self) -> Shape:
        return self.a.shape

    @property
    def sparsity(self) -> float:
        sa, sb = self.a.sparsity, self.b.sparsity
        if self.op is EWOp.ADD:
            return _clamp(sa + sb - sa * sb)
        if self.op is EWOp.MUL:
            return _clamp(sa * sb)
        return sa  # div: nnz(A/B) = nnz(A) (paper Eq. 20)

    def children(self):
        return (self.a, self.b)

    def with_children(self, a, b):
        return ElemWise(a, b, self.op)

    def _label(self):
        return f"ElemWise[{self.op.value}]"


@dataclasses.dataclass(frozen=True)
class MatMul(Expr):
    a: Expr
    b: Expr

    def __post_init__(self):
        if self.a.shape[1] != self.b.shape[0]:
            raise ValueError(
                f"matmul shape mismatch {self.a.shape} x {self.b.shape}")

    @property
    def shape(self) -> Shape:
        return (self.a.shape[0], self.b.shape[1])

    @property
    def sparsity(self) -> float:
        # P(C_ij != 0) = 1 - (1 - s_a s_b)^k under independence (MatFast-style).
        k = self.a.shape[1]
        p = self.a.sparsity * self.b.sparsity
        if p <= 0:
            return 0.0
        if p * k < 1e-3:
            return _clamp(p * k)
        return _clamp(1.0 - (1.0 - p) ** k)

    def children(self):
        return (self.a, self.b)

    def with_children(self, a, b):
        return MatMul(a, b)


@dataclasses.dataclass(frozen=True)
class Inverse(Expr):
    """Matrix inverse (advanced op realized from basic ones, paper §2)."""

    x: Expr

    def __post_init__(self):
        m, n = self.x.shape
        if m != n:
            raise ValueError("inverse needs a square matrix")

    @property
    def shape(self) -> Shape:
        return self.x.shape

    @property
    def sparsity(self) -> float:
        return 1.0  # inverses densify

    def children(self):
        return (self.x,)

    def with_children(self, x):
        return Inverse(x)


@dataclasses.dataclass(frozen=True)
class Select(Expr):
    """Relational select σ_θ(A) (paper §3.2)."""

    x: Expr
    pred: Conjunction

    def __post_init__(self):
        if self.x.order != 2:
            raise ValueError("select currently defined on matrices")

    @property
    def shape(self) -> Shape:
        m, n = self.x.shape
        p = self.pred
        if p.special is not None:
            # dims of rows≠NULL / cols≠NULL are data dependent; statically we
            # report an upper bound (the input dims).
            return (m, n)
        if p.is_diagonal():
            return (min(m, n), 1)
        rr = p.dim_range(Field.RID)
        cr = p.dim_range(Field.CID)
        mm = (rr[1] - rr[0] + 1) if rr else m
        nn = (cr[1] - cr[0] + 1) if cr else n
        return (max(mm, 0), max(nn, 0))

    @property
    def sparsity(self) -> float:
        s = self.x.sparsity
        # value predicates keep qualifying entries (rest become NULL/zero);
        # use a default selectivity of 0.5 per value atom when unknown.
        for _ in self.pred.val_atoms():
            s *= 0.5
        return _clamp(s)

    def children(self):
        return (self.x,)

    def with_children(self, x):
        return Select(x, self.pred)

    def _label(self):
        return f"Select[{self.pred}]"


@dataclasses.dataclass(frozen=True)
class Agg(Expr):
    """Aggregation Γ_{ρ,dim}(A) (paper §3.3)."""

    x: Expr
    fn: AggFn
    dim: AggDim

    def __post_init__(self):
        if self.x.order != 2:
            raise ValueError("aggregation defined on matrices")
        if self.dim is AggDim.DIAG and self.x.shape[0] != self.x.shape[1]:
            raise ValueError("diagonal aggregation needs a square matrix")

    @property
    def shape(self) -> Shape:
        m, n = self.x.shape
        return {
            AggDim.ROW: (m, 1), AggDim.COL: (1, n),
            AggDim.DIAG: (1, 1), AggDim.ALL: (1, 1),
        }[self.dim]

    @property
    def sparsity(self) -> float:
        # aggregated outputs are treated as dense vectors/scalars
        return 1.0 if self.x.sparsity > 0 else 0.0

    def children(self):
        return (self.x,)

    def with_children(self, x):
        return Agg(x, self.fn, self.dim)

    def _label(self):
        return f"Agg[{self.fn.value},{self.dim.value}]"


@dataclasses.dataclass(frozen=True)
class MergeFn:
    """A named, traceable merge function z = f(x, y) for joins (paper §4).

    ``fn`` acts elementwise: on torch tensors (device tier, kernel plain
    versions) and on numpy arrays (host tier). ``name`` keys the
    sparsity-inducing cache.
    """

    name: str
    fn: Callable

    def __call__(self, x, y):
        return self.fn(x, y)


@dataclasses.dataclass(frozen=True)
class Join(Expr):
    """Relational join A ⋈_{γ,f} B over matrix data (paper §4)."""

    a: Expr
    b: Expr
    pred: JoinPred
    merge: MergeFn

    @property
    def shape(self) -> Shape:
        am, an = self.a.shape
        bm, bn = self.b.shape
        k = self.pred.kind
        if k is JoinKind.CROSS or k is JoinKind.V2V:
            return (am, an, bm, bn)
        if k is JoinKind.DIRECT_OVERLAY:
            return (max(am, bm), max(an, bn))  # full-outer overlay (Fig. 4)
        if k is JoinKind.TRANSPOSE_OVERLAY:
            return (max(am, bn), max(an, bm))
        if k is JoinKind.D2D:
            # (D1=matched dim, D2=other dim of A, D3=other dim of B);
            # unequal matched extents inner-join on the overlapping keys
            d1a = am if self.pred.left is Field.RID else an
            d1b = bm if self.pred.right is Field.RID else bn
            d2 = an if self.pred.left is Field.RID else am
            d3 = bn if self.pred.right is Field.RID else bm
            return (min(d1a, d1b), d2, d3)
        # D2V / V2D produce order-4 tensors (§4.6)
        return (am, an, bm, bn)

    @property
    def sparsity(self) -> float:
        sa, sb = self.a.sparsity, self.b.sparsity
        k = self.pred.kind
        if k in (JoinKind.CROSS,):
            return _clamp(sa * sb)
        if k in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
            return _clamp(sa + sb - sa * sb)
        if k is JoinKind.D2D:
            return _clamp(sa * sb)
        # entry joins: matches are rare; a coarse estimate
        return _clamp(sa * sb * 0.1)

    def children(self):
        return (self.a, self.b)

    def with_children(self, a, b):
        return Join(a, b, self.pred, self.merge)

    def _label(self):
        return f"Join[{self.pred}, f={self.merge.name}]"


def cross(a: Expr, b: Expr, merge: MergeFn) -> Join:
    return Join(a, b, JoinPred(JoinKind.CROSS), merge)


# ---------------------------------------------------------------------------
# Tree utilities shared by the rewriter.
# ---------------------------------------------------------------------------

def expr_key(e: Expr, _memo: Optional[dict] = None) -> tuple:
    """Stable structural identity of a plan — the memo-table group key.

    Two trees get the same key iff they are the same logical expression:
    same operator kinds, parameters and child keys. Joins key on the
    ``MergeFn`` itself (name + callable identity): the memo search
    substitutes any group member for any other, and behavioural equality
    of black-box callables is undecidable — probe-point fingerprints
    collide for functions that agree on the probes and differ elsewhere —
    so two merges only share a group when they share the callable.
    (Reusing one ``MergeFn`` across joins is the supported way to let the
    search see them as equal.)
    """
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(e))
    if hit is not None:
        return hit
    if isinstance(e, Leaf):
        params: tuple = (e.name, e.shape, e.sparsity)
    elif isinstance(e, MatScalar):
        params = (e.op, e.beta)
    elif isinstance(e, ElemWise):
        params = (e.op,)
    elif isinstance(e, Select):
        params = (e.pred,)
    elif isinstance(e, Agg):
        params = (e.fn, e.dim)
    elif isinstance(e, Join):
        params = (e.pred, e.merge)
    else:  # Transpose / MatMul / Inverse: structure only
        params = ()
    key = (type(e).__name__, params,
           tuple(expr_key(c, _memo) for c in e.children()))
    _memo[id(e)] = key
    return key


def signature(e: Expr, depth: int = 3) -> str:
    """One-line compact rendering of a plan (EXPLAIN alternative rows)."""
    if depth <= 0:
        return "…"
    if isinstance(e, Leaf):
        return e.name
    if isinstance(e, Transpose):
        return f"{signature(e.x, depth - 1)}ᵀ"
    if isinstance(e, MatScalar):
        return f"({signature(e.x, depth - 1)}{e.op.value}{e.beta:g})"
    if isinstance(e, ElemWise):
        return (f"({signature(e.a, depth - 1)}{e.op.value}"
                f"{signature(e.b, depth - 1)})")
    if isinstance(e, MatMul):
        return f"({signature(e.a, depth - 1)}×{signature(e.b, depth - 1)})"
    if isinstance(e, Inverse):
        return f"inv({signature(e.x, depth - 1)})"
    if isinstance(e, Select):
        return f"σ[{e.pred}]({signature(e.x, depth - 1)})"
    if isinstance(e, Agg):
        return (f"Γ[{e.fn.value},{e.dim.value}]"
                f"({signature(e.x, depth - 1)})")
    if isinstance(e, Join):
        return (f"({signature(e.a, depth - 1)}⋈[{e.pred}]"
                f"{signature(e.b, depth - 1)})")
    return e._label()


def transform_bottom_up(e: Expr, f: Callable[[Expr], Optional[Expr]]) -> Expr:
    """Rebuild the tree bottom-up, applying ``f`` at each node (None = keep)."""
    ch = e.children()
    if ch:
        new_ch = tuple(transform_bottom_up(c, f) for c in ch)
        if new_ch != ch:
            e = e.with_children(*new_ch)
    out = f(e)
    return e if out is None else out


def count_nodes(e: Expr) -> int:
    return 1 + sum(count_nodes(c) for c in e.children())


def leaves(e: Expr):
    if isinstance(e, Leaf):
        yield e
    for c in e.children():
        yield from leaves(c)
