"""Equivalence transformation rules (paper §3, Eqs. 1–25 + matmul rules).

Each rule is a function ``Expr -> Optional[Expr]`` returning a rewritten node
or None when it does not fire. Rules only fire when they are valid (the paper
states validity side conditions, e.g. Rule 5 needs a square matrix, Rule 24/25
need β≠0). Two optimizers consume them: the greedy oracle applies them
bottom-up to a fixed point under a whole-plan flop gate, and the memo search
treats each rule as an *alternative generator* (``iter_alternatives``) whose
candidates are costed through the physical layer and kept per-subtree only
when they win.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

from repro_torch.core.expr import (
    Agg, AggDim, AggFn, ElemWise, EWOp, Expr, Join, Leaf, MatMul, MatScalar,
    Select, Transpose,
)
from repro_torch.core.predicates import Atom, CmpOp, Conjunction, Field

Rule = Callable[[Expr], Optional[Expr]]
_ELEMWISE_PUSHABLE = (EWOp.ADD, EWOp.MUL, EWOp.DIV)


def _swap_fields(pred: Conjunction) -> Conjunction:
    """Swap RID and CID in a selection predicate (for transpose pushdown)."""
    def sw(f):
        return {Field.RID: Field.CID, Field.CID: Field.RID}.get(f, f)
    return Conjunction(
        tuple(Atom(sw(a.lhs), a.op, sw(a.rhs) if isinstance(a.rhs, Field)
                   else a.rhs) for a in pred.atoms),
        special=pred.special,
    )


def _shift_range(pred: Conjunction, field: Field, offset: int) -> Conjunction:
    """Rebase a contiguous dim-range predicate after slicing (lo→0)."""
    atoms = []
    for a in pred.atoms:
        if a.lhs is field and not isinstance(a.rhs, Field):
            atoms.append(Atom(a.lhs, a.op, int(a.rhs) - offset))
        else:
            atoms.append(a)
    return Conjunction(tuple(atoms), special=pred.special)


# ---------------------------------------------------------------------------
# Selection rules (paper §3.2)
# ---------------------------------------------------------------------------

def rule_select_merge(e: Expr) -> Optional[Expr]:
    """Eq. 1: σ_θ1(σ_θ2(A)) = σ_{θ1∧θ2}(A) for entry (val) predicates."""
    if (isinstance(e, Select) and isinstance(e.x, Select)
            and e.pred.is_val_only() and e.x.pred.is_val_only()):
        return Select(e.x.x, e.pred.conjoin(e.x.pred))
    return None


def rule_select_transpose(e: Expr) -> Optional[Expr]:
    """σ_RID=i(Aᵀ) = (σ_CID=i(A))ᵀ (and the CID analog; val preds commute)."""
    if isinstance(e, Select) and isinstance(e.x, Transpose) \
            and e.pred.special is None:
        return Transpose(Select(e.x.x, _swap_fields(e.pred)))
    return None


def rule_select_elemwise(e: Expr) -> Optional[Expr]:
    """σ_dim(A ⋆ B) = σ_dim(A) ⋆ σ_dim(B), ⋆ ∈ {+,*,/} — dims-only preds."""
    if (isinstance(e, Select) and isinstance(e.x, ElemWise)
            and e.pred.is_dims_only() and not e.pred.is_diagonal()):
        return ElemWise(Select(e.x.a, e.pred), Select(e.x.b, e.pred), e.x.op)
    return None


def rule_select_matscalar(e: Expr) -> Optional[Expr]:
    """σ_dim(A op β) = σ_dim(A) op β."""
    if (isinstance(e, Select) and isinstance(e.x, MatScalar)
            and e.pred.is_dims_only() and not e.pred.is_diagonal()):
        return MatScalar(Select(e.x.x, e.pred), e.x.op, e.x.beta)
    return None


def rule_select_matmul(e: Expr) -> Optional[Expr]:
    """σ_RID(A×B) = σ_RID(A)×B;  σ_CID(A×B) = A×σ_CID(B);
    σ_{RID=i ∧ CID=j}(A×B) = σ_RID=i(A) × σ_CID=j(B).

    Valid for point and contiguous-range predicates on the row/column
    dimension (proof in §3.2 generalizes row-wise).
    """
    if not (isinstance(e, Select) and isinstance(e.x, MatMul)):
        return None
    p = e.pred
    if p.special is not None or p.val_atoms() or p.is_diagonal():
        return None
    rr = p.dim_range(Field.RID)
    cr = p.dim_range(Field.CID)
    a, b = e.x.a, e.x.b
    if rr is not None and cr is not None:
        row_p = Conjunction(tuple(x for x in p.atoms if x.lhs is Field.RID))
        col_p = Conjunction(tuple(x for x in p.atoms if x.lhs is Field.CID))
        return MatMul(Select(a, row_p), Select(b, col_p))
    if rr is not None:
        return MatMul(Select(a, p), b)
    if cr is not None:
        return MatMul(a, Select(b, p))
    return None


# ---------------------------------------------------------------------------
# Sum aggregation rules (paper Eqs. 2–11)
# ---------------------------------------------------------------------------

def rule_sum_transpose(e: Expr) -> Optional[Expr]:
    if not (isinstance(e, Agg) and e.fn is AggFn.SUM
            and isinstance(e.x, Transpose)):
        return None
    x = e.x.x
    if e.dim is AggDim.ROW:   # Eq. 2
        return Transpose(Agg(x, AggFn.SUM, AggDim.COL))
    if e.dim is AggDim.COL:
        return Transpose(Agg(x, AggFn.SUM, AggDim.ROW))
    return Agg(x, AggFn.SUM, e.dim)  # Eq. 3 (diag/all)


def rule_sum_matscalar(e: Expr) -> Optional[Expr]:
    """Eqs. 4–6. Γsum(A+β) needs the dimension sizes; Γsum(A*β) scales."""
    if not (isinstance(e, Agg) and e.fn is AggFn.SUM
            and isinstance(e.x, MatScalar)):
        return None
    m, n = e.x.x.shape
    beta, inner = e.x.beta, e.x.x
    if e.x.op is EWOp.MUL:  # Eq. 6
        return MatScalar(Agg(inner, AggFn.SUM, e.dim), EWOp.MUL, beta)
    # op is ADD
    if e.dim is AggDim.ROW:   # Eq. 4: + β·n to each row sum
        return MatScalar(Agg(inner, AggFn.SUM, e.dim), EWOp.ADD, beta * n)
    if e.dim is AggDim.COL:
        return MatScalar(Agg(inner, AggFn.SUM, e.dim), EWOp.ADD, beta * m)
    if e.dim is AggDim.ALL:
        return MatScalar(Agg(inner, AggFn.SUM, e.dim), EWOp.ADD, beta * m * n)
    if e.dim is AggDim.DIAG and m == n:  # Eq. 5 (square only)
        return MatScalar(Agg(inner, AggFn.SUM, e.dim), EWOp.ADD, beta * n)
    return None


def rule_sum_elemwise_add(e: Expr) -> Optional[Expr]:
    """Eq. 7: Γsum(A + B) = Γsum(A) + Γsum(B) (elementwise ADD only)."""
    if (isinstance(e, Agg) and e.fn is AggFn.SUM and isinstance(e.x, ElemWise)
            and e.x.op is EWOp.ADD):
        return ElemWise(Agg(e.x.a, AggFn.SUM, e.dim),
                        Agg(e.x.b, AggFn.SUM, e.dim), EWOp.ADD)
    return None


def rule_sum_matmul(e: Expr) -> Optional[Expr]:
    """Eqs. 8–11: push sums through matrix multiplication."""
    if not (isinstance(e, Agg) and e.fn is AggFn.SUM
            and isinstance(e.x, MatMul)):
        return None
    a, b = e.x.a, e.x.b
    if e.dim is AggDim.ROW:   # Eq. 8
        return MatMul(a, Agg(b, AggFn.SUM, AggDim.ROW))
    if e.dim is AggDim.COL:   # Eq. 9
        return MatMul(Agg(a, AggFn.SUM, AggDim.COL), b)
    if e.dim is AggDim.ALL:   # Eq. 10
        return MatMul(Agg(a, AggFn.SUM, AggDim.COL),
                      Agg(b, AggFn.SUM, AggDim.ROW))
    # Eq. 11 (trace): Γsum,d(A×B) = Γsum,a(Aᵀ ∗ B). The paper states the rule
    # for square inputs, but the identity tr(AB) = Σ_ik A_ik·B_ki only needs
    # A: m×n, B: n×m (the paper's own Fig. 7b applies it to XᵀX with
    # rectangular X); we implement the general conformable case.
    if e.dim is AggDim.DIAG:
        am, an = a.shape
        bm, bn = b.shape
        if am == bn and an == bm:
            return Agg(ElemWise(Transpose(a), b, EWOp.MUL),
                       AggFn.SUM, AggDim.ALL)
    return None


# ---------------------------------------------------------------------------
# Count (nnz) aggregation rules (paper Eqs. 13–20)
# ---------------------------------------------------------------------------

def rule_nnz_transpose(e: Expr) -> Optional[Expr]:
    if not (isinstance(e, Agg) and e.fn is AggFn.NNZ
            and isinstance(e.x, Transpose)):
        return None
    x = e.x.x
    if e.dim is AggDim.ROW:   # Eq. 13
        return Transpose(Agg(x, AggFn.NNZ, AggDim.COL))
    if e.dim is AggDim.COL:
        return Transpose(Agg(x, AggFn.NNZ, AggDim.ROW))
    return Agg(x, AggFn.NNZ, e.dim)  # Eq. 14


def rule_nnz_matscalar(e: Expr) -> Optional[Expr]:
    """Eqs. 15–19 (β≠0). A+β is everywhere nonzero a.s. ⇒ counts are dims."""
    if not (isinstance(e, Agg) and e.fn is AggFn.NNZ
            and isinstance(e.x, MatScalar)):
        return None
    if e.x.beta == 0:
        if e.x.op is EWOp.ADD:  # A+0 = A
            return Agg(e.x.x, AggFn.NNZ, e.dim)
        return None  # A*0: all zeros; handled by constant folding, not here
    if e.x.op is EWOp.MUL:  # Eq. 19
        return Agg(e.x.x, AggFn.NNZ, e.dim)
    m, n = e.x.x.shape
    from repro_torch.core.expr import Leaf as _L  # constants as dense leaves
    if e.dim is AggDim.ROW:   # Eq. 15: e_m * n
        return MatScalar(_L(f"ones({m},1)", (m, 1), 1.0), EWOp.MUL, float(n))
    if e.dim is AggDim.COL:   # Eq. 16
        return MatScalar(_L(f"ones(1,{n})", (1, n), 1.0), EWOp.MUL, float(m))
    if e.dim is AggDim.DIAG and m == n:  # Eq. 17
        return MatScalar(_L("ones(1,1)", (1, 1), 1.0), EWOp.MUL, float(n))
    if e.dim is AggDim.ALL:   # Eq. 18
        return MatScalar(_L("ones(1,1)", (1, 1), 1.0), EWOp.MUL, float(m * n))
    return None


def rule_nnz_elemwise_div(e: Expr) -> Optional[Expr]:
    """Eq. 20: Γnnz(A / B) = Γnnz(A)."""
    if (isinstance(e, Agg) and e.fn is AggFn.NNZ and isinstance(e.x, ElemWise)
            and e.x.op is EWOp.DIV):
        return Agg(e.x.a, AggFn.NNZ, e.dim)
    return None


# ---------------------------------------------------------------------------
# Avg / Max / Min rules (paper §3.3, Eqs. 21–25)
# ---------------------------------------------------------------------------

def rule_avg_decompose(e: Expr) -> Optional[Expr]:
    """Γavg = Γsum / Γnnz; lets sum/count rules optimize each side."""
    if isinstance(e, Agg) and e.fn is AggFn.AVG:
        return ElemWise(Agg(e.x, AggFn.SUM, e.dim),
                        Agg(e.x, AggFn.NNZ, e.dim), EWOp.DIV)
    return None


def rule_extrema_transpose(e: Expr) -> Optional[Expr]:
    """Eqs. 21–22."""
    if not (isinstance(e, Agg) and e.fn in (AggFn.MAX, AggFn.MIN)
            and isinstance(e.x, Transpose)):
        return None
    x = e.x.x
    if e.dim is AggDim.ROW:
        return Transpose(Agg(x, e.fn, AggDim.COL))
    if e.dim is AggDim.COL:
        return Transpose(Agg(x, e.fn, AggDim.ROW))
    return Agg(x, e.fn, e.dim)


def rule_extrema_matscalar(e: Expr) -> Optional[Expr]:
    """Eqs. 23–25: push through A+β; A*β flips max↔min when β<0.

    Validity subtlety the paper leaves implicit: under the sparse relational
    semantics (absent ≡ 0, aggregates skip absent entries), Eq. 23 is only
    sound for DENSE inputs — A+β materializes a value at every previously
    absent cell, so Γmax(A+β) can be β while Γmax(A)+β is max(nonzeros)+β.
    Found by the hypothesis equivalence property; we gate the ADD case on
    a dense input. A∗β maps 0→0 (absent stays absent) and is always safe.
    """
    if not (isinstance(e, Agg) and e.fn in (AggFn.MAX, AggFn.MIN)
            and isinstance(e.x, MatScalar)):
        return None
    beta, inner = e.x.beta, e.x.x
    if e.x.op is EWOp.ADD:  # Eq. 23 (dense inputs only — see docstring)
        if inner.sparsity < 1.0:
            return None
        return MatScalar(Agg(inner, e.fn, e.dim), EWOp.ADD, beta)
    if beta > 0:            # Eq. 24
        return MatScalar(Agg(inner, e.fn, e.dim), EWOp.MUL, beta)
    if beta < 0:            # Eq. 25
        other = AggFn.MIN if e.fn is AggFn.MAX else AggFn.MAX
        return MatScalar(Agg(inner, other, e.dim), EWOp.MUL, beta)
    return None


# ---------------------------------------------------------------------------
# Agg ↔ Select commutation (paper Rule 12 discussion): valid only when the
# aggregation direction matches the select dimension.
# ---------------------------------------------------------------------------

def rule_agg_select_same_dim(e: Expr) -> Optional[Expr]:
    """Γρ,r(σ_RID=i(A)) = σ_RID=i(Γρ,r(A)) — we canonicalize to select-first
    (inner select), which shrinks the aggregated matrix."""
    if not (isinstance(e, Agg) and isinstance(e.x, Select)):
        return None
    return None  # select already inner: canonical; rule kept for completeness


def rule_select_agg_same_dim(e: Expr) -> Optional[Expr]:
    """σ_RID=i(Γρ,r(A)) → Γρ,r(σ_RID=i(A)): push the select below the agg
    when both operate on the same dimension (the valid case of Rule 12)."""
    if not (isinstance(e, Select) and isinstance(e.x, Agg)):
        return None
    agg = e.x
    p = e.pred
    if p.special is not None or p.val_atoms() or p.is_diagonal():
        return None
    rr = p.dim_range(Field.RID)
    cr = p.dim_range(Field.CID)
    if agg.dim is AggDim.ROW and rr is not None and cr is None:
        return Agg(Select(agg.x, p), agg.fn, agg.dim)
    if agg.dim is AggDim.COL and cr is not None and rr is None:
        return Agg(Select(agg.x, p), agg.fn, agg.dim)
    return None


# ---------------------------------------------------------------------------
# Structural cleanups.
# ---------------------------------------------------------------------------

def rule_double_transpose(e: Expr) -> Optional[Expr]:
    if isinstance(e, Transpose) and isinstance(e.x, Transpose):
        return e.x.x
    return None


def rule_transpose_matmul(e: Expr) -> Optional[Expr]:
    """(A×B)ᵀ = Bᵀ×Aᵀ — enables further pushdowns; cost-gated upstream."""
    if isinstance(e, Transpose) and isinstance(e.x, MatMul):
        return MatMul(Transpose(e.x.b), Transpose(e.x.a))
    return None


def rule_scalar_fold(e: Expr) -> Optional[Expr]:
    """Fold (A op β1) op β2 chains of the same op."""
    if isinstance(e, MatScalar) and isinstance(e.x, MatScalar) \
            and e.op is e.x.op:
        if e.op is EWOp.ADD:
            return MatScalar(e.x.x, EWOp.ADD, e.beta + e.x.beta)
        if e.op is EWOp.MUL:
            return MatScalar(e.x.x, EWOp.MUL, e.beta * e.x.beta)
    return None


# ---------------------------------------------------------------------------
# Rule-as-generator contract (memo search).
#
# The memo optimizer does not commit rewrites greedily: every rule is an
# *alternative generator* that yields zero or more candidate rewrites of
# the root of ``e``, each tagged with the rule name; the search costs
# every candidate through the physical layer and keeps the cheapest group
# member. Plain ``Expr -> Optional[Expr]`` rules are lifted inline by
# ``iter_alternatives`` (their validity side conditions carry over
# unchanged — a rule that does not fire yields nothing); genuinely
# multi-output generators (e.g. matmul reassociation, which is an
# equivalence not an improvement, so it must never be greedily committed)
# are written natively and listed in ``SEARCH_ONLY_GENERATORS``.
# ---------------------------------------------------------------------------

AltGen = Callable[[Expr], Iterator[Tuple[str, Expr]]]


def gen_matmul_reassociate(e: Expr) -> Iterator[Tuple[str, Expr]]:
    """(A×B)×C ↔ A×(B×C): both rotations, always shape-valid.

    Greedy application would loop; under the memo search the group's
    ``seen`` set closes the orbit and the cost model picks the cheapest
    association (the bounded local form of the matrix-chain DP).
    """
    if not isinstance(e, MatMul):
        return
    if isinstance(e.a, MatMul):
        yield "gen_matmul_reassociate", MatMul(e.a.a, MatMul(e.a.b, e.b))
    if isinstance(e.b, MatMul):
        yield "gen_matmul_reassociate", MatMul(MatMul(e.a, e.b.a), e.b.b)


def iter_alternatives(e: Expr, extra: Tuple[AltGen, ...] = (),
                      rules: Optional[List[Rule]] = None,
                      search_only: bool = True
                      ) -> Iterator[Tuple[str, Expr]]:
    """All candidate rewrites of the root of ``e`` (the generator contract).

    ``rules`` overrides the rule set (None → ``ALL_RULES``; the memo
    search passes ``[]`` when pushdowns are disabled), ``search_only``
    gates the native equivalence generators (reassociation — chain
    reordering in search form).
    """
    for rule in (ALL_RULES if rules is None else rules):
        out = rule(e)
        if out is not None:
            yield rule.__name__, out
    gens = (SEARCH_ONLY_GENERATORS if search_only else []) + list(extra)
    for gen in gens:
        yield from gen(e)


ALL_RULES: List[Rule] = [
    rule_select_merge,
    rule_select_transpose,
    rule_select_elemwise,
    rule_select_matscalar,
    rule_select_matmul,
    rule_select_agg_same_dim,
    rule_sum_transpose,
    rule_sum_matscalar,
    rule_sum_elemwise_add,
    rule_sum_matmul,
    rule_nnz_transpose,
    rule_nnz_matscalar,
    rule_nnz_elemwise_div,
    rule_avg_decompose,
    rule_extrema_transpose,
    rule_extrema_matscalar,
    rule_double_transpose,
    # (A×B)ᵀ = Bᵀ×Aᵀ enables transpose-side pushdowns but can REGRESS
    # (two factor-sized transposes replace one output-sized one): under
    # the greedy fixpoint only the whole-plan gate protects against it —
    # all-or-nothing — while the memo search accepts/rejects it per
    # subtree on physical cost. New to ALL_RULES in the memo PR.
    rule_transpose_matmul,
    rule_scalar_fold,
]

SEARCH_ONLY_GENERATORS: List[AltGen] = [
    gen_matmul_reassociate,
]
