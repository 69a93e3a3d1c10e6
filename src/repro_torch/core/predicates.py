"""Selection and join predicate algebra over the matrix relational schema.

Every matrix is cast as a relation ``matrixA(RID, CID, val)`` (paper §3.1).
Selection predicates are propositional formulas over atoms ``u φ c`` / ``u φ v``
with u, v ∈ {RID, CID, val} and φ ∈ {<, <=, =, !=, >=, >} (paper §3.2).

Join predicates are restricted to equality conjunctions (paper §4.1) and are
classified into the five families the paper optimizes: cross product, join on
two dimensions (direct / transpose overlay), join on a single dimension (D2D),
join on entries (V2V) and mixed dimension/entry joins (D2V / V2D).
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional, Sequence, Tuple, Union


class Field(enum.Enum):
    RID = "RID"
    CID = "CID"
    VAL = "VAL"


class CmpOp(enum.Enum):
    LT = "<"
    LE = "<="
    EQ = "="
    NE = "!="
    GE = ">="
    GT = ">"

    def flip(self) -> "CmpOp":
        return {
            CmpOp.LT: CmpOp.GT, CmpOp.LE: CmpOp.GE, CmpOp.EQ: CmpOp.EQ,
            CmpOp.NE: CmpOp.NE, CmpOp.GE: CmpOp.LE, CmpOp.GT: CmpOp.LT,
        }[self]

    def eval(self, a, b):
        import numpy as np
        return {
            CmpOp.LT: np.less, CmpOp.LE: np.less_equal, CmpOp.EQ: np.equal,
            CmpOp.NE: np.not_equal, CmpOp.GE: np.greater_equal,
            CmpOp.GT: np.greater,
        }[self](a, b)


@dataclasses.dataclass(frozen=True)
class Atom:
    """``lhs op rhs`` where lhs is a Field and rhs is a Field or a constant."""

    lhs: Field
    op: CmpOp
    rhs: Union[Field, float, int]

    def __str__(self) -> str:
        rhs = self.rhs.value if isinstance(self.rhs, Field) else self.rhs
        return f"{self.lhs.value}{self.op.value}{rhs}"

    @property
    def rhs_is_field(self) -> bool:
        return isinstance(self.rhs, Field)

    def on_dims_only(self) -> bool:
        return self.lhs is not Field.VAL and not (
            self.rhs_is_field and self.rhs is Field.VAL
        )

    def on_val_only(self) -> bool:
        return self.lhs is Field.VAL and not self.rhs_is_field


# Special whole-row / whole-column predicates (paper §3.2): σ_rows≠NULL and
# σ_cols≠NULL drop all-empty rows / columns.
class SpecialPred(enum.Enum):
    ROWS_NONNULL = "rows!=NULL"
    COLS_NONNULL = "cols!=NULL"


@dataclasses.dataclass(frozen=True)
class Conjunction:
    """A conjunction of atoms (the fragment the rewrite rules operate on).

    General boolean formulas are supported at execution time via `Or`/`Not`
    wrappers, but the paper's transformation rules (Eqs. 1 and the pushdowns)
    are stated over conjunctions, so the optimizer normalizes into this form
    whenever possible.
    """

    atoms: Tuple[Atom, ...] = ()
    special: Optional[SpecialPred] = None

    def __str__(self) -> str:
        if self.special is not None:
            return self.special.value
        return " AND ".join(str(a) for a in self.atoms) or "TRUE"

    # --- structure queries used by the rewrite rules -----------------------
    def conjoin(self, other: "Conjunction") -> "Conjunction":
        if self.special or other.special:
            raise ValueError("cannot conjoin special predicates")
        return Conjunction(self.atoms + other.atoms)

    def val_atoms(self) -> Tuple[Atom, ...]:
        return tuple(a for a in self.atoms if not a.on_dims_only())

    def dim_atoms(self) -> Tuple[Atom, ...]:
        return tuple(a for a in self.atoms if a.on_dims_only())

    def is_val_only(self) -> bool:
        return self.special is None and all(a.on_val_only() for a in self.atoms)

    def is_dims_only(self) -> bool:
        return self.special is None and all(a.on_dims_only() for a in self.atoms)

    def eq_dim(self, field: Field) -> Optional[int]:
        """Return i if the predicate contains ``field = i`` (a point select)."""
        for a in self.atoms:
            if a.lhs is field and a.op is CmpOp.EQ and not a.rhs_is_field:
                return int(a.rhs)
            if (a.rhs_is_field and a.rhs is field and a.op is CmpOp.EQ
                    and a.lhs is not Field.VAL):
                # normalized away in practice; defensive
                return None
        return None

    def dim_range(self, field: Field) -> Optional[Tuple[int, int]]:
        """Return inclusive [lo, hi] if atoms constrain ``field`` to a range.

        Covers point selects (lo == hi) and ``field >= a AND field <= b``
        combinations (paper: σ_{RID>=i1 ∧ RID<=i2}).
        """
        lo, hi = None, None
        seen = False
        for a in self.atoms:
            if a.lhs is not field or a.rhs_is_field:
                continue
            c = int(a.rhs)
            seen = True
            if a.op is CmpOp.EQ:
                lo = c if lo is None else max(lo, c)
                hi = c if hi is None else min(hi, c)
            elif a.op is CmpOp.GE:
                lo = c if lo is None else max(lo, c)
            elif a.op is CmpOp.GT:
                lo = c + 1 if lo is None else max(lo, c + 1)
            elif a.op is CmpOp.LE:
                hi = c if hi is None else min(hi, c)
            elif a.op is CmpOp.LT:
                hi = c - 1 if hi is None else min(hi, c - 1)
            else:
                return None  # != on a dim: not a contiguous range
        if not seen:
            return None
        return (lo, hi)

    def mentions(self, field: Field) -> bool:
        return any(
            a.lhs is field or (a.rhs_is_field and a.rhs is field)
            for a in self.atoms
        )

    def is_diagonal(self) -> bool:
        """RID = CID (selects the diagonal; paper §3.2)."""
        return any(
            a.op is CmpOp.EQ and a.rhs_is_field
            and {a.lhs, a.rhs} == {Field.RID, Field.CID}
            for a in self.atoms
        )


# ---------------------------------------------------------------------------
# Join predicates (paper §4).
# ---------------------------------------------------------------------------

class JoinKind(enum.Enum):
    CROSS = "cross"                      # §4.2: empty predicate, order-4 output
    DIRECT_OVERLAY = "direct_overlay"    # §4.3: RID=RID AND CID=CID
    TRANSPOSE_OVERLAY = "transpose_overlay"  # §4.3: RID=CID AND CID=RID
    D2D = "d2d"                          # §4.4: single dimension equality
    V2V = "v2v"                          # §4.5: val = val
    D2V = "d2v"                          # §4.6: dim_A = val_B
    V2D = "v2d"                          # §4.6: val_A = dim_B


@dataclasses.dataclass(frozen=True)
class JoinPred:
    kind: JoinKind
    # For D2D: which dim of A equals which dim of B. For D2V: (dim of A, VAL).
    # For V2D: (VAL, dim of B).
    left: Optional[Field] = None
    right: Optional[Field] = None

    def __str__(self) -> str:
        if self.kind is JoinKind.CROSS:
            return "CROSS"
        if self.kind is JoinKind.DIRECT_OVERLAY:
            return "RID=RID AND CID=CID"
        if self.kind is JoinKind.TRANSPOSE_OVERLAY:
            return "RID=CID AND CID=RID"
        return f"{self.left.value}={self.right.value}"

    @property
    def n_dim_eqs(self) -> int:
        """δ_dim: number of equality predicates on join dimensions (§4.1)."""
        return {
            JoinKind.CROSS: 0, JoinKind.V2V: 0, JoinKind.D2V: 0,
            JoinKind.V2D: 0, JoinKind.D2D: 1,
            JoinKind.DIRECT_OVERLAY: 2, JoinKind.TRANSPOSE_OVERLAY: 2,
        }[self.kind]

    @property
    def output_order(self) -> int:
        """Order of the join output tensor: d = 4 − δ_dim (paper §4.1)."""
        return 4 - self.n_dim_eqs


# ---------------------------------------------------------------------------
# Parsers (string syntax mirrors the paper's Scala snippets, Codes 2/4/5).
# ---------------------------------------------------------------------------

_ATOM_RE = re.compile(
    r"\s*(RID|CID|VAL|val)\s*(<=|>=|!=|=|<|>)\s*"
    r"(RID|CID|VAL|val|[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)\s*",
)


def _parse_atom(text: str) -> Atom:
    m = _ATOM_RE.fullmatch(text)
    if not m:
        raise ValueError(f"cannot parse predicate atom: {text!r}")
    lhs = Field(m.group(1).upper())
    op = CmpOp(m.group(2))
    rhs_raw = m.group(3)
    if rhs_raw.upper() in ("RID", "CID", "VAL"):
        rhs: Union[Field, float] = Field(rhs_raw.upper())
    else:
        rhs = float(rhs_raw) if "." in rhs_raw or "e" in rhs_raw.lower() \
            else int(rhs_raw)
    # Normalize constant-on-left / field-on-right orientation.
    if isinstance(rhs, Field) and lhs is Field.VAL and rhs is not Field.VAL:
        lhs, rhs, op = rhs, Field.VAL, op.flip()
    return Atom(lhs, op, rhs)


def parse_select(text: str) -> Conjunction:
    """Parse e.g. ``"RID=1 AND CID=1"``, ``"VAL>0.5"``, ``"rows != NULL"``."""
    squeezed = text.strip().lower().replace(" ", "")
    if squeezed == "rows!=null":
        return Conjunction(special=SpecialPred.ROWS_NONNULL)
    if squeezed == "cols!=null":
        return Conjunction(special=SpecialPred.COLS_NONNULL)
    parts = re.split(r"\s+AND\s+", text.strip(), flags=re.IGNORECASE)
    return Conjunction(tuple(_parse_atom(p) for p in parts))


def parse_join(text: str) -> JoinPred:
    """Parse join predicates, e.g. ``"RID=RID AND CID=CID"`` or ``"VAL=VAL"``.

    The left side of each equality refers to the left matrix, the right side
    to the right matrix (mirroring ``JoinType.parse`` in the paper's API).
    """
    text = text.strip()
    if text.upper() in ("", "CROSS"):
        return JoinPred(JoinKind.CROSS)
    parts = [p.strip() for p in re.split(r"\s+AND\s+", text, flags=re.IGNORECASE)]
    eqs = []
    for p in parts:
        m = re.fullmatch(r"(RID|CID|VAL)\s*=\s*(RID|CID|VAL)", p, re.IGNORECASE)
        if not m:
            raise ValueError(f"unsupported join predicate: {p!r}")
        eqs.append((Field(m.group(1).upper()), Field(m.group(2).upper())))
    if len(eqs) == 2:
        s = frozenset(eqs)
        if s == {(Field.RID, Field.RID), (Field.CID, Field.CID)}:
            return JoinPred(JoinKind.DIRECT_OVERLAY)
        if s == {(Field.RID, Field.CID), (Field.CID, Field.RID)}:
            return JoinPred(JoinKind.TRANSPOSE_OVERLAY)
        raise ValueError(f"unsupported two-predicate join: {text!r}")
    if len(eqs) != 1:
        raise ValueError(f"joins take 1 or 2 equality predicates: {text!r}")
    (l, r), = eqs
    if l is Field.VAL and r is Field.VAL:
        return JoinPred(JoinKind.V2V, Field.VAL, Field.VAL)
    if l is Field.VAL:
        return JoinPred(JoinKind.V2D, Field.VAL, r)
    if r is Field.VAL:
        return JoinPred(JoinKind.D2V, l, Field.VAL)
    return JoinPred(JoinKind.D2D, l, r)
