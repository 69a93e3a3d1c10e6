"""Merge functions as op codes and programs the CUDA kernels evaluate.

The JAX package traces any Python merge callable into its kernel bodies;
a compiled CUDA kernel cannot. This module compiles a merge once, on the
host, into one of three codes:

* ``BILINEAR`` with coefficients (c0, cx, cy, cxy): the merge evaluated
  on a symbolic proxy that tracks a polynomial in ``x`` and ``y`` with
  terms {1, x, y, xy} — ``x*y``, ``x+y``, ``x-y``, ``left`` (``x``),
  affine mixes such as ``2xy+x``, and division by a power of two;
* ``SAFE_DIV``, the named safe division (``core.sparsity.safe_div``):
  ``x == 0 ? 0 : x / (y == 0 ? 1 : y)``;
* ``PROGRAM`` for every other merge within the op set below: the merge is
  traced once on two symbolic operands (``_Sym``: the Python operators
  and ``__torch_function__``), equal nodes are merged, and the DAG is
  lowered to a register program of at most ``MAX_CODE`` instructions over
  ``N_REGS`` registers and ``MAX_CONSTS`` constants (kept in double). The
  kernels run it with an interpreter (``csrc/merge.cuh``).

The op set is what the JAX package's merges use: ``+ - * /``, unary
``-``, ``abs``, ``**``/``torch.pow`` (a constant or operand exponent),
``torch.square``, ``torch.reciprocal``, ``< <= > >= == !=``, ``& | ~``
and ``torch.logical_and/or/not`` on booleans, ``torch.where``,
``torch.maximum``/``minimum`` (``torch.max``/``min`` of two tensors),
``torch.clamp``/``clip``/``clamp_min``/``clamp_max``, ``torch.sign``,
``torch.exp``, ``log``, ``log1p``, ``expm1``, ``sqrt``, ``rsqrt``,
``tanh`` and ``sigmoid`` (also as tensor methods). Constants are Python
numbers and bools, and 0-d tensors.

Types follow torch's promotion as the plain versions see it. Registers
hold the value type ``T`` of the operands; comparisons give 0/1, which
arithmetic with an operand promotes to ``T``. The result is cast to
``T``, as ``merge_join_plain``'s ``merge(a, b).to(a.dtype)`` does. What
torch would keep in another type (arithmetic on booleans or constants
alone: bool, int64 or the default float32) is refused, except
``torch.where(cond, c1, c2)`` of two constants, whose float32 or int64
values are exact in ``T``. Powers are lowered as torch computes them, so
that the bits match: ``x**2`` is ``x*x``, ``x**3`` ``x*x*x``, ``x**-1``
``1/x``, ``x**-2`` ``1/(x*x)``, ``x**0.5`` ``sqrt``, ``x**-0.5``
``rsqrt``, ``x**0`` 1 and ``x**1`` ``x``; other exponents run ``pow``.
A bound of ``clamp`` that is a constant keeps clamp's own rule, one that
is an operand is ``maximum``/``minimum`` (as torch computes it).

``merge_code`` raises ``NotImplementedError``, naming the cause, for an
op outside the set, a Python branch on a value (``bool`` of a symbol; the
JAX package's tracer raises there too), a tensor constant that is not
0-d, and a program over the limits. ``registry.REFUSALS`` counts these as
refusals that feed no breaker. The plain PyTorch versions take any
callable. ``evaluate(code, x, y)`` runs a code with torch ops on the
host: the CPU tests hold it to the merge itself.

Codes are cached per merge callable (not per ``MergeFn.name``: every
lambda handed to ``Matrix.join`` is named ``"f"``, and two different
lambdas must not share a code). The cache holds the callable weakly and
nothing in an entry refers back to it, so an entry dies with its
callable and a later lambda at the same address is compiled anew.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.expr import MergeFn

BILINEAR = 0
SAFE_DIV = 1
PROGRAM = 2

# the program's limits (csrc/merge.cuh: kProgCode, kProgRegs, kProgConsts)
MAX_CODE = 32
N_REGS = 8
MAX_CONSTS = 16

# instruction op codes (csrc/merge.cuh: the PROG_* constants)
(MOV, ADD, SUB, MUL, DIV, NEG, ABS, LT, LE, GT, GE, EQ, NE, AND, OR, NOT,
 WHERE, MAX, MIN, CLAMP_MIN, CLAMP_MAX, SIGN, EXP, LOG, LOG1P, EXPM1, SQRT,
 RSQRT, TANH, SIGMOID, POW) = range(31)

# an instruction's operand slot: 0..N_REGS-1 a register, N_REGS + k the
# constant k; the ops' operand counts (the others take two)
_ARITY = {MOV: 1, NEG: 1, ABS: 1, NOT: 1, SIGN: 1, EXP: 1, LOG: 1,
          LOG1P: 1, EXPM1: 1, SQRT: 1, RSQRT: 1, TANH: 1, SIGMOID: 1,
          WHERE: 3}


class _ProgramC(ctypes.Structure):
    """``struct MergeProgram`` of ``csrc/merge.cuh``, as the launchers take
    it (by pointer; they pass it on to the kernel by value)."""
    _fields_ = [("n", ctypes.c_int),
                ("code", ctypes.c_uint32 * MAX_CODE),
                ("consts", ctypes.c_double * MAX_CONSTS)]


@dataclasses.dataclass(frozen=True)
class MergeCode:
    op: int
    coeffs: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    # PROGRAM: instructions (op, dst, a, b, c) and the constant table
    code: Tuple[Tuple[int, int, int, int, int], ...] = ()
    consts: Tuple[float, ...] = ()

    @functools.cached_property
    def program(self) -> Optional[_ProgramC]:
        """The host struct of a ``PROGRAM`` (None for the other codes)."""
        if self.op != PROGRAM:
            return None
        p = _ProgramC()
        p.n = len(self.code)
        for i, (op, d, a, b, c) in enumerate(self.code):
            p.code[i] = op | d << 6 | a << 9 | b << 14 | c << 19
        for i, k in enumerate(self.consts):
            p.consts[i] = k
        return p

    def program_ptr(self) -> Optional[int]:
        """The address of ``program`` for a launcher (None: no program)."""
        p = self.program
        return None if p is None else ctypes.addressof(p)


# ---------------------------------------------------------------------------
# The bilinear fast path
# ---------------------------------------------------------------------------

class _NotBilinear(Exception):
    pass


class _Poly:
    """c0 + cx·x + cy·y + cxy·xy; any other term raises ``_NotBilinear``."""

    __slots__ = ("c",)

    def __init__(self, c0=0.0, cx=0.0, cy=0.0, cxy=0.0):
        self.c = (float(c0), float(cx), float(cy), float(cxy))

    @staticmethod
    def _lift(o) -> "_Poly":
        if isinstance(o, _Poly):
            return o
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            return _Poly(o)
        raise _NotBilinear(type(o))

    def __add__(self, o):
        o = self._lift(o)
        return _Poly(*(a + b for a, b in zip(self.c, o.c)))

    __radd__ = __add__

    def __neg__(self):
        return _Poly(*(-a for a in self.c))

    def __pos__(self):
        return self

    def __sub__(self, o):
        return self + (-self._lift(o))

    def __rsub__(self, o):
        return self._lift(o) + (-self)

    def __mul__(self, o):
        o = self._lift(o)
        a0, ax, ay, axy = self.c
        b0, bx, by, bxy = o.c
        # x², y², x²y, xy², x²y² are outside the family
        if (ax and bx) or (ay and by) or (axy and (bx or by or bxy)) \
                or (bxy and (ax or ay)):
            raise _NotBilinear("degree")
        return _Poly(a0 * b0, a0 * bx + ax * b0, a0 * by + ay * b0,
                     a0 * bxy + axy * b0 + ax * by + ay * bx)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, _Poly):
            if any(o.c[1:]):
                raise _NotBilinear("division by a variable")
            o = o.c[0]
        # only a power of two has an exact reciprocal: x / 3 is not
        # x * (1/3) in floating point, so it goes to a program's division
        if not isinstance(o, (int, float)) or isinstance(o, bool) \
                or o == 0 or not math.isfinite(o) \
                or abs(math.frexp(o)[0]) != 0.5:
            raise _NotBilinear("division")
        return self * (1.0 / o)


# ---------------------------------------------------------------------------
# The tracer: symbolic operands recording an expression DAG
# ---------------------------------------------------------------------------

class _Refused(Exception):
    """A merge the compiler cannot take; the message names the cause."""


# node kinds: the operands' value type, a comparison's bool, and the
# float32 / int64 of torch.where over two constants
_VAL, _BOOL, _F32, _INT = "value", "bool", "float32", "int64"


class _Graph:
    """Hash-consed nodes: ("x",), ("y",), ("k", float), (op, ids...)."""

    def __init__(self):
        self.nodes: List[tuple] = []
        self._index: Dict[tuple, int] = {}

    def node(self, key: tuple) -> int:
        # constants are keyed by their bits: -0.0 == 0.0 and nan != nan
        # as floats
        hkey = key if key[0] != "k" else ("k", float(key[1]).hex())
        nid = self._index.get(hkey)
        if nid is None:
            nid = self._index[hkey] = len(self.nodes)
            self.nodes.append(key)
        return nid


def _const_value(o) -> Optional[Tuple[float, bool]]:
    """(value, is an integer or bool) of a constant operand, None for a
    non-constant; raises for a tensor constant that is not 0-d."""
    if isinstance(o, bool):
        return float(o), True
    if isinstance(o, int):
        return float(o), True
    if isinstance(o, float):
        return o, False
    if isinstance(o, torch.Tensor):
        if o.ndim != 0:
            raise _Refused(f"a tensor constant of shape {tuple(o.shape)} "
                           "(only 0-d tensor constants)")
        if o.is_complex():
            raise _Refused("a complex constant")
        return float(o.item()), not o.is_floating_point()
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return float(o), not isinstance(o, np.floating)
    return None


class _Sym:
    """A symbolic operand of the merge being traced."""

    __slots__ = ("g", "id", "kind")

    def __init__(self, g: _Graph, nid: int, kind: str):
        self.g, self.id, self.kind = g, nid, kind

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _torch_call(func, args, dict(kwargs or {}))

    # Python operators ----------------------------------------------------
    def __add__(self, o): return _arith(ADD, self, o)
    def __radd__(self, o): return _arith(ADD, o, self)
    def __sub__(self, o): return _arith(SUB, self, o)
    def __rsub__(self, o): return _arith(SUB, o, self)
    def __mul__(self, o): return _arith(MUL, self, o)
    def __rmul__(self, o): return _arith(MUL, o, self)
    def __truediv__(self, o): return _arith(DIV, self, o)
    def __rtruediv__(self, o): return _arith(DIV, o, self)
    def __pow__(self, o): return _pow(self, o)
    def __rpow__(self, o): return _pow(o, self)
    def __neg__(self): return _arith(NEG, self)
    def __pos__(self): return _arith(MOV, self)
    def __abs__(self): return _arith(ABS, self)
    def __lt__(self, o): return _compare(LT, self, o)
    def __le__(self, o): return _compare(LE, self, o)
    def __gt__(self, o): return _compare(GT, self, o)
    def __ge__(self, o): return _compare(GE, self, o)
    def __eq__(self, o): return _compare(EQ, self, o)
    def __ne__(self, o): return _compare(NE, self, o)
    def __and__(self, o): return _logic(AND, self, o, bitwise=True)
    def __rand__(self, o): return _logic(AND, o, self, bitwise=True)
    def __or__(self, o): return _logic(OR, self, o, bitwise=True)
    def __ror__(self, o): return _logic(OR, o, self, bitwise=True)
    def __invert__(self): return _logic(NOT, self, bitwise=True)

    __hash__ = object.__hash__

    def __bool__(self):
        raise _Refused("a Python branch on a value (bool() of a traced "
                       "operand)")

    def __float__(self):
        raise _Refused("a Python number taken from a value (float() of a "
                       "traced operand)")

    __int__ = __index__ = __float__

    def __getattr__(self, name):
        fn = _METHODS.get(name)
        if fn is None:
            if name.startswith("__"):
                raise AttributeError(name)
            raise _Refused(f"the tensor method {name!r}")
        return functools.partial(fn, self)


def _syms(args) -> List[_Sym]:
    return [a for a in args if isinstance(a, _Sym)]


def _operand(g: _Graph, o, f32: bool) -> int:
    """The node of a symbol or a constant; a constant in a float32 context
    is rounded to float32 first, as torch computes it there."""
    if isinstance(o, _Sym):
        if o.g is not g:
            raise _Refused("operands of two different traces")
        return o.id
    cv = _const_value(o)
    if cv is None:
        raise _Refused(f"an operand of type {type(o).__name__}")
    v, integral = cv
    if f32 and not integral:
        v = float(np.float32(v))
    return g.node(("k", v))


def _emit(op: int, kind: str, *operands) -> _Sym:
    g = _syms(operands)[0].g
    f32 = kind != _VAL
    ids = [_operand(g, o, f32) for o in operands]
    if op == MOV:
        return _Sym(g, ids[0], kind)
    return _Sym(g, g.node((op, *ids)), kind)


def _arith(op: int, *operands) -> _Sym:
    """Arithmetic (and the max/min/clamp family): computed in the value
    type, so at least one operand must be of it."""
    kinds = {s.kind for s in _syms(operands)}
    if _VAL not in kinds:
        raise _Refused("arithmetic without a value operand (torch keeps "
                       "booleans and constants in bool, int64 or float32)")
    return _emit(op, _VAL, *operands)


def _compare(op: int, a, b) -> _Sym:
    # without a value operand torch compares in float32 (or int64)
    kinds = {s.kind for s in _syms((a, b))}
    return _as_bool(_emit(op, _VAL if _VAL in kinds else _F32, a, b))


def _as_bool(s: _Sym) -> _Sym:
    return _Sym(s.g, s.id, _BOOL)


def _logic(op: int, *operands, bitwise: bool = False) -> _Sym:
    if bitwise:
        for o in operands:
            kind = o.kind if isinstance(o, _Sym) else (
                _BOOL if isinstance(o, (bool, np.bool_)) or (
                    isinstance(o, torch.Tensor)
                    and o.dtype == torch.bool) else _VAL)
            if kind != _BOOL:
                raise _Refused("a bitwise & | ~ of a non-boolean (use "
                               "them on comparisons)")
    return _as_bool(_emit(op, _F32, *operands))


def _where(cond, a, b) -> _Sym:
    if not isinstance(cond, _Sym) or cond.kind != _BOOL:
        raise _Refused("torch.where with a condition that is not a traced "
                       "comparison")
    kinds = [o.kind if isinstance(o, _Sym) else None for o in (a, b)]
    if _VAL in kinds:
        return _emit(WHERE, _VAL, cond, a, b)
    if kinds == [_BOOL, _BOOL]:
        return _as_bool(_emit(WHERE, _F32, cond, a, b))
    if kinds == [None, None]:
        integral = all(_const_value(o)[1] for o in (a, b))
        s = _emit(WHERE, _F32, cond, a, b)
        return _Sym(s.g, s.id, _INT if integral else _F32)
    raise _Refused("torch.where mixing a boolean or a constant-valued "
                   "branch with a constant")


def _pow(base, exp) -> _Sym:
    """Powers as torch computes them (``aten``'s pow kernels special-case
    these exponents of a Python number), so the bits match; a tensor
    exponent, 0-d too, is torch's tensor-tensor ``pow``."""
    if isinstance(exp, (_Sym, torch.Tensor)):
        return _arith(POW, base, exp)
    cv = _const_value(exp)
    if cv is None:
        raise _Refused(f"an exponent of type {type(exp).__name__}")
    if not isinstance(base, _Sym):
        raise _Refused("a power of two constants")
    e = cv[0]
    if base.kind != _VAL:
        raise _Refused("a power of a boolean or constant-valued node")
    if e == 0:
        return _Sym(base.g, base.g.node(("k", 1.0)), _VAL)
    if e == 1:
        return base
    if e == 2:
        return _arith(MUL, base, base)
    if e == 3:
        return _arith(MUL, _arith(MUL, base, base), base)
    if e == -1:
        return _arith(DIV, 1.0, base)
    if e == -2:
        return _arith(DIV, 1.0, _arith(MUL, base, base))
    if e == 0.5:
        return _arith(SQRT, base)
    if e == -0.5:
        return _arith(RSQRT, base)
    return _arith(POW, base, exp)


def _clamp(x, lo=None, hi=None) -> _Sym:
    """``torch.clamp``: a constant bound keeps clamp's rule, an operand
    bound is ``maximum``/``minimum`` (as torch computes a tensor bound)."""
    if lo is None and hi is None:
        raise _Refused("torch.clamp without a bound")
    out = x
    if lo is not None:
        out = _arith(MAX if isinstance(lo, _Sym) else CLAMP_MIN, out, lo)
    if hi is not None:
        out = _arith(MIN if isinstance(hi, _Sym) else CLAMP_MAX, out, hi)
    return out


def _unary(op):
    return lambda x: _arith(op, x)


def _binary(op, reflected=False):
    if reflected:
        return lambda a, b: _arith(op, b, a)
    return lambda a, b: _arith(op, a, b)


def _cmp(op):
    return lambda a, b: _compare(op, a, b)


def _bool(op, reflected=False, bitwise=False):
    if reflected:
        return lambda a, b: _logic(op, b, a, bitwise=bitwise)
    return lambda *a: _logic(op, *a, bitwise=bitwise)


def _no_alpha(op, reflected=False):
    def call(a, b, alpha=1):
        if alpha != 1:
            raise _Refused("torch.add/sub with alpha (computed as an FMA)")
        return _arith(op, b, a) if reflected else _arith(op, a, b)
    return call


def _div(a, b, rounding_mode=None):
    if rounding_mode is not None:
        raise _Refused(f"division with rounding_mode={rounding_mode!r}")
    return _arith(DIV, a, b)


def _clamp_call(x, min=None, max=None):       # noqa: A002 (torch's names)
    return _clamp(x, min, max)


def _binary_max(op):
    def call(a, b=None, *rest, **kw):
        if b is None or rest or kw:
            raise _Refused("a reduction (torch.max/min of one tensor)")
        return _arith(op, a, b)
    return call


# torch functions and tensor methods by name (reflected dunders take the
# symbol second)
_FUNCS: Dict[str, Callable] = {
    "add": _no_alpha(ADD), "__add__": _no_alpha(ADD),
    "__radd__": _no_alpha(ADD, True),
    "sub": _no_alpha(SUB), "subtract": _no_alpha(SUB),
    "__sub__": _no_alpha(SUB), "__rsub__": _no_alpha(SUB, True),
    "rsub": _no_alpha(SUB, True),
    "mul": _binary(MUL), "multiply": _binary(MUL), "__mul__": _binary(MUL),
    "__rmul__": _binary(MUL, True),
    "div": _div, "divide": _div, "true_divide": _div, "__truediv__": _div,
    "__rtruediv__": _binary(DIV, True),
    "neg": _unary(NEG), "negative": _unary(NEG), "__neg__": _unary(NEG),
    "positive": _unary(MOV), "__pos__": _unary(MOV),
    "abs": _unary(ABS), "absolute": _unary(ABS), "__abs__": _unary(ABS),
    "pow": _pow, "__pow__": _pow, "__rpow__": lambda a, b: _pow(b, a),
    "square": lambda x: _pow(x, 2),
    "reciprocal": lambda x: _arith(DIV, 1.0, x),
    "lt": _cmp(LT), "less": _cmp(LT), "__lt__": _cmp(LT),
    "le": _cmp(LE), "less_equal": _cmp(LE), "__le__": _cmp(LE),
    "gt": _cmp(GT), "greater": _cmp(GT), "__gt__": _cmp(GT),
    "ge": _cmp(GE), "greater_equal": _cmp(GE), "__ge__": _cmp(GE),
    "eq": _cmp(EQ), "__eq__": _cmp(EQ),
    "ne": _cmp(NE), "not_equal": _cmp(NE), "__ne__": _cmp(NE),
    "logical_and": _bool(AND), "logical_or": _bool(OR),
    "logical_not": _bool(NOT),
    "__and__": _bool(AND, bitwise=True), "bitwise_and": _bool(
        AND, bitwise=True), "__rand__": _bool(AND, True, bitwise=True),
    "__or__": _bool(OR, bitwise=True), "bitwise_or": _bool(
        OR, bitwise=True), "__ror__": _bool(OR, True, bitwise=True),
    "__invert__": _bool(NOT, bitwise=True),
    "bitwise_not": _bool(NOT, bitwise=True),
    "where": lambda cond, input, other: _where(cond, input, other),  # noqa
    "maximum": _binary(MAX), "max": _binary_max(MAX),
    "minimum": _binary(MIN), "min": _binary_max(MIN),
    "clamp": _clamp_call, "clip": _clamp_call,
    "clamp_min": lambda x, min: _clamp(x, lo=min),   # noqa: A002
    "clamp_max": lambda x, max: _clamp(x, hi=max),   # noqa: A002
    "sign": _unary(SIGN), "exp": _unary(EXP), "log": _unary(LOG),
    "log1p": _unary(LOG1P), "expm1": _unary(EXPM1), "sqrt": _unary(SQRT),
    "rsqrt": _unary(RSQRT), "tanh": _unary(TANH),
    "sigmoid": _unary(SIGMOID),
}
# tensor methods of the symbol (``x.exp()``, ``x.clamp(min=0)``, ...);
# ``x.where(cond, other)`` is ``torch.where(cond, x, other)``
_METHODS: Dict[str, Callable] = {
    name: fn for name, fn in _FUNCS.items() if not name.startswith("__")}
_METHODS["where"] = lambda x, cond, other: _where(cond, x, other)


def _torch_call(func, args, kwargs):
    if kwargs.pop("out", None) is not None:
        raise _Refused("an out= argument")
    name = getattr(func, "__name__", "")
    fn = _FUNCS.get(name)
    if fn is None:
        raise _Refused(f"the torch function {name or func!r}")
    try:
        return fn(*args, **kwargs)
    except TypeError as exc:
        raise _Refused(f"{name} with arguments it does not take ({exc})") \
            from None


# ---------------------------------------------------------------------------
# Lowering: the DAG to a register program
# ---------------------------------------------------------------------------

def _lower(g: _Graph, root: int) -> MergeCode:
    # the nodes the result needs, in creation (topological) order
    need, stack = set(), [root]
    while stack:
        n = stack.pop()
        if n in need:
            continue
        need.add(n)
        if g.nodes[n][0] not in ("x", "y", "k"):
            stack.extend(g.nodes[n][1:])
    order = sorted(need)
    consts: Dict[int, int] = {}
    for n in order:
        if g.nodes[n][0] == "k":
            consts[n] = len(consts)
    if len(consts) > MAX_CONSTS:
        raise _Refused(f"a program of {len(consts)} constants (at most "
                       f"{MAX_CONSTS})")
    ops = [n for n in order if g.nodes[n][0] not in ("x", "y", "k")]
    last_use: Dict[int, int] = {}
    for step, n in enumerate(ops):
        for arg in g.nodes[n][1:]:
            last_use[arg] = step
    last_use[root] = len(ops)
    reg: Dict[int, int] = {}
    free = list(range(N_REGS - 1, 1, -1))       # r2.. (popped from the end)
    for name, r in (("x", 0), ("y", 1)):
        nid = g._index.get((name,))
        if nid is not None and nid in last_use:
            reg[nid] = r
        else:
            free.append(r)
    code = []

    def slot(arg: int) -> int:
        return N_REGS + consts[arg] if arg in consts else reg[arg]

    for step, n in enumerate(ops):
        op, *args = g.nodes[n]
        slots = [slot(a) for a in args] + [0] * (3 - len(args))
        for a in set(args):                     # operands dying here
            if a in reg and last_use[a] == step:
                free.append(reg[a])
        if not free:
            raise _Refused(f"a program needing more than {N_REGS} "
                           "registers")
        # r0 holds the result: take it for the root when it is free
        dst = 0 if n == root and 0 in free else free[-1]
        free.remove(dst)
        reg[n] = dst
        code.append((op, dst, *slots))
    if root in consts:
        code.append((MOV, 0, N_REGS + consts[root], 0, 0))
    elif reg[root] != 0:
        code.append((MOV, 0, reg[root], 0, 0))
    if len(code) > MAX_CODE:
        raise _Refused(f"a program of {len(code)} instructions (at most "
                       f"{MAX_CODE})")
    table = [0.0] * len(consts)
    for n, k in consts.items():
        table[k] = float(g.nodes[n][1])
    return MergeCode(PROGRAM, code=tuple(code), consts=tuple(table))


def _compile(fn: Callable) -> MergeCode:
    g = _Graph()
    x, y = _Sym(g, g.node(("x",)), _VAL), _Sym(g, g.node(("y",)), _VAL)
    out = fn(x, y)
    if isinstance(out, _Sym):
        return _lower(g, out.id)
    cv = _const_value(out)
    if cv is None:
        raise _Refused(f"a result of type {type(out).__name__}")
    return _lower(g, g.node(("k", cv[0])))


# ---------------------------------------------------------------------------
# The cache and the entry point
# ---------------------------------------------------------------------------

# a refusal is cached as its message: an exception would hold its
# traceback, and through it the callable
_CACHE: "weakref.WeakKeyDictionary[Callable, Union[MergeCode, str]]" = \
    weakref.WeakKeyDictionary()


def _code_of(merge: MergeFn, fn: Callable) -> Union[MergeCode, str]:
    from repro_torch.core.sparsity import safe_div
    if fn is safe_div or (isinstance(merge, MergeFn)
                          and merge.name == "safediv"):
        return MergeCode(SAFE_DIV)
    try:
        out = fn(_Poly(0, 1, 0, 0), _Poly(0, 0, 1, 0))
        return MergeCode(BILINEAR, _Poly._lift(out).c)
    except Exception:  # any failure: not in the family
        pass
    try:
        return _compile(fn)
    except _Refused as exc:
        return str(exc)
    except Exception as exc:   # the merge itself failed on the symbols
        return f"{type(exc).__name__}: {exc}"


def merge_code(merge: Union[MergeFn, Callable]) -> MergeCode:
    """The code of ``merge``: ``BILINEAR``, ``SAFE_DIV`` or a ``PROGRAM``;
    raises ``NotImplementedError`` for a merge the compiler refuses."""
    fn = merge.fn if isinstance(merge, MergeFn) else merge
    try:
        hit = _CACHE.get(fn)
    except TypeError:       # not weak-referenceable (a builtin): no cache
        hit = None
    if hit is None:
        hit = _code_of(merge, fn)
        try:
            _CACHE[fn] = hit
        except TypeError:
            pass
    if isinstance(hit, str):
        raise NotImplementedError(
            f"merge {getattr(fn, '__name__', fn)!r} is outside the set of "
            f"general merges a CUDA kernel evaluates: {hit}")
    return hit


# ---------------------------------------------------------------------------
# A host interpreter of codes (the CPU tests hold it to the merge)
# ---------------------------------------------------------------------------

def _truth(v):
    return v if isinstance(v, torch.Tensor) and v.dtype == torch.bool \
        else v != 0


_EVAL = {
    MOV: lambda a: a, ADD: lambda a, b: a + b, SUB: lambda a, b: a - b,
    MUL: lambda a, b: a * b, DIV: lambda a, b: a / b,
    NEG: lambda a: -a, ABS: torch.abs,
    LT: lambda a, b: a < b, LE: lambda a, b: a <= b,
    GT: lambda a, b: a > b, GE: lambda a, b: a >= b,
    EQ: lambda a, b: a == b, NE: lambda a, b: a != b,
    AND: lambda a, b: torch.logical_and(_truth(a), _truth(b)),
    OR: lambda a, b: torch.logical_or(_truth(a), _truth(b)),
    NOT: lambda a: torch.logical_not(_truth(a)),
    WHERE: lambda c, a, b: torch.where(c, a, b),
    MAX: torch.maximum, MIN: torch.minimum,
    CLAMP_MIN: lambda a, b: torch.clamp(a, min=b),
    CLAMP_MAX: lambda a, b: torch.clamp(a, max=b),
    SIGN: torch.sign, EXP: torch.exp, LOG: torch.log, LOG1P: torch.log1p,
    EXPM1: torch.expm1, SQRT: torch.sqrt, RSQRT: torch.rsqrt,
    TANH: torch.tanh, SIGMOID: torch.sigmoid, POW: torch.pow,
}


def evaluate(code: MergeCode, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """``code`` applied to ``x`` and ``y`` with torch ops, in ``x``'s dtype.
    A program's constants reach each op as Python numbers, as the merge's
    own constants reached torch."""
    if code.op == SAFE_DIV:
        out = torch.where(x == 0, 0.0, x / torch.where(y == 0, 1.0, y))
    elif code.op == BILINEAR:
        c0, cx, cy, cxy = code.coeffs
        out = torch.full_like(x, c0)
        if cx:
            out = out + cx * x
        if cy:
            out = out + cy * y
        if cxy:
            out = out + cxy * (x * y)
    else:
        regs: List[object] = [x, y] + [None] * (N_REGS - 2)
        for op, d, *slots in code.code:
            args = [regs[s] if s < N_REGS else code.consts[s - N_REGS]
                    for s in slots[:_ARITY.get(op, 2)]]
            if op in (MAX, MIN, AND, OR, NOT):
                # tensor-only functions: a constant as a 0-d tensor
                args = [a if isinstance(a, torch.Tensor)
                        else torch.tensor(a, dtype=x.dtype) for a in args]
            regs[d] = _EVAL[op](*args)
        out = regs[0]
    if not isinstance(out, torch.Tensor):
        return torch.full_like(x, out)
    return out.to(x.dtype).expand_as(x)
