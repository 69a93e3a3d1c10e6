"""Merge functions as codes and generated CUDA the kernels evaluate.

The JAX package traces any Python merge callable into its kernel bodies;
so does the port, with nvcc in place of XLA. This module compiles a merge
once, on the host, into one of three codes:

* ``BILINEAR`` with coefficients (c0, cx, cy, cxy): the merge evaluated
  on a symbolic proxy that tracks a polynomial in ``x`` and ``y`` with
  terms {1, x, y, xy} — ``x*y``, ``x+y``, ``x-y``, ``left`` (``x``),
  affine mixes such as ``2xy+x``, and division by a power of two;
* ``SAFE_DIV``, the named safe division (``core.sparsity.safe_div``):
  ``x == 0 ? 0 : x / (y == 0 ? 1 : y)``;
* ``GENERATED`` for every other merge within the op set below: the merge
  is traced on two symbolic operands (``_Sym``: the Python operators and
  ``__torch_function__``), once with float32 operands and once with
  float64, equal nodes are merged, and each trace is emitted as C++: a
  functor ``Merge<T>`` whose body declares one typed value a node and
  calls ``csrc/merge.cuh``'s op helpers (and says ``kSlowPaths`` when an
  op of ``SLOW_PATH_OPS`` is among them: ``csrc/merge_join.cuh`` takes
  such a merge's rows one at a time). ``kernels/build.py`` compiles it
  at first use into its own instances of ``merge_join`` and
  ``coo_expand``; the code's ``key`` (a hash of the source) names them,
  so two merges with the same trace share one library.

The first two run in the main library's code instances, which the main
path uses; no nvcc run lands on its cold wall.

Types are torch's. Every node carries the dtype torch gives the value the
plain versions see: bool, int64, float32 (the default float, which
torch gives booleans, integers and Python floats combined), float64, or
the operands' ``T``. Python numbers are wrapped scalars and do not
promote; 0-d tensor constants promote by category. Each node's dtype is
what the torch function itself returns on dummy tensors of its operands'
dtypes, so the promotion rules, and the refusals (``-`` of booleans, a
negative integer power, ``hypot`` of integers), are torch's own. Each
op is emitted in its computation type (comparisons in the operands'
common type, logical ops in bool, predicates in the operand's own), and
the result is cast to ``T``, as ``merge_join_plain``'s
``merge(a, b).to(a.dtype)`` does. A constant is converted to the type an
op computes in as torch converts it (a Python float is rounded to
float32 in a float32 op).

The op set: ``+ - * / // % **``, unary ``-``, ``abs``, ``& | ^ ~``,
``< <= > >= == !=`` and the torch functions and tensor methods named in
``_FUNCS``: ``add``/``sub`` (with ``alpha``), ``mul``, ``div`` (with
``rounding_mode``), ``floor_divide``, ``remainder``, ``fmod``, ``pow``,
``square``, ``reciprocal``, ``maximum``/``minimum`` (``max``/``min`` of
two tensors), ``fmax``, ``fmin``, ``clamp``/``clip``/``clamp_min``/
``clamp_max``, ``relu``, ``atan2``, ``hypot``, ``copysign``, ``sign``,
``exp``, ``exp2``, ``expm1``, ``log``, ``log2``, ``log10``, ``log1p``,
``sqrt``, ``rsqrt``, ``sigmoid``, ``erf``, ``erfc``, the trigonometric
and hyperbolic functions and their inverses, ``floor``, ``ceil``,
``round`` (half to even), ``trunc``, ``frac``, ``isnan``, ``isinf``,
``isfinite``, ``signbit``, ``logical_and/or/xor/not``, ``bitwise_*``
and ``where``. Integer ``+ - * // % **`` and bitwise ops run on int64
values. Powers are lowered as torch computes them, so that the bits
match: ``x**2`` is ``x*x``, ``x**3`` ``x*x*x``, ``x**-1`` ``1/x``,
``x**-2`` ``1/(x*x)``, ``x**0.5`` ``sqrt``, ``x**-0.5`` ``rsqrt``,
``x**0`` 1 and ``x**1`` ``x``; other exponents run ``pow``. A bound of
``clamp`` that is a Python number keeps clamp's own rule, one that is a
tensor is ``maximum``/``minimum`` (as torch computes a tensor bound).
There is no limit on the merge's length.

``merge_code`` raises ``NotImplementedError``, naming the cause, before
anything is built or launched, for a Python branch on a value (``bool``
of a symbol; the JAX package's tracer raises there too), a tensor
constant that is not 0-d, a non-elementwise or random op, and an op
outside the set. ``registry.REFUSALS`` counts these as refusals that
feed no breaker. The plain PyTorch versions take any callable.
``evaluate(code, x, y)`` runs a code on CPU tensors: a bilinear code and
the safe division with torch ops, a generated code through the same
emitted function compiled for the host by g++ (``build.host_merge``): the
CPU tests hold it to the merge itself.

Codes are cached per merge callable (not per ``MergeFn.name``: every
lambda handed to ``Matrix.join`` is named ``"f"``, and two different
lambdas must not share a code). The cache holds the callable weakly and
nothing in an entry refers back to it, so an entry dies with its
callable and a later lambda at the same address is compiled anew.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import weakref
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.expr import MergeFn

BILINEAR = 0
SAFE_DIV = 1
GENERATED = 2


@dataclasses.dataclass(frozen=True)
class MergeCode:
    op: int
    coeffs: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    # GENERATED: the emitted C++ (Merge<float> and Merge<double>)
    source: str = ""

    @functools.cached_property
    def key(self) -> str:
        """A hash of the emitted source: the name of its instances."""
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]


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
        # x * (1/3) in floating point, so it goes to a generated division
        if not isinstance(o, (int, float)) or isinstance(o, bool) \
                or o == 0 or not math.isfinite(o) \
                or abs(math.frexp(o)[0]) != 0.5:
            raise _NotBilinear("division")
        return self * (1.0 / o)


# ---------------------------------------------------------------------------
# The tracer: symbolic operands recording a typed expression DAG
# ---------------------------------------------------------------------------

class _Refused(Exception):
    """A merge the compiler cannot take; the message names the cause."""


# the dtypes a node may take, and their C++ types (csrc/merge.cuh: i64)
_CTYPES = {torch.bool: "bool", torch.int64: "i64", torch.float32: "float",
           torch.float64: "double"}
# a Python number's kind, and the dtype torch holds it in before an op
# converts it
_SCALARS = {"bool": torch.bool, "int": torch.int64, "float": torch.float64}


class _Graph:
    """Hash-consed nodes: ("x",), ("y",), ("k", kind, bits) for a constant
    (``consts`` holds its value), (op, ids...) for an op. ``dtypes`` holds
    each node's dtype (a constant's: its own, a Python number's None) and
    ``compute`` each op node's operands' computation dtypes."""

    def __init__(self):
        self.nodes: List[tuple] = []
        self.dtypes: List[Optional[torch.dtype]] = []
        self.compute: Dict[int, Tuple[torch.dtype, ...]] = {}
        self.consts: Dict[int, Tuple[str, object]] = {}
        self._index: Dict[tuple, int] = {}

    def node(self, key: tuple, dtype: Optional[torch.dtype]) -> int:
        nid = self._index.get(key)
        if nid is None:
            nid = self._index[key] = len(self.nodes)
            self.nodes.append(key)
            self.dtypes.append(dtype)
        return nid

    def const(self, kind: str, value) -> int:
        # keyed by the bits: -0.0 == 0.0 and nan != nan as floats
        bits = float(value).hex() if isinstance(value, float) else value
        nid = self.node(("k", kind, bits), None if kind in _SCALARS
                        else getattr(torch, kind))
        self.consts[nid] = (kind, value)
        return nid


def _constant(o) -> Optional[Tuple[str, object]]:
    """(kind, value) of a constant operand: a Python number's kind, or the
    dtype name of a 0-d tensor; None for a non-constant. Raises for a
    tensor constant that is not 0-d."""
    if isinstance(o, (bool, np.bool_)):
        return "bool", bool(o)
    if isinstance(o, (int, np.integer)):
        return "int", int(o)
    if isinstance(o, (float, np.floating)):
        return "float", float(o)
    if isinstance(o, torch.Tensor):
        if o.ndim != 0:
            raise _Refused(f"a tensor constant of shape {tuple(o.shape)} "
                           "(only 0-d tensor constants)")
        if o.dtype not in _CTYPES:
            raise _Refused(f"a constant of dtype {o.dtype}")
        return str(o.dtype).split(".")[1], o.item()
    return None


class _Sym:
    """A symbolic operand of the merge being traced."""

    __slots__ = ("g", "id")

    def __init__(self, g: _Graph, nid: int):
        self.g, self.id = g, nid

    @property
    def dtype(self) -> torch.dtype:
        return self.g.dtypes[self.id]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _torch_call(func, args, dict(kwargs or {}))

    # Python operators ----------------------------------------------------
    def __add__(self, o): return _FUNCS["add"](self, o)
    def __radd__(self, o): return _FUNCS["add"](o, self)
    def __sub__(self, o): return _FUNCS["sub"](self, o)
    def __rsub__(self, o): return _FUNCS["sub"](o, self)
    def __mul__(self, o): return _FUNCS["mul"](self, o)
    def __rmul__(self, o): return _FUNCS["mul"](o, self)
    def __truediv__(self, o): return _FUNCS["div"](self, o)
    def __rtruediv__(self, o): return _FUNCS["div"](o, self)
    def __floordiv__(self, o): return _FUNCS["floor_divide"](self, o)
    def __rfloordiv__(self, o): return _FUNCS["floor_divide"](o, self)
    def __mod__(self, o): return _FUNCS["remainder"](self, o)
    def __rmod__(self, o): return _FUNCS["remainder"](o, self)
    def __pow__(self, o): return _pow(self, o)
    def __rpow__(self, o): return _pow(o, self)
    def __neg__(self): return _FUNCS["neg"](self)
    def __pos__(self): return self
    def __abs__(self): return _FUNCS["abs"](self)
    def __lt__(self, o): return _FUNCS["lt"](self, o)
    def __le__(self, o): return _FUNCS["le"](self, o)
    def __gt__(self, o): return _FUNCS["gt"](self, o)
    def __ge__(self, o): return _FUNCS["ge"](self, o)
    def __eq__(self, o): return _FUNCS["eq"](self, o)
    def __ne__(self, o): return _FUNCS["ne"](self, o)
    def __and__(self, o): return _FUNCS["bitwise_and"](self, o)
    def __rand__(self, o): return _FUNCS["bitwise_and"](o, self)
    def __or__(self, o): return _FUNCS["bitwise_or"](self, o)
    def __ror__(self, o): return _FUNCS["bitwise_or"](o, self)
    def __xor__(self, o): return _FUNCS["bitwise_xor"](self, o)
    def __rxor__(self, o): return _FUNCS["bitwise_xor"](o, self)
    def __invert__(self): return _FUNCS["bitwise_not"](self)

    __hash__ = object.__hash__

    def __bool__(self):
        raise _Refused("a Python branch on a value (bool() of a traced "
                       "operand)")

    def __float__(self):
        raise _Refused("a Python number taken from a value (float() of a "
                       "traced operand)")

    __int__ = __index__ = __float__

    def __getitem__(self, index):
        raise _Refused("indexing, a non-elementwise op")

    def __getattr__(self, name):
        fn = _METHODS.get(name)
        if fn is None:
            if name.startswith("__"):
                raise AttributeError(name)
            raise _Refused(_unknown("tensor method", name))
        return functools.partial(fn, self)


# how each op's operands are converted before it computes: "out" to its
# result's dtype, "common" to the operands' common dtype (comparisons),
# "bool" to bool (logical ops), "own" not at all (predicates), "where"
# the condition to bool and the branches to the result's dtype
@dataclasses.dataclass(frozen=True)
class _Op:
    probe: Callable          # the torch function, run on dummies
    c: Dict[str, str]        # C++ by category: "f" float, "i" int64, "b"
    rule: str = "out"


def _f(fmt: str, i: Optional[str] = None, b: Optional[str] = None):
    return {k: v for k, v in (("f", fmt), ("i", i), ("b", b)) if v}


_MATH1 = ("exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "erf",
          "erfc", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
          "cosh", "tanh", "asinh", "acosh", "atanh", "rsqrt")

_OPS: Dict[str, _Op] = {
    "add": _Op(torch.add, _f("add_rn({0}, {1})", "i_add({0}, {1})",
                             "({0} || {1})")),
    "sub": _Op(torch.sub, _f("sub_rn({0}, {1})", "i_sub({0}, {1})")),
    # a + alpha * b, one rounding (torch's add kernel is an FMA there)
    "add_alpha": _Op(lambda a, b, alpha: torch.add(a, b, alpha=alpha),
                     _f("fma_rn({2}, {1}, {0})",
                        "i_add({0}, i_mul({2}, {1}))")),
    "mul": _Op(torch.mul, _f("mul_rn({0}, {1})", "i_mul({0}, {1})",
                             "({0} && {1})")),
    "div": _Op(torch.div, _f("div_rn({0}, {1})")),
    "div_trunc": _Op(functools.partial(torch.div, rounding_mode="trunc"),
                     _f("m_trunc(div_rn({0}, {1}))", "trunc_div({0}, {1})")),
    "floor_divide": _Op(torch.floor_divide, _f("floor_div({0}, {1})",
                                               "floor_div({0}, {1})")),
    "remainder": _Op(torch.remainder, _f("m_remainder({0}, {1})",
                                         "m_remainder({0}, {1})")),
    "fmod": _Op(torch.fmod, _f("m_fmod({0}, {1})", "i_fmod({0}, {1})")),
    "pow": _Op(torch.pow, _f("m_pow({0}, {1})", "i_pow({0}, {1})")),
    "atan2": _Op(torch.atan2, _f("m_atan2({0}, {1})")),
    "hypot": _Op(torch.hypot, _f("m_hypot({0}, {1})")),
    "copysign": _Op(torch.copysign, _f("m_copysign({0}, {1})")),
    "fmax": _Op(torch.fmax, _f("m_fmax({0}, {1})", "i_max({0}, {1})",
                               "({0} || {1})")),
    "fmin": _Op(torch.fmin, _f("m_fmin({0}, {1})", "i_min({0}, {1})",
                               "({0} && {1})")),
    "maximum": _Op(torch.maximum, _f("nan_max({0}, {1})", "i_max({0}, {1})",
                                     "({0} || {1})")),
    "minimum": _Op(torch.minimum, _f("nan_min({0}, {1})", "i_min({0}, {1})",
                                     "({0} && {1})")),
    # clamp by a Python-number bound
    "clamp_min": _Op(torch.clamp_min, _f("clamp_min({0}, {1})",
                                         "i_max({0}, {1})")),
    "clamp_max": _Op(torch.clamp_max, _f("clamp_max({0}, {1})",
                                         "i_min({0}, {1})")),
    "neg": _Op(torch.neg, _f("(-{0})", "i_neg({0})")),
    "abs": _Op(torch.abs, _f("m_fabs({0})", "i_abs({0})")),
    "sign": _Op(torch.sign, _f("sign_of({0})", "sign_of({0})", "{0}")),
    "sqrt": _Op(torch.sqrt, _f("sqrt_rn({0})")),
    "sigmoid": _Op(torch.sigmoid, _f("sigmoid({0})")),
    "floor": _Op(torch.floor, _f("m_floor({0})", "{0}")),
    "ceil": _Op(torch.ceil, _f("m_ceil({0})", "{0}")),
    "trunc": _Op(torch.trunc, _f("m_trunc({0})", "{0}")),
    "round": _Op(torch.round, _f("m_round({0})", "{0}")),
    "frac": _Op(torch.frac, _f("sub_rn({0}, m_trunc({0}))")),
    "isnan": _Op(torch.isnan, _f("({0} != {0})", "false", "false"), "own"),
    "isinf": _Op(torch.isinf, _f("m_isinf({0})", "false", "false"), "own"),
    "isfinite": _Op(torch.isfinite, _f("m_isfinite({0})", "true", "true"),
                    "own"),
    "signbit": _Op(torch.signbit, _f("m_signbit({0})", "({0} < 0)", "false"),
                   "own"),
    "lt": _Op(torch.lt, dict.fromkeys("fib", "({0} < {1})"), "common"),
    "le": _Op(torch.le, dict.fromkeys("fib", "({0} <= {1})"), "common"),
    "gt": _Op(torch.gt, dict.fromkeys("fib", "({0} > {1})"), "common"),
    "ge": _Op(torch.ge, dict.fromkeys("fib", "({0} >= {1})"), "common"),
    "eq": _Op(torch.eq, dict.fromkeys("fib", "({0} == {1})"), "common"),
    "ne": _Op(torch.ne, dict.fromkeys("fib", "({0} != {1})"), "common"),
    "logical_and": _Op(torch.logical_and, {"b": "({0} && {1})"}, "bool"),
    "logical_or": _Op(torch.logical_or, {"b": "({0} || {1})"}, "bool"),
    "logical_xor": _Op(torch.logical_xor, {"b": "({0} != {1})"}, "bool"),
    "logical_not": _Op(torch.logical_not, {"b": "(!{0})"}, "bool"),
    "bitwise_and": _Op(torch.bitwise_and, {"i": "({0} & {1})",
                                           "b": "({0} && {1})"}),
    "bitwise_or": _Op(torch.bitwise_or, {"i": "({0} | {1})",
                                         "b": "({0} || {1})"}),
    "bitwise_xor": _Op(torch.bitwise_xor, {"i": "({0} ^ {1})",
                                           "b": "({0} != {1})"}),
    "bitwise_not": _Op(torch.bitwise_not, {"i": "(~{0})", "b": "(!{0})"}),
    "where": _Op(torch.where, dict.fromkeys("fib", "({0} ? {1} : {2})"),
                 "where"),
}
_OPS.update({name: _Op(getattr(torch, name), _f(f"m_{name}({{0}})"))
             for name in _MATH1})

_CATEGORY = {torch.bool: "b", torch.int64: "i", torch.float32: "f",
             torch.float64: "f"}

# ops whose CUDA code carries a long slow path, where one row a thread was
# measured faster on an H100 (PERF.md, merges table): a division or
# remainder (taken on every zero divisor, and a sparse matrix is mostly
# zeros), a sine's or cosine's argument reduction (its registers). tan,
# fmod and trunc division have such paths too but were not measured, so
# they keep the streaming plan.
SLOW_PATH_OPS = frozenset({"div", "floor_divide", "remainder", "sin", "cos"})


def _dummy(o):
    """What the torch function sees in the plain version, for its dtype."""
    if isinstance(o, _Sym):
        return torch.ones(1, dtype=o.dtype)
    kind, value = _constant(o)
    if kind in _SCALARS:
        return value
    return torch.tensor(value, dtype=getattr(torch, kind))


def _node(op: str, *operands) -> _Sym:
    """The node of ``op`` over ``operands`` (symbols or constants), typed
    as the torch function types it."""
    syms = [o for o in operands if isinstance(o, _Sym)]
    g = syms[0].g
    if any(s.g is not g for s in syms):
        raise _Refused("operands of two different traces")
    for o in operands:
        if not isinstance(o, _Sym) and _constant(o) is None:
            raise _Refused(f"an operand of type {type(o).__name__}")
    spec = _OPS[op]
    dummies = [_dummy(o) for o in operands]
    try:
        out = spec.probe(*dummies)
    except Exception as exc:     # torch refuses these operand dtypes
        kinds = [getattr(d, "dtype", type(d).__name__) for d in dummies]
        raise _Refused(f"{op} of {kinds}: {exc}") from None
    if out.dtype not in _CTYPES:
        raise _Refused(f"a value of dtype {out.dtype} ({op})")
    if spec.rule == "out":
        compute = (out.dtype,) * len(operands)
    elif spec.rule == "common":
        compute = (torch.result_type(*dummies),) * 2
    elif spec.rule == "bool":
        compute = (torch.bool,) * len(operands)
    elif spec.rule == "own":
        compute = (dummies[0].dtype,)
    else:                                           # where
        compute = (torch.bool, out.dtype, out.dtype)
    if _CATEGORY[compute[-1]] not in spec.c:
        raise _Refused(f"{op} computed in {compute[-1]}")
    ids = tuple(o.id if isinstance(o, _Sym) else g.const(*_constant(o))
                for o in operands)
    nid = g.node((op, *ids), out.dtype)
    g.compute[nid] = compute
    return _Sym(g, nid)


def _pow(base, exp) -> _Sym:
    """Powers as torch computes them (``aten``'s pow kernels special-case
    these exponents of a Python number for a floating base), so the bits
    match; a tensor exponent, 0-d too, is torch's tensor-tensor ``pow``."""
    if isinstance(exp, (_Sym, torch.Tensor)) or not isinstance(base, _Sym) \
            or base.dtype not in (torch.float32, torch.float64):
        return _node("pow", base, exp)
    cv = _constant(exp)
    if cv is None:
        raise _Refused(f"an exponent of type {type(exp).__name__}")
    e = cv[1]
    if e == 0:
        return _node("pow", base, 0)     # torch fills ones: pow(x, 0) is 1
    if e == 1:
        return base
    if e == 2:
        return _node("mul", base, base)
    if e == 3:
        return _node("mul", _node("mul", base, base), base)
    if e == -1:
        return _node("div", 1, base)
    if e == -2:
        return _node("div", 1, _node("mul", base, base))
    if e == 0.5:
        return _node("sqrt", base)
    if e == -0.5:
        return _node("rsqrt", base)
    return _node("pow", base, exp)


def _clamp(x, lo=None, hi=None) -> _Sym:
    """``torch.clamp``: a Python-number bound keeps clamp's rule, a tensor
    bound (a traced value or a 0-d constant) is ``maximum``/``minimum``,
    as torch computes a tensor bound."""
    if lo is None and hi is None:
        raise _Refused("torch.clamp without a bound")
    out = x
    if lo is not None:
        out = _node("maximum" if isinstance(lo, (_Sym, torch.Tensor))
                    else "clamp_min", out, lo)
    if hi is not None:
        out = _node("minimum" if isinstance(hi, (_Sym, torch.Tensor))
                    else "clamp_max", out, hi)
    return out


def _add(a, b, alpha=1, sign=1):
    if isinstance(alpha, _Sym) or _constant(alpha) is None:
        raise _Refused("an alpha that is not a number")
    if alpha == 1:
        return _node("add" if sign > 0 else "sub", a, b)
    # sub(a, b, alpha) is add(a, b, -alpha) in torch
    return _node("add_alpha", a, b, sign * _constant(alpha)[1])


def _div(a, b, rounding_mode=None):
    op = {None: "div", "trunc": "div_trunc", "floor": "floor_divide"}.get(
        rounding_mode)
    if op is None:
        raise _Refused(f"division with rounding_mode={rounding_mode!r}")
    return _node(op, a, b)


def _binary_max(op):
    def call(a, b=None, *rest, **kw):
        if b is None or rest or kw:
            raise _Refused("a reduction (torch.max/min of one tensor), a "
                           "non-elementwise op")
        return _node(op, a, b)
    return call


def _relu(x, inplace=False):
    if inplace:
        raise _Refused("an in-place relu")
    return _node("clamp_min", x, 0)


def _op(name, reflected=False):
    if reflected:
        return lambda a, b: _node(name, b, a)
    return lambda *a: _node(name, *a)


# torch functions and tensor methods by name (reflected dunders take the
# symbol second)
_FUNCS: Dict[str, Callable] = {name: _op(name) for name in _OPS
                               if name not in ("add_alpha", "clamp_min",
                                               "clamp_max", "div_trunc")}
_FUNCS.update({
    "add": _add, "__add__": _add, "__radd__": lambda a, b: _add(b, a),
    "sub": functools.partial(_add, sign=-1),
    "subtract": functools.partial(_add, sign=-1),
    "__sub__": functools.partial(_add, sign=-1),
    "__rsub__": lambda a, b: _add(b, a, sign=-1),
    "rsub": lambda a, b, alpha=1: _add(b, a, alpha, sign=-1),
    "multiply": _op("mul"), "__mul__": _op("mul"),
    "__rmul__": _op("mul", True),
    "div": _div, "divide": _div, "true_divide": _div, "__truediv__": _div,
    "__rtruediv__": _op("div", True),
    "__floordiv__": _op("floor_divide"),
    "__rfloordiv__": _op("floor_divide", True),
    "__mod__": _op("remainder"), "__rmod__": _op("remainder", True),
    "negative": _op("neg"), "__neg__": _op("neg"),
    "positive": lambda x: x, "__pos__": lambda x: x,
    "absolute": _op("abs"), "__abs__": _op("abs"),
    "pow": _pow, "__pow__": _pow, "__rpow__": lambda a, b: _pow(b, a),
    "square": lambda x: _pow(x, 2),
    "reciprocal": lambda x: _node("div", 1, x),
    "less": _op("lt"), "__lt__": _op("lt"),
    "less_equal": _op("le"), "__le__": _op("le"),
    "greater": _op("gt"), "__gt__": _op("gt"),
    "greater_equal": _op("ge"), "__ge__": _op("ge"),
    "__eq__": _op("eq"), "not_equal": _op("ne"), "__ne__": _op("ne"),
    "__and__": _op("bitwise_and"), "__rand__": _op("bitwise_and", True),
    "__or__": _op("bitwise_or"), "__ror__": _op("bitwise_or", True),
    "__xor__": _op("bitwise_xor"), "__rxor__": _op("bitwise_xor", True),
    "__invert__": _op("bitwise_not"),
    "where": lambda condition, input, other: _node(  # noqa: A002
        "where", condition, input, other),
    "max": _binary_max("maximum"), "min": _binary_max("minimum"),
    "clamp": lambda x, min=None, max=None: _clamp(x, min, max),  # noqa
    "clip": lambda x, min=None, max=None: _clamp(x, min, max),  # noqa
    "clamp_min": lambda x, min: _clamp(x, lo=min),   # noqa: A002
    "clamp_max": lambda x, max: _clamp(x, hi=max),   # noqa: A002
    "relu": _relu, "fix": _op("trunc"), "arctan2": _op("atan2"),
})
# tensor methods of the symbol (``x.exp()``, ``x.clamp(min=0)``, ...);
# ``x.where(cond, other)`` is ``torch.where(cond, x, other)``
_METHODS: Dict[str, Callable] = {
    name: fn for name, fn in _FUNCS.items() if not name.startswith("__")}
_METHODS["where"] = lambda x, condition, other: _node(
    "where", condition, x, other)

_RANDOM = frozenset({"bernoulli", "normal", "multinomial", "poisson",
                     "dropout", "uniform_", "normal_", "exponential_",
                     "random_", "geometric_", "cauchy_", "log_normal_"})
_NON_ELEMENTWISE = frozenset({
    "sum", "mean", "prod", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "amax", "amin", "argmax", "argmin", "aminmax",
    "logsumexp", "softmax", "log_softmax", "norm", "std", "var", "all",
    "any", "median", "mode", "sort", "argsort", "topk", "kthvalue",
    "matmul", "mm", "bmm", "dot", "outer", "einsum", "gather",
    "index_select", "take", "roll", "flip", "reshape", "view", "flatten",
    "transpose", "permute", "t", "diff", "cross", "tril", "triu",
    "unique", "nonzero", "masked_select", "count_nonzero"})


def _unknown(what: str, name: str) -> str:
    if name in _RANDOM or "rand" in name:
        return f"the random op {name!r}"
    if name in _NON_ELEMENTWISE:
        return f"the non-elementwise op {name!r}"
    return f"the {what} {name!r}, outside the op set"


def _torch_call(func, args, kwargs):
    if kwargs.pop("out", None) is not None:
        raise _Refused("an out= argument")
    name = getattr(func, "__name__", "")
    fn = _FUNCS.get(name)
    if fn is None:
        raise _Refused(_unknown("torch function", name or repr(func)))
    try:
        return fn(*args, **kwargs)
    except TypeError as exc:
        raise _Refused(f"{name} with arguments it does not take ({exc})") \
            from None


# ---------------------------------------------------------------------------
# Emission: each trace to a C++ functor
# ---------------------------------------------------------------------------

def _literal(kind: str, value, dtype: torch.dtype) -> str:
    """A constant as a C++ literal of ``dtype``, converted as torch
    converts it for an op computing in ``dtype``."""
    src = _SCALARS.get(kind) or getattr(torch, kind)
    try:
        v = torch.tensor(value, dtype=src).to(dtype)
    except (RuntimeError, OverflowError) as exc:
        raise _Refused(f"the constant {value!r}: {exc}") from None
    if dtype == torch.bool:
        return "true" if v.item() else "false"
    if dtype == torch.int64:
        i = v.item()
        return "(-9223372036854775807LL - 1)" if i == -2 ** 63 \
            else f"({i}LL)"
    f = v.item()
    if not math.isfinite(f):
        if dtype == torch.float32:
            return f"f32_bits(0x{v.view(torch.int32).item() & 0xffffffff:08x}u)"
        return f"f64_bits(0x{v.view(torch.int64).item() & (1 << 64) - 1:016x}ull)"
    return f"({f.hex()}{'f' if dtype == torch.float32 else ''})"


def _value(g: _Graph, nid: int, dtype: torch.dtype) -> str:
    """Node ``nid`` as an expression of ``dtype``."""
    key = g.nodes[nid]
    if key[0] == "k":
        return _literal(*g.consts[nid], dtype)
    name = key[0] if key[0] in ("x", "y") else f"v{nid}"
    if g.dtypes[nid] == dtype:
        return name
    return f"(({_CTYPES[dtype]}){name})"


def _functor(g: _Graph, root: int, t: torch.dtype) -> str:
    need, stack = set(), [root]
    while stack:
        n = stack.pop()
        if n not in need:
            need.add(n)
            if g.nodes[n][0] not in ("x", "y", "k"):
                stack.extend(g.nodes[n][1:])
    ct = _CTYPES[t]
    lines = [f"template <> struct Merge<{ct}> {{"]
    if any(g.nodes[n][0] in SLOW_PATH_OPS for n in need):
        lines.append("  static constexpr bool kSlowPaths = true;")
    lines.append(f"  MERGE_HD {ct} operator()({ct} x, {ct} y) const {{")
    for n in sorted(need):
        op, *args = g.nodes[n]
        if op in ("x", "y", "k"):
            continue
        compute = g.compute[n]
        expr = _OPS[op].c[_CATEGORY[compute[-1]]].format(
            *(_value(g, a, d) for a, d in zip(args, compute)))
        lines.append(f"    const {_CTYPES[g.dtypes[n]]} v{n} = {expr};")
    lines.append(f"    return {_value(g, root, t)};")
    lines += ["  }", "};"]
    return "\n".join(lines)


def _trace(fn: Callable, t: torch.dtype) -> str:
    g = _Graph()
    x, y = (_Sym(g, g.node((n,), t)) for n in ("x", "y"))
    out = fn(x, y)
    if isinstance(out, _Sym):
        return _functor(g, out.id, t)
    cv = _constant(out)
    if cv is None:
        raise _Refused(f"a result of type {type(out).__name__}")
    return _functor(g, g.const(*cv), t)


def _compile(fn: Callable) -> MergeCode:
    source = "\n".join(["template <typename T> struct Merge;"] + [
        _trace(fn, t) for t in (torch.float32, torch.float64)])
    return MergeCode(GENERATED, source=source + "\n")


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
    """The code of ``merge``: ``BILINEAR``, ``SAFE_DIV`` or ``GENERATED``;
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
# Codes on the host (the CPU tests hold them to the merge)
# ---------------------------------------------------------------------------

def evaluate(code: MergeCode, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """``code`` applied to CPU tensors ``x`` and ``y`` of one shape, in
    ``x``'s dtype: a generated code by its emitted function compiled for
    the host, the others with torch ops."""
    if code.op == GENERATED:
        from repro_torch.kernels import build
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.dtype not in (torch.float32, torch.float64) \
                or x.device.type != "cpu" or y.device.type != "cpu":
            raise ValueError("evaluate takes CPU tensors x and y of one "
                             "shape and float32/float64 dtype")
        x, y = x.contiguous(), y.contiguous()
        out = torch.empty_like(x)
        fn = build.host_merge(code)[x.dtype == torch.float64]
        fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel())
        return out
    if code.op == SAFE_DIV:
        out = torch.where(x == 0, 0.0, x / torch.where(y == 0, 1.0, y))
    else:
        c0, cx, cy, cxy = code.coeffs
        out = torch.full_like(x, c0)
        if cx:
            out = out + cx * x
        if cy:
            out = out + cy * y
        if cxy:
            out = out + cxy * (x * y)
    return out.to(x.dtype).expand_as(x)
