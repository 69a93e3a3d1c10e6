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
plain versions see: bool, int8, uint8, int16, int32, int64, float16,
bfloat16, float32 (the default float, which torch gives booleans,
integers and Python floats combined), float64, or the operands' ``T``.
Python numbers are wrapped scalars and do not promote; 0-d tensor
constants promote by category, constants of the operands' shape
(``zeros_like``, ``ones_like``, ``full_like``) as tensors. Each node's
dtype is what the torch function itself returns on dummy tensors of its
operands' dtypes, so the promotion rules, and the refusals (``-`` of
booleans, a negative integer power, ``hypot`` of integers), are torch's
own. Each op is emitted in its computation type (comparisons in the
operands' common type, logical ops in bool, predicates in the operand's
own), and the result is cast to ``T``, as ``merge_join_plain``'s
``merge(a, b).to(a.dtype)`` does. A constant is converted to the type an
op computes in as torch converts it (a Python float is rounded to
float32 in a float32 op). Casts convert as c10::convert does
(``merge.cuh``'s ``f2i`` for a float to an integer). A float16 or
bfloat16 value is held in a float and rounded to its type after each op,
as torch computes such ops in float32; a constant in such an op must be
exact in the reduced type (torch rounds it to that type on the CPU and
keeps it in float32 on the card), else the merge is refused. Integer ops
compute in their own width and wrap.

The op set: ``+ - * / // % **``, unary ``-``, ``abs``, ``& | ^ ~ << >>``,
``< <= > >= == !=``, casts (``.to(dtype)``, ``.to(tensor)``, ``.type``,
``.type_as``, ``.float()`` ... ``.bool()``), ``zeros_like``,
``ones_like``, ``full_like``, and the torch functions and tensor methods
named in ``_FUNCS``: ``add``/``sub`` (with ``alpha``), ``mul``, ``div``
(with ``rounding_mode``), ``floor_divide``, ``remainder``, ``fmod``,
``pow``, ``float_power``, ``ldexp``, ``square``, ``reciprocal``,
``maximum``/``minimum`` (``max``/``min`` of two tensors), ``fmax``,
``fmin``, ``clamp``/``clip``/``clamp_min``/``clamp_max``, ``relu``,
``atan2``, ``hypot``, ``copysign``, ``sign``/``sgn``, ``nextafter``,
``heaviside``, ``logaddexp``, ``logaddexp2``, ``exp``, ``exp2``,
``expm1``, ``log``, ``log2``, ``log10``, ``log1p``, ``sqrt``, ``rsqrt``,
``sigmoid``, ``erf``, ``erfc``, ``erfinv``, the trigonometric and
hyperbolic functions and their inverses, ``sinc``, ``deg2rad``,
``rad2deg``, ``floor``, ``ceil``, ``round`` (half to even; with
``decimals``), ``trunc``, ``frac``, ``nan_to_num``, ``isnan``, ``isinf``,
``isfinite``, ``isposinf``, ``isneginf``, ``isreal``, ``isclose``,
``signbit``, ``logical_and/or/xor/not``, ``bitwise_*`` (shifts too),
``gcd``, ``lcm``, ``where``; the ``torch.special`` functions that
``jax.scipy.special`` has (``gammaln``/``lgamma``, ``psi``/``digamma``,
``polygamma``, ``zeta``, ``ndtr``, ``ndtri``, ``log_ndtr``, ``i0``,
``i0e``, ``i1``, ``i1e``, ``entr``, ``xlogy``, ``xlog1py``, ``logit``,
``expit``, and the aliases of ops above); the activations of
``torch.nn.functional`` that ``jax.nn`` has (``gelu`` both forms,
``silu``, ``softplus``, ``elu``, ``selu``, ``celu``, ``leaky_relu``,
``hardtanh``, ``relu6``, ``hardsigmoid``, ``hardswish``, ``logsigmoid``,
``softsign``, ``mish``). Powers are lowered as torch computes them, so
that the bits match: ``x**2`` is ``x*x``, ``x**3`` ``x*x*x``, ``x**-1``
``1/x``, ``x**-2`` ``1/(x*x)``, ``x**0.5`` ``sqrt``, ``x**-0.5``
``rsqrt``, ``x**0`` 1 and ``x**1`` ``x``; other exponents run ``pow``.
A bound of ``clamp`` that is a Python number keeps clamp's own rule, one
that is a tensor is ``maximum``/``minimum`` (as torch computes a tensor
bound). Composites of torch (``ndtr``, ``softsign``, ``isclose``,
``ldexp``, ``float_power``, ``round`` with ``decimals``) are traced as
torch computes them, op by op. There is no limit on the merge's length.

``merge_code`` raises ``NotImplementedError``, naming the cause, before
anything is built or launched, for a Python branch on a value (``bool``
of a symbol; the JAX package's tracer raises there too), a tensor
constant that is not 0-d, a non-elementwise or random op, an op outside
the set (complex values, ``torch.special`` functions without a
``jax.scipy.special`` counterpart, ``gammainc``), ``empty_like``
(uninitialised values), a device move inside ``.to()``, an in-place
activation and ``mvlgamma`` (torch checks its data and raises). ``registry.REFUSALS`` counts these as refusals that
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


# the dtypes a node may take, and their C++ types (csrc/merge.cuh: i8 ...
# i64); float16 and bfloat16 values are held in float, rounded to their
# type after each op (_REDUCED: merge.cuh's r_f16, r_bf16)
_CTYPES = {torch.bool: "bool", torch.int8: "i8", torch.uint8: "u8",
           torch.int16: "i16", torch.int32: "i32", torch.int64: "i64",
           torch.float16: "float", torch.bfloat16: "float",
           torch.float32: "float", torch.float64: "double"}
_REDUCED = {torch.float16: "r_f16", torch.bfloat16: "r_bf16"}
_INTS = frozenset({torch.int8, torch.uint8, torch.int16, torch.int32,
                   torch.int64})
# a Python number's kind, and the dtype torch holds it in before an op
# converts it
_SCALARS = {"bool": torch.bool, "int": torch.int64, "float": torch.float64}


class _Graph:
    """Hash-consed nodes: ("x",), ("y",), ("k", kind, bits) for a constant
    (``consts`` holds its value), ("c", kind, bits) for a constant of the
    operands' shape (``zeros_like``, ...: it promotes as a tensor, not as
    a 0-d constant), ("cast:<dtype>", id) for a cast, (op, ids...) for an
    op. ``dtypes`` holds each node's dtype (a constant's: its own, a
    Python number's None) and ``compute`` each op node's operands'
    computation dtypes."""

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

    def const(self, kind: str, value, shaped: bool = False) -> int:
        # keyed by the bits: -0.0 == 0.0 and nan != nan as floats
        bits = float(value).hex() if isinstance(value, float) else value
        nid = self.node(("c" if shaped else "k", kind, bits),
                        None if kind in _SCALARS else getattr(torch, kind))
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
    def __lshift__(self, o): return _FUNCS["bitwise_left_shift"](self, o)
    def __rlshift__(self, o): return _FUNCS["bitwise_left_shift"](o, self)
    def __rshift__(self, o): return _FUNCS["bitwise_right_shift"](self, o)
    def __rrshift__(self, o): return _FUNCS["bitwise_right_shift"](o, self)

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
                                               "i_floor_div({0}, {1})")),
    "remainder": _Op(torch.remainder, _f("m_remainder({0}, {1})",
                                         "i_remainder({0}, {1})")),
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
_F = torch.nn.functional
_OPS.update({
    # activations (torch.nn.functional; merge_special.cuh)
    "gelu": _Op(_F.gelu, _f("m_gelu({0})")),
    "gelu_tanh": _Op(functools.partial(_F.gelu, approximate="tanh"),
                     _f("m_gelu_tanh({0})")),
    "silu": _Op(_F.silu, _f("m_silu({0})")),
    "softplus": _Op(lambda a, beta, threshold: _F.softplus(a),
                    _f("m_softplus({0}, {1}, {2})")),
    "elu": _Op(lambda a, alpha, scale, input_scale: _F.elu(a),
               _f("m_elu({0}, {1}, {2}, {3})")),
    "leaky_relu": _Op(lambda a, slope: _F.leaky_relu(a),
                      _f("m_leaky_relu({0}, {1})")),
    "hardsigmoid": _Op(_F.hardsigmoid, _f("m_hardsigmoid({0})")),
    "hardswish": _Op(_F.hardswish, _f("m_hardswish({0})")),
    "log_sigmoid": _Op(_F.logsigmoid, _f("m_log_sigmoid({0})")),
    "mish": _Op(_F.mish, _f("m_mish({0})")),
    # other elementwise functions of jnp
    "logaddexp": _Op(torch.logaddexp, _f("m_logaddexp({0}, {1})")),
    "logaddexp2": _Op(torch.logaddexp2, _f("m_logaddexp2({0}, {1})")),
    "nan_to_num": _Op(lambda a, nan, posinf, neginf: torch.nan_to_num(a),
                      _f("m_nan_to_num({0}, {1}, {2}, {3})")),
    "heaviside": _Op(torch.heaviside, _f("m_heaviside({0}, {1})",
                                         "({0} == 0 ? {1} : ({0} > 0))",
                                         "({0} ? true : {1})")),
    "sinc": _Op(torch.sinc, _f("m_sinc({0})")),
    "nextafter": _Op(torch.nextafter, _f("m_nextafter({0}, {1})")),
    "gcd": _Op(torch.gcd, {"i": "i_gcd({0}, {1})"}),
    "lcm": _Op(torch.lcm, {"i": "i_lcm({0}, {1})"}),
    "bitwise_left_shift": _Op(torch.bitwise_left_shift,
                              {"i": "i_shl({0}, {1})"}),
    "bitwise_right_shift": _Op(torch.bitwise_right_shift,
                               {"i": "i_shr({0}, {1})"}),
    # the special functions of jax.scipy.special
    "lgamma": _Op(torch.lgamma, _f("m_lgamma({0})")),
    "digamma": _Op(torch.digamma, _f("m_digamma({0})")),
    "erfinv": _Op(torch.erfinv, _f("m_erfinv({0})")),
    "ndtri": _Op(torch.special.ndtri, _f("m_ndtri({0})")),
    "log_ndtr": _Op(torch.special.log_ndtr, _f("m_log_ndtr({0})")),
    "i0": _Op(torch.i0, _f("m_i0({0})")),
    "i0e": _Op(torch.special.i0e, _f("m_i0e({0})")),
    "i1": _Op(torch.special.i1, _f("m_i1({0})")),
    "i1e": _Op(torch.special.i1e, _f("m_i1e({0})")),
    "entr": _Op(torch.special.entr, _f("m_entr({0})")),
    "xlogy": _Op(torch.xlogy, _f("m_xlogy({0}, {1})")),
    "xlog1py": _Op(torch.special.xlog1py, _f("m_xlog1py({0}, {1})")),
    "logit": _Op(torch.logit, _f("m_logit({0})")),
    "logit_eps": _Op(lambda a, eps: torch.logit(a, 0.25),
                     _f("m_logit_eps({0}, {1})")),
    "zeta": _Op(torch.special.zeta, _f("m_zeta({0}, {1})")),
    "trigamma": _Op(functools.partial(torch.polygamma, 1),
                    _f("m_trigamma({0})")),
})

_CATEGORY = {torch.bool: "b", **dict.fromkeys(_INTS, "i"),
             **dict.fromkeys((torch.float16, torch.bfloat16, torch.float32,
                              torch.float64), "f")}

# ops whose CUDA code carries a long slow path or a loop, where one row a
# thread was measured faster on an H100 (PERF.md, merges table and
# plans): a division, remainder, fmod or truncating division (taken on
# every zero divisor, and a sparse matrix is mostly zeros), a sine's or
# cosine's argument reduction (its registers), lgamma's reflection,
# digamma's recurrence, ndtri's tails, zeta's and polygamma's (of any
# order n >= 2: "polygamma<n>") series. tan and erfinv were measured
# faster streaming; an op not measured keeps the streaming plan.
SLOW_PATH_OPS = frozenset({"div", "floor_divide", "remainder", "sin", "cos",
                           "fmod", "div_trunc", "lgamma", "digamma", "ndtri",
                           "zeta", "polygamma"})


def _slow(op: str) -> bool:
    return op.rstrip("0123456789") in SLOW_PATH_OPS


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
    for o, d in zip(operands, compute):
        if d in _REDUCED and not isinstance(o, _Sym) \
                and not _exact_in(*_constant(o), d):
            # torch rounds such a constant to the storage type on the CPU
            # and keeps it in float32 on the card
            raise _Refused(f"the constant {_constant(o)[1]!r} in a {d} op "
                           f"({op}): not exact in {d}")
    if op == "nextafter" and compute[0] in _REDUCED:
        raise _Refused(f"nextafter of {compute[0]} (it steps in the storage "
                       "type)")
    ids = tuple(o.id if isinstance(o, _Sym) else g.const(*_constant(o))
                for o in operands)
    nid = g.node((op, *ids), out.dtype)
    g.compute[nid] = compute
    return _Sym(g, nid)


def _exact_in(kind: str, value, dtype: torch.dtype) -> bool:
    """Whether a constant keeps its value in ``dtype``."""
    a = torch.tensor(value, dtype=_SCALARS.get(kind) or getattr(torch, kind))
    b = a.to(dtype)
    return bool(torch.isnan(a)) or bool(a.double() == b.double())


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


# casts, constructors and composites ------------------------------------

_CAST_METHODS = {"float": torch.float32, "double": torch.float64,
                 "half": torch.float16, "bfloat16": torch.bfloat16,
                 "int": torch.int32, "long": torch.int64,
                 "short": torch.int16, "char": torch.int8,
                 "byte": torch.uint8, "bool": torch.bool}


def _cast(x: _Sym, dtype) -> _Sym:
    """``x`` converted to ``dtype`` as torch's ``.to`` converts it."""
    if not isinstance(dtype, torch.dtype):
        raise _Refused(f"a cast to {dtype!r} (only to a dtype)")
    if dtype not in _CTYPES:
        raise _Refused(f"a value of dtype {dtype} (a cast)")
    if x.dtype == dtype:
        return x
    return _Sym(x.g, x.g.node((f"cast:{str(dtype)[6:]}", x.id), dtype))


def _to(x, *args, dtype=None, device=None, non_blocking=False, copy=False,
        memory_format=None):
    """``Tensor.to(dtype)``, ``.to(other)``, ``.to(dtype=...)``; a device
    move is refused."""
    target = list(args) + ([dtype] if dtype is not None else [])
    if device is not None or len(target) != 1 \
            or memory_format not in (None, torch.preserve_format):
        raise _Refused(f".to() with arguments {args!r} (a device move, a "
                       "memory format, or not one dtype)")
    t = target[0]
    if isinstance(t, (_Sym, torch.Tensor)):
        t = t.dtype
    if not isinstance(t, torch.dtype):
        raise _Refused(f"a device move inside .to() ({t!r})")
    return _cast(x, t)


def _type(x, dtype=None, non_blocking=False):
    if not isinstance(dtype, torch.dtype):
        raise _Refused(f"Tensor.type({dtype!r}) (only a dtype)")
    return _cast(x, dtype)


def _like(fill):
    """``zeros_like``, ``ones_like``, ``full_like``: a typed constant of
    the operands' shape."""
    def call(x, *args, dtype=None, layout=None, device=None,
             requires_grad=False, memory_format=None, pin_memory=None):
        value = args[0] if fill is None and len(args) == 1 else fill
        if value is None or (fill is not None and args):
            raise _Refused(f"{'full' if fill is None else 'a'}_like with "
                           f"arguments {args!r}")
        if device is not None or requires_grad:
            raise _Refused("a device or requires_grad in a *_like")
        if not isinstance(x, _Sym):
            raise _Refused("a *_like of a constant")
        cv = None if isinstance(value, (_Sym, torch.Tensor)) \
            else _constant(value)
        if cv is None:
            raise _Refused("a fill value that is not a number")
        dtype = dtype or x.dtype
        if dtype not in _CTYPES:
            raise _Refused(f"a value of dtype {dtype} (a *_like)")
        v = torch.tensor(cv[1], dtype=_SCALARS[cv[0]]).to(dtype).item()
        return _Sym(x.g, x.g.const(str(dtype)[6:], v, shaped=True))
    return call


def _empty_like(*args, **kw):
    raise _Refused("empty_like (uninitialised values)")


def _no_inplace(name, inplace):
    if inplace:
        raise _Refused(f"an in-place {name}")


def _act(name, *params):
    """An activation of x alone with keyword parameters (their defaults);
    ``inplace=True`` is refused."""
    def call(x, *args, inplace=False, **kw):
        _no_inplace(name, inplace)
        names = [p for p, _ in params]
        vals = dict(params)
        for k, v in zip(names, args):
            vals[k] = v
        for k, v in kw.items():
            if k not in vals:
                raise TypeError(f"unexpected keyword {k!r}")
            vals[k] = v
        return _node(name, x, *(vals[k] for k in names))
    return call


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _gelu(x, approximate="none"):
    if approximate not in ("none", "tanh"):
        raise _Refused(f"gelu with approximate={approximate!r}")
    return _node("gelu" if approximate == "none" else "gelu_tanh", x)


def _elu(x, alpha=1.0, inplace=False):
    _no_inplace("elu", inplace)
    return _node("elu", x, alpha, 1.0, 1.0)


def _selu(x, inplace=False):
    _no_inplace("selu", inplace)
    return _node("elu", x, _SELU_ALPHA, _SELU_SCALE, 1.0)


def _celu(x, alpha=1.0, inplace=False):
    _no_inplace("celu", inplace)
    return _node("elu", x, alpha, 1.0, 1.0 / float(alpha))


def _hardtanh(x, min_val=-1.0, max_val=1.0, inplace=False):
    _no_inplace("hardtanh", inplace)
    try:                                 # torch refuses integers there
        _F.hardtanh(_dummy(x), min_val, max_val)
    except Exception as exc:
        raise _Refused(f"hardtanh of {x.dtype}: {exc}") from None
    return _clamp(x, min_val, max_val)


def _softsign(x):
    # torch.nn.functional.softsign: input / (input.abs() + 1)
    return _node("div", x, _node("add", _node("abs", x), 1))


def _round(x, decimals=0):
    """``torch.round``; with ``decimals`` aten's round_decimals:
    nearbyint(x * 10^d) / 10^d (nearbyint(x / 10^-d) * 10^-d for d < 0)."""
    if isinstance(decimals, _Sym) or not isinstance(decimals, int):
        raise _Refused("round with decimals that is not a Python int")
    if decimals == 0:
        return _node("round", x)
    p = float(10 ** abs(decimals))
    if decimals > 0:
        return _node("div", _node("round", _node("mul", x, p)), p)
    return _node("mul", _node("round", _node("div", x, p)), p)


def _ndtr(x):
    # aten's special_ndtr: (1 + erf(x * M_SQRT1_2)) * 0.5
    return _node("mul", _node("add", 1, _node(
        "erf", _node("mul", x, 0.70710678118654752440))), 0.5)


def _float_power(a, b):
    """``torch.float_power``: both in float64 (a Python exponent stays a
    number, as torch's pow takes it)."""
    a = _cast(a, torch.float64) if isinstance(a, _Sym) else a
    if isinstance(b, _Sym):
        b = _cast(b, torch.float64)
    elif isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    if not isinstance(a, _Sym):
        a = float(a) if not isinstance(a, torch.Tensor) \
            else a.to(torch.float64)
    return _pow(a, b)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    """aten's isclose: a == b, or (both NaN), or a finite |a - b| within
    atol + |rtol * b|."""
    try:
        torch.isclose(_dummy(a), _dummy(b))
    except Exception as exc:
        raise _Refused(f"isclose of these dtypes: {exc}") from None
    close = _node("eq", a, b)
    if equal_nan:
        close = _node("bitwise_or", close, _node(
            "bitwise_and", _node("isnan", a), _node("isnan", b)))
    if rtol == 0 and atol == 0:
        return close
    cast = (lambda t: _cast(t, torch.float32)
            if isinstance(t, _Sym) and t.dtype == torch.bool else t)
    a, b = cast(a), cast(b)
    allowed = _node("add", atol, _node("abs", _node("mul", rtol, b)))
    actual = _node("abs", _node("sub", a, b))
    return _node("bitwise_or", close, _node(
        "bitwise_and", _node("isfinite", actual), _node("le", actual,
                                                         allowed)))


def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    if not isinstance(x, _Sym):
        raise _Refused("nan_to_num of a constant")
    if x.dtype not in _REDUCED and _CATEGORY[x.dtype] != "f":
        return x                       # integers and booleans: unchanged
    fi = torch.finfo(x.dtype)
    return _node("nan_to_num", x, 0.0 if nan is None else nan,
                 fi.max if posinf is None else posinf,
                 fi.min if neginf is None else neginf)


def _logit(x, eps=None):
    if eps is None or eps < 0:
        return _node("logit", x)
    return _node("logit_eps", x, float(eps))


def _polygamma(n, x):
    """``torch.polygamma(n, x)``: digamma for n = 0, trigamma for 1, else
    an op of its own n (``(-1)^(n+1) n! zeta(n + 1, x)``)."""
    if isinstance(n, _Sym) or not isinstance(n, int) or n < 0:
        raise _Refused(f"polygamma of order {n!r} (a Python int >= 0)")
    if n < 2:
        return _node(("digamma", "trigamma")[n], x)
    op = f"polygamma{n}"
    if op not in _OPS:
        _OPS[op] = _Op(functools.partial(torch.polygamma, n),
                       _f(f"m_polygamma({{0}}, {n})"))
    return _node(op, x)


def _mvlgamma(*args, **kw):
    raise _Refused("mvlgamma checks its data (every element > (p-1)/2) "
                   "and raises otherwise, a check no kernel lane can make")


def _isreal(x):
    return _like(True)(x, dtype=torch.bool)


_M_PI_180 = float("0.017453292519943295769236907684886127134428718885417")
_M_180_PI = float("57.295779513082320876798154814105170332405472466564")


def _op(name, reflected=False):
    if reflected:
        return lambda a, b: _node(name, b, a)
    return lambda *a: _node(name, *a)


# torch functions and tensor methods by name (reflected dunders take the
# symbol second)
_FUNCS: Dict[str, Callable] = {name: _op(name) for name in _OPS}
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
    "__lshift__": _op("bitwise_left_shift"),
    "__rlshift__": _op("bitwise_left_shift", True),
    "__rshift__": _op("bitwise_right_shift"),
    "__rrshift__": _op("bitwise_right_shift", True),
    # aliases of ops in the set
    "special_erf": _op("erf"), "special_erfc": _op("erfc"),
    "special_exp2": _op("exp2"), "special_expm1": _op("expm1"),
    "special_log1p": _op("log1p"), "special_expit": _op("sigmoid"),
    "round": _round, "special_round": _round, "sgn": _op("sign"),
    # casts and constructors
    "zeros_like": _like(0), "ones_like": _like(1), "full_like": _like(None),
    "empty_like": _empty_like,
    # activations
    "gelu": _gelu, "silu": _act("silu"),
    "softplus": _act("softplus", ("beta", 1.0), ("threshold", 20.0)),
    "elu": _elu, "selu": _selu, "celu": _celu,
    "leaky_relu": _act("leaky_relu", ("negative_slope", 0.01)),
    "hardtanh": _hardtanh,
    "relu6": lambda x, inplace=False: _hardtanh(x, 0.0, 6.0, inplace),
    "hardsigmoid": _act("hardsigmoid"), "hardswish": _act("hardswish"),
    "log_sigmoid": _op("log_sigmoid"),
    "softsign": _softsign, "mish": _act("mish"),
    # other elementwise functions of jnp
    "nan_to_num": _nan_to_num, "float_power": _float_power,
    "ldexp": lambda a, b: _node("mul", a, _pow(2.0, b)),
    "deg2rad": lambda x: _node("mul", x, _M_PI_180),
    "rad2deg": lambda x: _node("mul", x, _M_180_PI),
    "special_sinc": _op("sinc"), "isclose": _isclose,
    "isposinf": lambda x: _node("eq", x, math.inf),
    "isneginf": lambda x: _node("eq", x, -math.inf),
    "isreal": _isreal,
    # the special functions of jax.scipy.special
    "special_gammaln": _op("lgamma"), "special_psi": _op("digamma"),
    "special_digamma": _op("digamma"), "special_erfinv": _op("erfinv"),
    "special_ndtr": _ndtr, "special_ndtri": _op("ndtri"),
    "special_log_ndtr": _op("log_ndtr"), "special_i0": _op("i0"),
    "special_i0e": _op("i0e"), "special_i1": _op("i1"),
    "special_i1e": _op("i1e"), "special_entr": _op("entr"),
    "special_xlogy": _op("xlogy"), "special_xlog1py": _op("xlog1py"),
    "logit": _logit, "special_logit": _logit,
    "special_zeta": _op("zeta"), "polygamma": _polygamma,
    "special_polygamma": _polygamma, "mvlgamma": _mvlgamma,
    "special_multigammaln": _mvlgamma,
})
# tensor methods of the symbol (``x.exp()``, ``x.clamp(min=0)``, ...: the
# names of _FUNCS that torch.Tensor has); ``x.where(cond, other)`` is
# ``torch.where(cond, x, other)``
_METHODS: Dict[str, Callable] = {
    name: fn for name, fn in _FUNCS.items()
    if not name.startswith("__") and hasattr(torch.Tensor, name)}
_METHODS["where"] = lambda x, condition, other: _node(
    "where", condition, x, other)
_METHODS.update({name: functools.partial(_cast, dtype=dt)
                 for name, dt in _CAST_METHODS.items()})
_METHODS.update({"to": _to, "type": _type,
                 "type_as": lambda x, other: _to(x, other),
                 "polygamma": lambda x, n: _polygamma(n, x)})

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
    converts it for an op computing in ``dtype`` (a float16/bfloat16
    value as the float that holds it)."""
    src = _SCALARS.get(kind) or getattr(torch, kind)
    try:
        v = torch.tensor(value, dtype=src).to(dtype)
    except (RuntimeError, OverflowError) as exc:
        raise _Refused(f"the constant {value!r}: {exc}") from None
    if dtype == torch.bool:
        return "true" if v.item() else "false"
    if dtype in _INTS:
        i = v.item()
        if dtype != torch.int64:
            return f"(({_CTYPES[dtype]})({i}))"
        return "(-9223372036854775807LL - 1)" if i == -2 ** 63 \
            else f"({i}LL)"
    if dtype in _REDUCED:
        v, dtype = v.float(), torch.float32
    f = v.item()
    if not math.isfinite(f):
        if dtype == torch.float32:
            return f"f32_bits(0x{v.view(torch.int32).item() & 0xffffffff:08x}u)"
        return f"f64_bits(0x{v.view(torch.int64).item() & (1 << 64) - 1:016x}ull)"
    return f"({f.hex()}{'f' if dtype == torch.float32 else ''})"


def _convert(expr: str, src: torch.dtype, dst: torch.dtype) -> str:
    """A C++ value of torch dtype ``src`` converted to ``dst`` as torch
    converts it (c10::convert)."""
    if src == dst:
        return expr
    if dst == torch.bool:
        return f"({expr} != 0)"
    if dst in _REDUCED:
        if src not in (torch.float32,) + tuple(_REDUCED):
            expr = f"((float){expr})"
        return f"{_REDUCED[dst]}({expr})"
    if dst in _INTS and _CATEGORY[src] == "f":
        return f"f2i<{_CTYPES[dst]}>({expr})"
    if _CTYPES[dst] == _CTYPES[src]:                 # float16 to float32
        return expr
    return f"(({_CTYPES[dst]}){expr})"


def _value(g: _Graph, nid: int, dtype: torch.dtype) -> str:
    """Node ``nid`` as an expression of ``dtype``."""
    key = g.nodes[nid]
    if key[0] in ("k", "c"):
        return _literal(*g.consts[nid], dtype)
    name = key[0] if key[0] in ("x", "y") else f"v{nid}"
    return _convert(name, g.dtypes[nid], dtype)


_LEAVES = ("x", "y", "k", "c")


def _functor(g: _Graph, root: int, t: torch.dtype) -> str:
    need, stack = set(), [root]
    while stack:
        n = stack.pop()
        if n not in need:
            need.add(n)
            if g.nodes[n][0] not in _LEAVES:
                stack.extend(g.nodes[n][1:])
    ct = _CTYPES[t]
    lines = [f"template <> struct Merge<{ct}> {{"]
    if any(_slow(g.nodes[n][0]) for n in need):
        lines.append("  static constexpr bool kSlowPaths = true;")
    lines.append(f"  MERGE_HD {ct} operator()({ct} x, {ct} y) const {{")
    for n in sorted(need):
        op, *args = g.nodes[n]
        if op in _LEAVES:
            continue
        if op.startswith("cast:"):
            expr = _value(g, args[0], g.dtypes[n])
        else:
            compute = g.compute[n]
            expr = _OPS[op].c[_CATEGORY[compute[-1]]].format(
                *(_value(g, a, d) for a, d in zip(args, compute)))
            if g.dtypes[n] in _REDUCED:
                expr = f"{_REDUCED[g.dtypes[n]]}({expr})"
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
