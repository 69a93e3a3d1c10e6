"""Merge functions as op codes the CUDA kernels can evaluate.

The JAX package traces any Python merge callable into its kernel bodies;
a compiled CUDA kernel cannot. This module turns a merge into a small op
code once, by evaluating it on a symbolic proxy that tracks a polynomial
in ``x`` and ``y`` with terms {1, x, y, xy}:

* a result of that form becomes ``BILINEAR`` with coefficients
  (c0, cx, cy, cxy) — this covers ``x*y``, ``x+y``, ``x-y``, ``left``
  (``x``) and affine mixes such as ``2xy+x``;
* the named safe division (``core.sparsity.safe_div``) becomes
  ``SAFE_DIV``: ``x == 0 ? 0 : x / (y == 0 ? 1 : y)``.

Anything else (a square, a quotient of variables, ``torch.where``)
raises ``NotImplementedError`` when a CUDA kernel is asked to run it. The
plain PyTorch versions take any callable.

Codes are cached per merge callable (not per ``MergeFn.name``: every
lambda handed to ``Matrix.join`` is named ``"f"``, and two different
lambdas must not share a code).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Tuple, Union

from repro_torch.core.expr import MergeFn

BILINEAR = 0
SAFE_DIV = 1


@dataclasses.dataclass(frozen=True)
class MergeCode:
    op: int
    coeffs: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


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
        if not isinstance(o, (int, float)) or o == 0:
            raise _NotBilinear("division")
        return self * (1.0 / o)


_CACHE: "weakref.WeakKeyDictionary[Callable, object]" = \
    weakref.WeakKeyDictionary()


def merge_code(merge: Union[MergeFn, Callable]) -> MergeCode:
    """The op code of ``merge``; raises ``NotImplementedError`` for a
    merge outside the supported family (general merges are a later item
    of the ROADMAP)."""
    from repro_torch.core.sparsity import safe_div
    fn = merge.fn if isinstance(merge, MergeFn) else merge
    try:
        hit = _CACHE.get(fn)
    except TypeError:       # not weak-referenceable (a builtin): no cache
        hit = None
    if hit is None:
        if fn is safe_div or (isinstance(merge, MergeFn)
                              and merge.name == "safediv"):
            hit = MergeCode(SAFE_DIV)
        else:
            try:
                out = fn(_Poly(0, 1, 0, 0), _Poly(0, 0, 1, 0))
                hit = MergeCode(BILINEAR, _Poly._lift(out).c)
            except Exception as exc:  # any failure: not in the family
                hit = exc
        try:
            _CACHE[fn] = hit
        except TypeError:
            pass
    if isinstance(hit, Exception):
        raise NotImplementedError(
            f"merge {getattr(fn, '__name__', fn)!r} is not bilinear in "
            "(x, y) nor the safe division, so no CUDA kernel can evaluate "
            "it (ROADMAP: general merge functions)") from hit
    return hit

