"""Sparsity-inducing merge-function detection (paper §4.7).

A merge function f(x, y) is sparsity-inducing on x if f(0, ·) ≡ 0 (and
symmetrically on y). For the family of linear functions and their linear
combinations — f(x,y) = g(x)·y + h(x) with g, h linear — the paper's sampling
test is exact: probe f(0, s₁) and f(0, s₂) for two nonzero random s; both
zero ⟺ g(0) = h(0) = 0 ⟺ inducing. We implement exactly that test (plus a
handful of extra probes for robustness against pathological nonlinear fns).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.expr import MergeFn


@dataclasses.dataclass(frozen=True)
class SparsityProfile:
    inducing_x: bool  # f(0, y) == 0 for all y: zero blocks of A can be skipped
    inducing_y: bool  # f(x, 0) == 0 for all x: zero blocks of B can be skipped

    @property
    def any(self) -> bool:
        return self.inducing_x or self.inducing_y


_PROBES = (0.7548776662466927, -1.3247179572447458, 2.718281828459045)


def _probe(fn, zero_first: bool) -> bool:
    # the merge sees 0-d float32 tensors, so torch functions evaluate as
    # jnp's do on the JAX package's Python floats (torch.where and
    # torch.maximum refuse Python floats; float32 is jnp's weak scalar type)
    for s in _PROBES:
        x, y = (0.0, s) if zero_first else (s, 0.0)
        x, y = torch.tensor(x), torch.tensor(y)
        try:
            # read through torch: numpy has no bfloat16
            t = torch.as_tensor(fn(x, y)).to(torch.float64).item()
        except Exception:
            return False
        if not math.isfinite(t) or t != 0.0:
            return False
    return True


def analyze_merge(merge: MergeFn) -> SparsityProfile:
    """Sampling-based sparsity-inducing test (cached by merge-fn name)."""
    return _analyze_cached(merge.name, merge.fn)


_CACHE = {}


def _analyze_cached(name: str, fn) -> SparsityProfile:
    prof = _CACHE.get(name)
    if prof is None:
        prof = SparsityProfile(inducing_x=_probe(fn, True),
                               inducing_y=_probe(fn, False))
        _CACHE[name] = prof
    return prof


# Common merge functions, pre-named for convenience.
def product_merge() -> MergeFn:
    return MergeFn("mul", lambda x, y: x * y)


def sum_merge() -> MergeFn:
    return MergeFn("add", lambda x, y: x + y)


def left_merge() -> MergeFn:
    return MergeFn("left", lambda x, y: x)


def safe_div(x, y):
    """x / y with 0/0 := 0, elementwise (module level so the kernel layer
    can recognise it: ``kernels.merge_codes`` maps it to ``SAFE_DIV``)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return torch.where(x == 0, 0.0, x / torch.where(y == 0, 1.0, y))


def safe_div_merge() -> MergeFn:
    """x / y with 0/0 := 0 (used by PNMF's A/(W×H) on sparse A)."""
    return MergeFn("safediv", safe_div)
