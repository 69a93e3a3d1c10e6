"""``merge_join`` with B as a transposed view, on the CPU: the plain
version on ``(a, Bo.T)`` against the JAX package's dense backend on
``jnp.asarray(Bo).T``, a transpose overlay through ``Session(device="cpu")``
that takes the kernel route against the reference's ``collect()``, and the
wrapper's layout rule (``b_layout``), a pure function of shape and strides.

Tolerances: the reference's (``tests/test_torch_kernels.py``): f32
atol/rtol 1e-5, f64 atol 1e-10."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.core.sparsity import product_merge as j_product_merge
from repro.kernels import registry as jreg
from repro_torch.core import Session
from repro_torch.core.sparsity import product_merge
from repro_torch.kernels import registry
from repro_torch.kernels.merge_join import (
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, b_layout, merge_join_plain,
)

MERGES = {
    "mul": lambda x, y: x * y,
    "add": lambda x, y: x + y,
    "affine": lambda x, y: 2.0 * x * y + x,
}


@contextlib.contextmanager
def _x64(dtype):
    if dtype != "float64":
        yield
        return
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,bs", [((1024, 768), 256), ((300, 257), 128),
                                      ((512, 510), 256)])
@pytest.mark.parametrize("mode", [MODE_BOTH, MODE_X, MODE_Y, MODE_ALL])
def test_merge_join_plain_on_a_transposed_view_matches_reference(
        mode, shape, bs, dtype):
    rng = np.random.default_rng(11)
    m, n = shape
    grid = (-(-m // bs), -(-n // bs))
    a = rng.normal(size=shape).astype(dtype)
    bo = rng.normal(size=(n, m)).astype(dtype)       # B = Boᵀ
    ma = rng.uniform(size=grid) < 0.6
    mb = rng.uniform(size=grid) < 0.6
    tb = torch.as_tensor(bo).T
    assert b_layout(tuple(tb.shape), tb.stride()) == ("transposed", m)
    tol = dict(atol=1e-5 if dtype == "float32" else 1e-10, rtol=1e-5)
    for name, fn in MERGES.items():
        with _x64(dtype):
            want = np.asarray(jreg.dispatch(
                "merge_join", jnp.asarray(a), jnp.asarray(bo).T,
                jnp.asarray(ma), jnp.asarray(mb), backend=jreg.DENSE,
                merge=fn, mode=mode, block_size=bs))
        got = merge_join_plain(torch.as_tensor(a), tb, torch.as_tensor(ma),
                               torch.as_tensor(mb), merge=fn, mode=mode,
                               block_size=bs)
        assert got.dtype == torch.as_tensor(a).dtype
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **tol)


def _blocky(rng, n, bs, empty):
    v = np.round(rng.normal(size=(n, n)), 1).astype(np.float32)
    g = n // bs
    for k in empty:
        v[(k // g) * bs:(k // g + 1) * bs, (k % g) * bs:(k % g + 1) * bs] = 0
    return v


def test_transpose_overlay_takes_the_kernel_route_with_b_as_a_view(
        monkeypatch):
    """A ⋈[RID=CID ∧ CID=RID] B with a live block share of 11/16: the
    staged overlay dispatches ``merge_join`` once, with B as the view
    ``Bᵀ`` (no copy), and the result equals the reference's."""
    rng = np.random.default_rng(4)
    a = _blocky(rng, 128, 32, (0, 5, 10, 15))
    b = _blocky(rng, 128, 32, (3,))
    layouts = []
    spec = registry.get("merge_join")
    inner = spec.impls[registry.TORCH]

    def counted(a_, b_, *args, **kw):
        layouts.append(b_layout(tuple(b_.shape), b_.stride()))
        return inner(a_, b_, *args, **kw)
    monkeypatch.setitem(spec.impls, registry.TORCH, counted)
    s = Session(block_size=32, device="cpu")
    q = s.load(a, "A").join(s.load(b, "B"), "RID=CID AND CID=RID",
                            product_merge())
    got = q.collect()
    assert layouts == [("transposed", 128)]
    live = q.physical_plan().node(q.physical_plan().root).meta["mask"]
    assert live.mean() == 11 / 16
    js = JSession(block_size=32)
    want = js.load(a, "A").join(js.load(b, "B"), "RID=CID AND CID=RID",
                                j_product_merge()).collect()
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.value.numpy(), a * b.T)
    assert np.array_equal(got.block_mask.numpy(), np.asarray(want.block_mask))


@pytest.mark.parametrize("shape,strides,want", [
    ((300, 257), (257, 1), ("direct", 257)),       # contiguous
    ((300, 257), (1, 300), ("transposed", 300)),   # Bo.T of a contiguous Bo
    ((300, 257), (512, 1), ("copy", 257)),         # a column slice
    ((300, 257), (1, 512), ("transposed", 512)),   # Bo[:, :300].T
    ((300, 257), (514, 2), ("copy", 257)),         # every other column
    ((300, 257), (2, 600), ("copy", 257)),
    ((1, 257), (9, 3), ("transposed", 3)),         # one row, strided
    ((1, 257), (9, 1), ("direct", 257)),           # one row
    ((300, 1), (1, 7), ("direct", 1)),             # one column
    ((300, 1), (5, 7), ("copy", 1)),               # every fifth element
    ((1, 1), (4, 4), ("direct", 1)),
    ((300, 257), (0, 1), ("copy", 257)),           # a broadcast row
])
def test_b_layout_is_a_rule_of_shape_and_strides(shape, strides, want):
    assert b_layout(shape, strides) == want


def test_b_layout_of_cpu_tensors():
    bo = torch.zeros(257, 300)
    wide = torch.zeros(300, 512)
    cases = {
        "contiguous": (bo.T.contiguous(), ("direct", 257)),
        "transposed view": (bo.T, ("transposed", 300)),
        "column slice": (wide[:, :257], ("copy", 257)),
        "strided": (wide[:, ::2], ("copy", 256)),
        "transposed slice": (torch.zeros(257, 512)[:, :300].T,
                             ("transposed", 512)),
    }
    for name, (t, want) in cases.items():
        assert b_layout(tuple(t.shape), t.stride()) == want, name


@pytest.mark.parametrize("fn,slow", [
    (lambda x, y: x / y, True),
    (lambda x, y: x % y + x // y, True),
    (lambda x, y: torch.sin(x) * torch.cos(y), True),
    (lambda x, y: torch.fmod(x, y), True),
    (lambda x, y: torch.div(x, y, rounding_mode="trunc"), True),
    (lambda x, y: torch.lgamma(x) + torch.digamma(y), True),
    (lambda x, y: torch.special.ndtri(x * 0.1 + 0.5) * y, True),
    (lambda x, y: torch.special.zeta(x.abs() + 1, 2.0) * y, True),
    (lambda x, y: torch.special.polygamma(2, x) * y, True),
    # slow paths or loops too, but measured faster streaming on the card
    (lambda x, y: torch.tan(x) + y, False),
    (lambda x, y: torch.erfinv(x * 0.1) * y, False),
    (torch.maximum, False),
    (lambda x, y: torch.where(x < 10, x + y, 0.0), False),
    (lambda x, y: torch.exp(x) * torch.log1p(torch.abs(y)), False),
    (torch.atan2, False),
])
def test_generated_merges_say_whether_they_take_slow_paths(fn, slow):
    """A merge with a division, a remainder, a sine or a cosine, or with
    an op whose one-row plan was measured faster (fmod, truncating
    division, lgamma, digamma, ndtri, zeta, polygamma) says kSlowPaths in
    both functors (``merge_join`` then takes its rows one at a time); the
    host build of the same source still compiles and evaluates it."""
    from repro_torch.kernels import merge_codes as mc
    code = mc.merge_code(fn)
    assert code.op == mc.GENERATED
    assert code.source.count("static constexpr bool kSlowPaths = true;") \
        == (2 if slow else 0)
    x = torch.linspace(-3.0, 3.0, 13)
    y = torch.linspace(0.5, 4.0, 13)
    torch.testing.assert_close(mc.evaluate(code, x, y), fn(x, y),
                               atol=1e-6, rtol=1e-6)
