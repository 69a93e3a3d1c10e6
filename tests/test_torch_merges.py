"""General merges on the CPU: the merge compiler (``kernels.merge_codes``)
against the merges themselves, the sparsity probe against the JAX
package's, joins with general merges through the port's ``Session``
against the reference's ``collect()`` (through the plain versions, and
through stand-in ``cuda`` kernels that run the generated code), and the
float64 ``masked_matmul`` against the Pallas body in interpret mode.

The generated C++ of each merge runs here compiled for the host by g++
(``merge_codes.evaluate``, ``build.host_merge``; the helpers' host side
of ``csrc/merge.cuh``). Tolerances: bit for bit for the IEEE-exact ops,
within ``TRANSCENDENTAL_ULPS`` for the others
(``tests/torch_merge_cases.py``: ``check_host`` gives the scale and the
references for the CPU's vector math); joins exact (values, coordinates
and NaN places) for IEEE ops, atol 1e-5 for transcendental ones (float32,
the reference's tolerance); float64 products atol 1e-10
(``tests/test_kernels_fused.py``).
"""
import functools
import gc
import re

import jax
import jax.numpy as jnp
import jax.scipy.special  # noqa: F401 (jax.scipy.special.erf)
import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.core import sparsity as j_sparsity
from repro.core.expr import MergeFn as JMergeFn
from repro.kernels.masked_matmul import masked_matmul_pallas
from repro_torch.core import Session
from repro_torch.core import sparsity as t_sparsity
from repro_torch.core.expr import MergeFn
from repro_torch.core.sparsity import (
    left_merge, product_merge, safe_div, safe_div_merge, sum_merge,
)
from repro_torch.kernels import merge_codes as mc
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.coo_join import coo_expand_plain
from repro_torch.kernels.masked_matmul import masked_matmul_plain
from repro_torch.kernels.merge_join import live_tiles
from repro_torch.kernels import build
from torch_merge_cases import (
    CPU_VECTOR_MATH, GENERAL, REFUSED, check_host, operands,
)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_compiled_merge_equals_the_merge(name, dtype):
    """The emitted function, compiled for the host, on random values and
    every pair of special values, against the merge on CPU tensors."""
    fn, exact = GENERAL[name]
    code = mc.merge_code(fn)
    assert code.op == mc.GENERATED, name
    xs, ys = operands(7, dtype)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    got = mc.evaluate(code, x, y)
    assert got.dtype == x.dtype
    check_host(got, fn, x, y, exact and name not in CPU_VECTOR_MATH, name)


def _declared(source: str, dtype: str) -> list:
    """The C++ types of a functor's values, in order."""
    body = source.split(f"struct Merge<{dtype}>")[1].split("};")[0]
    return re.findall(r"const (\w+) v\d+ =", body)


def test_generated_source_of_the_gated_merge_and_its_flip():
    """``where(x < 10, x + y, 0)``: a compare, an add, a select, two
    constants in the value type; the flipped merge compares y."""
    src = mc.merge_code(GENERAL["gated"][0]).source
    assert src == """template <typename T> struct Merge;
template <> struct Merge<float> {
  MERGE_HD float operator()(float x, float y) const {
    const bool v3 = (x < (0x1.4000000000000p+3f));
    const float v4 = add_rn(x, y);
    const float v6 = (v3 ? v4 : (0x0.0p+0f));
    return v6;
  }
};
template <> struct Merge<double> {
  MERGE_HD double operator()(double x, double y) const {
    const bool v3 = (x < (0x1.4000000000000p+3));
    const double v4 = add_rn(x, y);
    const double v6 = (v3 ? v4 : (0x0.0p+0));
    return v6;
  }
};
"""
    flip = mc.merge_code(GENERAL["flipped_gated"][0]).source
    assert "const bool v3 = (y < (0x1.4000000000000p+3f));" in flip


@pytest.mark.parametrize("name,f32,f64", [
    ("bool_plus_bool", ["bool", "bool", "bool", "float", "bool", "bool",
                        "float", "float"],
     ["bool", "bool", "bool", "double", "bool", "bool", "double",
      "double"]),
    ("int_truediv", ["bool", "i64", "bool", "i64", "float", "float"],
     ["bool", "i64", "bool", "i64", "float", "double"]),
    ("f32_vs_value", ["bool", "float", "bool", "float"],
     ["bool", "float", "bool", "double"]),
    ("zero_d_f64", ["bool", "double", "double"],
     ["bool", "double", "double"]),
    ("where_consts", ["bool", "float", "float"],
     ["bool", "float", "double"]),
    ("bool_float", ["bool", "float", "float", "i64", "float", "float"],
     ["bool", "float", "double", "i64", "float", "double"]),
    ("casts", ["float", "float", "float", "float", "float", "i32", "float",
               "float"],
     ["float", "float", "float", "double", "double", "i32", "double",
      "double"]),
    ("narrow_ints", ["i8", "i16", "u8", "i16", "i16", "u8", "i16", "i8", "i16",
                     "float", "i32", "i32", "u8", "i16", "i32", "double",
                     "double", "i64", "bool", "i64", "double"],
     ["i8", "i16", "u8", "i16", "i16", "u8", "i16", "i8", "i16", "float",
      "i32", "i32", "u8", "i16", "i32", "double", "double", "i64", "bool",
      "i64", "double"]),
    ("like_typed", ["double", "float", "double", "double"],
     ["double", "double", "double", "double"]),
    ("type_as", ["float", "float", "float", "float", "float", "bool",
                 "float", "double", "float", "float", "float"],
     ["float", "double", "float", "double", "double", "bool", "double",
      "float", "double", "double"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_values_take_the_dtypes_torch_gives_them(name, f32, f64):
    """Each value is declared in the dtype torch gives it: bool + bool is
    bool, int64 / int64 float32, a float32 value against T compares in T,
    a 0-d float64 constant over a bool promotes to float64 (in the
    float32 trace too); the result is cast to T. Casts take their dtype
    (float16 and bfloat16 held in float), int8 + int16 * 3 is int16,
    uint8 // 2 uint8, int32 % 7 int32, and a constant of the operands'
    shape promotes as a tensor (ones_like(dtype=float64) * x is
    float64)."""
    src = mc.merge_code(GENERAL[name][0]).source
    assert _declared(src, "float") == f32
    assert _declared(src, "double") == f64


def test_no_limit_on_length_or_live_values():
    """The merges the register programs refused (over 32 instructions, over
    8 registers) are one declaration a node."""
    long_src = mc.merge_code(GENERAL["long"][0]).source
    assert len(_declared(long_src, "float")) == 40
    wide_src = mc.merge_code(GENERAL["wide"][0]).source
    assert len(_declared(wide_src, "double")) == 17


def test_equal_traces_share_a_key_and_units_name_their_instances():
    """Two lambdas with the same trace share one code key, so one library;
    a unit's launchers and its functor's namespace carry the key."""
    f = eval("lambda x, y: torch.erf(x) * y", {"torch": torch})
    g = eval("lambda a, b: torch.erf(a) * b", {"torch": torch})
    h = eval("lambda x, y: torch.erf(y) * x", {"torch": torch})
    cf, cg, ch = (mc.merge_code(k) for k in (f, g, h))
    assert cf is not cg and cf.key == cg.key != ch.key
    unit = build._MERGE_UNIT.format(key=cf.key, source=cf.source)
    for name in (f"namespace m_{cf.key}", f"merge_join_{cf.key}(",
                 f"coo_expand_{cf.key}("):
        assert name in unit
    assert "m_erf(x)" in cf.source and "m_erf(y)" in ch.source


def test_a_unit_that_does_not_compile_raises_with_the_log():
    """A generated unit the compiler rejects raises ``RuntimeError`` with
    the compiler's log, and nothing is cached for it."""
    bad = mc.MergeCode(mc.GENERATED, source="this is not C++;\n")
    x = torch.ones(4)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            mc.evaluate(bad, x, x)
    assert bad.key not in build._HOST_FNS


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_merges_name_their_cause(name):
    fn, cause = REFUSED[name]
    with pytest.raises(NotImplementedError, match=re.escape(cause)):
        mc.merge_code(fn)
    with pytest.raises(NotImplementedError, match="general merges"):
        mc.merge_code(fn)                    # the cached refusal too


@pytest.mark.parametrize("fn,coeffs", [
    (product_merge().fn, (0, 0, 0, 1)),
    (sum_merge().fn, (0, 1, 1, 0)),
    (lambda x, y: x - y, (0, 1, -1, 0)),
    (left_merge().fn, (0, 1, 0, 0)),
    (lambda x, y: 2.0 * x * y + x, (0, 1, 0, 2)),
    (lambda x, y: x / 4 + y * 0.1, (0, 0.25, 0.1, 0)),
    (lambda x, y: -(x * y) / 0.5 + 3, (3, 0, 0, -2)),
], ids=["mul", "add", "sub", "left", "affine", "quarter", "half"])
def test_bilinear_codes_do_not_change(fn, coeffs):
    code = mc.merge_code(fn)
    assert code.op == mc.BILINEAR
    assert code.coeffs == tuple(float(c) for c in coeffs)
    assert code.source == ""


def test_safe_division_keeps_its_code_and_division_by_three_does_not():
    for merge in (safe_div_merge(), safe_div):
        assert mc.merge_code(merge) == mc.MergeCode(mc.SAFE_DIV)
    # 1/3 has no exact float: x / 3 is a division, not a multiplication
    code = mc.merge_code(lambda x, y: x / 3)
    assert code.op == mc.GENERATED
    assert "const float v3 = div_rn(x, (0x1.8000000000000p+1f));" \
        in code.source


def test_a_cached_code_dies_with_its_callable():
    """The cache holds callables weakly and no entry refers back: when a
    merge is collected its entry goes, so a later lambda (perhaps at the
    same address) is compiled anew."""
    gc.collect()
    n0 = len(mc._CACHE)
    f = eval("lambda x, y: torch.maximum(x, y) * 2.0", {"torch": torch})
    g = eval("lambda x, y: torch.nn.functional.hardshrink(x)",
             {"torch": torch})
    assert mc.merge_code(f).op == mc.GENERATED
    with pytest.raises(NotImplementedError):
        mc.merge_code(g)
    assert len(mc._CACHE) == n0 + 2
    del f, g
    gc.collect()
    assert len(mc._CACHE) == n0
    h = eval("lambda x, y: torch.minimum(x, y)", {"torch": torch})
    assert "nan_min(x, y)" in mc.merge_code(h).source


# ---------------------------------------------------------------------------
# the sparsity probe against the JAX package's
# ---------------------------------------------------------------------------

PROBED = {
    "where_pos": (lambda x, y: jnp.where(x > 0, x * y, 0),
                  lambda x, y: torch.where(x > 0, x * y, 0)),
    "gated": (lambda x, y: jnp.where(x < 10, x + y, 0.0),
              lambda x, y: torch.where(x < 10, x + y, 0.0)),
    "maximum": (jnp.maximum, torch.maximum),
    "minimum": (jnp.minimum, torch.minimum),
    "abs_times": (lambda x, y: jnp.abs(x) * y, lambda x, y: torch.abs(x) * y),
    "xxy": (lambda x, y: x * x * y,) * 2,
    "mul": (lambda x, y: x * y,) * 2,
    "add": (lambda x, y: x + y,) * 2,
    "sub": (lambda x, y: x - y,) * 2,
    "left": (lambda x, y: x,) * 2,
    "quotient": (lambda x, y: x / y,) * 2,
    # numpy has no bfloat16: the probe reads the value through torch
    "bf16_product": (lambda x, y: jnp.multiply(x, y).astype(jnp.bfloat16),
                     lambda x, y: torch.mul(x, y).to(torch.bfloat16)),
    "f16_product": (lambda x, y: jnp.multiply(x, y).astype(jnp.float16),
                    lambda x, y: torch.mul(x, y).half()),
}


@pytest.fixture
def fresh_merge_profiles():
    """Both packages cache merge profiles by name: start from empty
    caches and restore them afterwards."""
    saved = dict(j_sparsity._CACHE), dict(t_sparsity._CACHE)
    j_sparsity._CACHE.clear()
    t_sparsity._CACHE.clear()
    yield
    for cache, old in zip((j_sparsity._CACHE, t_sparsity._CACHE), saved):
        cache.clear()
        cache.update(old)


@pytest.mark.parametrize("name", sorted(PROBED))
def test_probe_matches_reference(fresh_merge_profiles, name):
    jf, tf = PROBED[name]
    want = j_sparsity.analyze_merge(JMergeFn(f"probe_{name}", jf))
    got = t_sparsity.analyze_merge(MergeFn(f"probe_{name}", tf))
    assert (got.inducing_x, got.inducing_y) == (want.inducing_x,
                                                want.inducing_y)


@pytest.mark.parametrize("name", ["bf16_product", "f16_product"])
def test_probe_reads_reduced_dtypes_through_torch(fresh_merge_profiles,
                                                  name):
    """A product cast to bfloat16 or float16 induces sparsity on both
    sides, as the reference says (the probe once read the value with
    ``np.asarray``, which raises on bfloat16, and took the raise for
    "not inducing")."""
    jf, tf = PROBED[name]
    want = j_sparsity.analyze_merge(JMergeFn(f"reduced_{name}", jf))
    got = t_sparsity.analyze_merge(MergeFn(f"reduced_{name}", tf))
    assert (want.inducing_x, want.inducing_y) == (True, True)
    assert (got.inducing_x, got.inducing_y) == (True, True)


def _strip_backends(text: str) -> str:
    return re.sub(r"backend=\S+", "backend=*", text)


def test_gated_overlay_cost_and_explain_match_reference(
        fresh_merge_profiles):
    """``where(x > 0, x*y, 0)`` induces sparsity on both sides: the
    optimizer costs the overlay over A's live blocks alone, as the
    reference does (the probe once called it on Python floats, where
    ``torch.where`` raises, and costed every block)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 32)).astype(np.float32)
    a[:16, :16] = 0.0
    b = rng.normal(size=(32, 32)).astype(np.float32)
    jm = JMergeFn("gated_pos", PROBED["where_pos"][0])
    tm = MergeFn("gated_pos", PROBED["where_pos"][1])
    js, ts = JSession(block_size=8), Session(block_size=8, device="cpu")
    jq = js.load(a, "A").join(js.load(b, "B"), "RID=RID AND CID=CID", jm)
    tq = ts.load(a, "A").join(ts.load(b, "B"), "RID=RID AND CID=CID", tm)
    assert "(cost 1792)" in tq.explain()
    assert tq.explain() == jq.explain()
    assert _strip_backends(tq.explain(physical=True)) == _strip_backends(
        jq.explain(physical=True))
    np.testing.assert_array_equal(tq.collect().value.numpy(),
                                  np.asarray(jq.collect().value))


# ---------------------------------------------------------------------------
# joins with general merges through the Session
# ---------------------------------------------------------------------------

# name: (jnp merge, torch merge, exact)
JOIN_MERGES = {
    "gated": (lambda x, y: jnp.where(x < 10, x + y, 0.0),
              lambda x, y: torch.where(x < 10, x + y, 0.0), True),
    "gated_pos": PROBED["where_pos"] + (True,),
    "maximum": (jnp.maximum, torch.maximum, True),
    "square": (lambda x, y: x * x,) * 2 + (True,),
    "quotient": (lambda x, y: x / y,) * 2 + (True,),
    # the ops the register programs refused
    "erf": (lambda x, y: jax.scipy.special.erf(x) * y,
            lambda x, y: torch.erf(x) * y, False),
    "trig": (lambda x, y: jnp.sin(x) * jnp.cos(y) + jnp.tan(x * 0.5),
             lambda x, y: torch.sin(x) * torch.cos(y) + torch.tan(x * 0.5),
             False),
    "rounding": (lambda x, y: jnp.floor(x) + jnp.ceil(y) - jnp.round(x * 4)
                 + jnp.trunc(y * 3),
                 lambda x, y: torch.floor(x) + torch.ceil(y)
                 - torch.round(x * 4) + torch.trunc(y * 3), True),
    "remainder": (lambda x, y: jnp.remainder(x, y) + jnp.fmod(y, x),
                  lambda x, y: torch.remainder(x, y) + torch.fmod(y, x),
                  True),
    # the divisor is kept from 0: jnp.floor_divide(1, 0) is NaN, torch's
    # 1 // 0 is inf (c10::div_floor_floating)
    "floor_divide": (lambda x, y: jnp.floor_divide(x, jnp.abs(y) + 0.5),
                     lambda x, y: x // (torch.abs(y) + 0.5), True),
    "atan2_hypot": (lambda x, y: jnp.arctan2(x, y) + jnp.hypot(x, y),
                    lambda x, y: torch.atan2(x, y) + torch.hypot(x, y),
                    False),
    "fmax": (lambda x, y: jnp.fmax(x, y) - jnp.fmin(x, y * 2.0),
             lambda x, y: torch.fmax(x, y) - torch.fmin(x, y * 2.0), True),
    # one float product: XLA on the CPU contracts a product and a sum into
    # an FMA
    "int_bool": (lambda x, y: (jnp.where(x > 0, 7, -3)
                               * jnp.where(y > 1, 2, -5)
                               + ((x > 0) + (y > 0))) * y,
                 lambda x, y: (torch.where(x > 0, 7, -3)
                               * torch.where(y > 1, 2, -5)
                               + ((x > 0) + (y > 0))) * y, True),
    # casts, reduced dtypes and typed constants
    "bfloat16": (lambda x, y: (x * y).astype(jnp.bfloat16),
                 lambda x, y: (x * y).to(torch.bfloat16), True),
    "like": (lambda x, y: jnp.where(x > 0, jnp.zeros_like(x),
                                    jnp.full_like(y, 0.5)) + y,
             lambda x, y: torch.where(x > 0, torch.zeros_like(x),
                                      torch.full_like(y, 0.5)) + y, True),
    # the special functions; digamma's argument kept from 0 and the
    # negative integers, where the frameworks differ (jax NaN at ±0,
    # torch ∓inf)
    "gamma": (lambda x, y: jax.scipy.special.gammaln(x)
              + jax.scipy.special.digamma(jnp.abs(y) + 0.5),
              lambda x, y: torch.lgamma(x) + torch.digamma(y.abs() + 0.5),
              False),
    "normal": (lambda x, y: jax.scipy.special.erfinv(y * 0.125)
               + jax.scipy.special.ndtri(x * 0.0625 + 0.5)
               - jax.scipy.special.ndtr(x),
               lambda x, y: torch.erfinv(y * 0.125)
               + torch.special.ndtri(x * 0.0625 + 0.5)
               - torch.special.ndtr(x), False),
    "bessel": (lambda x, y: jax.scipy.special.i0e(x)
               - jax.scipy.special.i1(y * 0.1),
               lambda x, y: torch.special.i0e(x) - torch.special.i1(y * 0.1),
               False),
    "xlogy": (lambda x, y: jax.scipy.special.xlogy(x, y)
              + jax.scipy.special.xlog1py(x, y),
              lambda x, y: torch.special.xlogy(x, y)
              + torch.special.xlog1py(x, y), False),
    "logaddexp": (jnp.logaddexp, torch.logaddexp, False),
    # off zeta's pole at 1 and polygamma's at 0 and the negative integers
    "zeta": (lambda x, y: jax.scipy.special.zeta(jnp.abs(x) + 2,
                                                 jnp.abs(y) + 1)
             + jax.scipy.special.polygamma(2, jnp.abs(y) + 1),
             lambda x, y: torch.special.zeta(x.abs() + 2, y.abs() + 1)
             + torch.special.polygamma(2, y.abs() + 1), False),
    # jax.nn.gelu's default is the tanh form: both take the erf form here
    "activations": (lambda x, y: jax.nn.gelu(x, approximate=False)
                    * jax.nn.silu(y) + jax.nn.softplus(x),
                    lambda x, y: torch.nn.functional.gelu(x)
                    * torch.nn.functional.silu(y)
                    + torch.nn.functional.softplus(x), False),
}
PREDS = {"overlay": "RID=RID AND CID=CID", "d2d": "RID=RID",
         "v2v": "VAL=VAL"}


def _join_operands():
    """32 x 32 operands at block 8: sparse, one empty block row in A and a
    dead block in B, values rounded so that VAL=VAL finds matches."""
    rng = np.random.default_rng(11)
    a = np.round(np.where(rng.uniform(size=(32, 32)) < 0.3,
                          rng.normal(size=(32, 32)) * 3, 0), 1)
    b = np.round(np.where(rng.uniform(size=(32, 32)) < 0.3,
                          rng.normal(size=(32, 32)) * 3, 0), 1)
    a[:8] = 0.0
    b[8:16, 8:16] = 0.0
    return a.astype(np.float32), b.astype(np.float32)


def _collect_both(pred, merge):
    jf, tf, _ = JOIN_MERGES[merge]
    a, b = _join_operands()
    js, ts = JSession(block_size=8), Session(block_size=8, device="cpu")
    name = f"join_{merge}"
    want = js.load(a, "A").join(js.load(b, "B"), PREDS[pred],
                                JMergeFn(name, jf)).collect()
    got = ts.load(a, "A").join(ts.load(b, "B"), PREDS[pred],
                               MergeFn(name, tf)).collect()
    return got, want


def _assert_same_result(got, want, exact=True):
    """Equal coordinates; values bit for bit (NaN places equal), or within
    the reference's float32 atol 1e-5 for transcendental merges."""
    if exact:
        same = np.testing.assert_array_equal
    else:
        same = functools.partial(np.testing.assert_allclose, atol=1e-5,
                                 rtol=0)
    if hasattr(want, "idx"):
        assert np.array_equal(got.idx, np.asarray(want.idx))
        same(np.asarray(got.val), np.asarray(want.val))
    else:
        same(got.value.numpy(), np.asarray(want.value))


@pytest.mark.parametrize("merge", sorted(JOIN_MERGES))
@pytest.mark.parametrize("pred", sorted(PREDS))
def test_join_with_general_merge_matches_reference(fresh_merge_profiles,
                                                   pred, merge):
    got, want = _collect_both(pred, merge)
    _assert_same_result(got, want, JOIN_MERGES[merge][2])


def _compiled_merge_join(a, b, mask_a, mask_b, *, merge, mode=3,
                         block_size=256, tiles=None):
    """What ``merge_join_cuda`` computes, with the generated code run by
    ``evaluate`` (compiled for the host) in place of the kernel."""
    live = live_tiles(mask_a, mask_b, mode)
    big = live.repeat_interleave(block_size, 0) \
        .repeat_interleave(block_size, 1)[: a.shape[0], : a.shape[1]]
    out = mc.evaluate(mc.merge_code(merge), a, b)
    return torch.where(big, out, torch.zeros((), dtype=a.dtype))


def _compiled_coo_expand(ends, delta, a_vals, a_coords, b_vals, b_coords, *,
                         merge, cap, tiles=None):
    """What ``coo_expand_cuda`` computes, the merge by ``evaluate``."""
    code = mc.merge_code(merge)
    return coo_expand_plain(
        ends, delta, a_vals, a_coords, b_vals, b_coords, cap=cap,
        merge=lambda x, y: mc.evaluate(code, x, y))


@pytest.fixture
def compiled_card(monkeypatch):
    """Every device claims the ``cuda`` backend; its ``merge_join`` and
    ``coo_expand`` compile the merge (refusing as the card's wrappers do)
    and run it with ``evaluate``, the other kernels are their plain
    versions. Returns the merges each of the two ran."""
    ran = {"merge_join": [], "coo_expand": []}
    stand_ins = {"merge_join": _compiled_merge_join,
                 "coo_expand": _compiled_coo_expand}
    for name in kreg.kernels():
        spec = kreg.get(name)
        impl = stand_ins.get(name, spec.impls[kreg.TORCH])
        if name in stand_ins:
            def impl(*args, _impl=impl, _name=name, **kw):
                ran[_name].append(mc.merge_code(kw["merge"]).op)
                return _impl(*args, **kw)
        monkeypatch.setitem(spec.impls, kreg.CUDA, impl)
    monkeypatch.setattr(kreg, "backend_for", lambda device: kreg.CUDA)
    return ran


@pytest.mark.parametrize("merge", sorted(JOIN_MERGES))
@pytest.mark.parametrize("pred", ["overlay", "d2d"])
def test_join_through_the_compiler_matches_plain(fresh_merge_profiles,
                                                 compiled_card, pred, merge):
    """The Session reaches the compiler: the same join with the stand-in
    kernels gives the plain run's result, and the kernel ran the generated
    code (an overlay whose merge induces no sparsity skips no block and
    runs the merge itself, as the reference's planner does)."""
    a, b = _join_operands()
    _, tf, exact = JOIN_MERGES[merge]
    prof = t_sparsity.analyze_merge(MergeFn(f"c_{merge}", tf))
    results = []
    for backend in (kreg.TORCH, kreg.CUDA):
        s = Session(block_size=8, device="cpu")
        if backend == kreg.TORCH:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(kreg, "backend_for", lambda device: kreg.TORCH)
                results.append(s.load(a, "A").join(
                    s.load(b, "B"), PREDS[pred],
                    MergeFn(f"c_{merge}", tf)).collect())
        else:
            results.append(s.load(a, "A").join(
                s.load(b, "B"), PREDS[pred],
                MergeFn(f"c_{merge}", tf)).collect())
    kernel = "merge_join" if pred == "overlay" else "coo_expand"
    skips = pred == "d2d" or prof.inducing_x or prof.inducing_y
    assert compiled_card[kernel] == [mc.GENERATED] * skips, compiled_card
    _assert_same_result(results[1], results[0], exact)


# ---------------------------------------------------------------------------
# float64 masked_matmul
# ---------------------------------------------------------------------------

def test_masked_matmul_float64_plain_matches_pallas():
    """The plain version accumulates float64 in float64, as the Pallas body
    does (``preferred_element_type`` = promote_types(f64, f32)); the JAX
    package's dense oracle rounds through float32 instead."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(128, 96))
    b = rng.normal(size=(96, 192))
    mask = rng.uniform(size=(4, 6)) < 0.5
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(masked_matmul_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), bm=32, bn=32,
            bk=32, interpret=True))
    finally:
        jax.config.update("jax_enable_x64", old)
    assert want.dtype == np.float64
    got = masked_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(mask), block_size=32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    # the float32 oracle is further off than that
    f32 = (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float64)
    big = np.kron(mask, np.ones((32, 32), bool))
    assert np.abs(np.where(big, f32, 0.0) - want).max() > 1e-10
