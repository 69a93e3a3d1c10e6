"""The port's device COO tier against the JAX package's device tier and
against the port's own host tier, over densities 0 / 0.05 / 0.3 / 1.0.

Reference calls keep fixed shapes per join family (fixed expansion and
side capacities), so the JAX side compiles its ops once per family.
Coordinates and validity exact; f32 values atol/rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joins_device as jdev
from repro.core.joins import join_sparse as j_join_sparse
from repro.core.matrix import BlockMatrix as JBlockMatrix
from repro.core.predicates import parse_join as j_parse_join
from repro.core.sparsity import (
    analyze_merge as j_analyze, product_merge as j_product,
    sum_merge as j_sum,
)
from repro_torch.core import joins_device as tdev
from repro_torch.core.expr import MergeFn
from repro_torch.core.joins import join_sparse, join_sparse_device
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.predicates import Field, parse_join
from repro_torch.core.sparsity import analyze_merge, product_merge, sum_merge

BS = 8
DENSITIES = [0.0, 0.05, 0.3, 1.0]
MERGES = [product_merge(), sum_merge(),
          MergeFn("affdev", lambda x, y: 2 * x * y + x)]


def _sparse(rng, m, n, density, round_vals=True):
    v = rng.normal(size=(m, n)).astype(np.float32)
    out = np.where(rng.uniform(size=(m, n)) < density, v, 0).astype(np.float32)
    return np.round(out, 1) if round_vals else out


def _bm(a):
    return BlockMatrix.from_dense(torch.as_tensor(a), BS)


def _dimvals(rng, m, n, density, limit):
    v = rng.integers(1, limit, size=(m, n)).astype(np.float32)
    return np.where(rng.uniform(size=(m, n)) < density, v, 0) \
        .astype(np.float32)


def _operands(rng, pred_s, density):
    a = _sparse(rng, 12, 10, density)
    b = _sparse(rng, 12, 14, density)
    if pred_s == "CID=CID":
        a, b = a.T.copy(), b.T.copy()
    return a, b


# expansion capacity per family, fixed so reference shapes never change
_CAP = {"RID=RID": 12 * 10 * 14, "CID=CID": 12 * 10 * 14,
        "VAL=VAL": 4096, "CROSS": 120 * 168}


_JITTED = {}


def _reference_device(pred_s, a, b):
    """The JAX device tier, jit-compiled once per family (it is built to
    trace; one compile beats dozens of per-op ones)."""
    fn = _JITTED.get(pred_s)
    if fn is None:
        pred = j_parse_join(pred_s)
        prof = j_analyze(j_product())
        cap, ca, cb = _CAP[pred_s], a.size, b.size
        mul = _MUL
        if pred_s in ("RID=RID", "CID=CID"):
            body = lambda x, y: jdev.d2d_device(  # noqa: E731
                x, y, pred.left, pred.right, mul, prof, cap, cap_a=ca,
                cap_b=cb)
        elif pred_s == "VAL=VAL":
            body = lambda x, y: jdev.v2v_device(  # noqa: E731
                x, y, mul, prof, cap, cap_a=ca, cap_b=cb, use_bloom=True)
        else:
            body = lambda x, y: jdev.cross_device(  # noqa: E731
                x, y, mul, prof, cap, cap_a=ca, cap_b=cb)
        fn = _JITTED[pred_s] = jax.jit(body)
    return fn(jnp.asarray(a), jnp.asarray(b))


def _MUL(x, y):
    return x * y


def _device_both(pred_s, a, b):
    """Run one join through both device tiers with identical capacities."""
    pred = parse_join(pred_s)
    prof = analyze_merge(product_merge())
    cap, ca, cb = _CAP[pred_s], a.size, b.size
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    if pred_s in ("RID=RID", "CID=CID"):
        t = tdev.d2d_device(ta, tb, pred.left, pred.right, _MUL, prof, cap,
                            cap_a=ca, cap_b=cb)
    elif pred_s == "VAL=VAL":
        t = tdev.v2v_device(ta, tb, _MUL, prof, cap, cap_a=ca, cap_b=cb,
                            use_bloom=True)
    else:
        t = tdev.cross_device(ta, tb, _MUL, prof, cap, cap_a=ca, cap_b=cb)
    return _reference_device(pred_s, a, b), t


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("pred_s", ["RID=RID", "CID=CID", "VAL=VAL",
                                    "CROSS"])
def test_device_tier_matches_reference_device_tier(rng, pred_s, density):
    a, b = _operands(rng, pred_s, density)
    j, t = _device_both(pred_s, a, b)
    assert int(t.total) == int(j.total)
    valid = t.valid.numpy()
    assert np.array_equal(valid, np.asarray(j.valid))
    assert t.idx.dtype == torch.int16        # every dimension fits int16
    assert np.array_equal(t.idx.numpy()[valid].astype(np.int64),
                          np.asarray(j.idx)[valid].astype(np.int64))
    np.testing.assert_allclose(t.val.numpy()[valid], np.asarray(j.val)[valid],
                               atol=1e-5, rtol=1e-5)


# the operands of the V2V NaN fault: torch.searchsorted over floats puts a
# NaN key elsewhere than jnp.searchsorted, and the tier once paired a 1
# with the NaN and dropped the NaN pair
NAN_A = np.array([[np.nan, 1, 0], [2, 0, 3]], np.float32)
NAN_B = np.array([[1, 1, 0], [2, 0, np.nan]], np.float32)
SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0],
                    np.float32)
_V2V_CAP = 2048            # ≥ every pair of the 6×5 and 6×7 operands


def _special(rng, m, n, density):
    """``_sparse`` operands with ±0.0, NaN of both signs and ±inf written
    over a third of the entries, and -0.0 over some of the zeros."""
    v = _sparse(rng, m, n, density)
    live = v != 0
    pick = live & (rng.uniform(size=v.shape) < 1 / 3)
    v[pick] = rng.choice(SPECIALS, int(pick.sum()))
    v[~live & (rng.uniform(size=v.shape) < 0.2)] = -0.0
    return v


_V2V_JITTED = {}


def _v2v_both(merge_name, a, b):
    """One V2V join through both device tiers (Bloom pre-filter on), under
    ``x*y`` (zeros skipped) or ``x+y`` (zeros join)."""
    jm, tm = {"mul": (j_product(), product_merge()),
              "add": (j_sum(), sum_merge())}[merge_name]
    cap, ca, cb = _V2V_CAP, a.size, b.size
    fn = _V2V_JITTED.get((merge_name, a.shape, b.shape))
    if fn is None:
        prof = j_analyze(jm)
        fn = _V2V_JITTED[merge_name, a.shape, b.shape] = jax.jit(
            lambda x, y: jdev.v2v_device(x, y, jm.fn, prof, cap, cap_a=ca,
                                         cap_b=cb, use_bloom=True))
    want = fn(jnp.asarray(a), jnp.asarray(b))
    got = tdev.v2v_device(torch.as_tensor(a), torch.as_tensor(b), tm.fn,
                          analyze_merge(tm), cap, cap_a=ca, cap_b=cb,
                          use_bloom=True)
    return want, got


def _assert_same_coo(t, j):
    assert int(t.total) == int(j.total)
    valid = t.valid.numpy()
    assert np.array_equal(valid, np.asarray(j.valid))
    assert np.array_equal(t.idx.numpy()[valid].astype(np.int64),
                          np.asarray(j.idx)[valid].astype(np.int64))
    np.testing.assert_allclose(t.val.numpy()[valid], np.asarray(j.val)[valid],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("merge_name", ["mul", "add"])
def test_v2v_device_tier_pairs_nan_as_the_reference(merge_name):
    """The fault's operands: the reference gives (0,0,1,2)=nan,
    (0,1,0,0), (0,1,0,1) and (1,0,1,0)=4 under both merges."""
    j, t = _v2v_both(merge_name, NAN_A, NAN_B)
    _assert_same_coo(t, j)
    valid = t.valid.numpy()
    assert t.idx.numpy()[valid].tolist() == [
        [0, 0, 1, 2], [0, 1, 0, 0], [0, 1, 0, 1], [1, 0, 1, 0]]


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("merge_name", ["mul", "add"])
def test_v2v_device_tier_matches_reference_on_special_values(rng, merge_name,
                                                             density):
    a, b = _special(rng, 6, 5, density), _special(rng, 6, 7, density)
    j, t = _v2v_both(merge_name, a, b)
    _assert_same_coo(t, j)


def test_order_key_orders_as_the_reference():
    """Sorting and searching on the integer keys give ``jnp.argsort``'s
    order and ``jnp.searchsorted``'s bounds, f32 and f64."""
    vals = np.array([np.nan, 1, -0.0, np.inf, 0.0, -np.nan, -np.inf, -1,
                     1e-30, -1e-30, 2, 1], np.float32)
    for dt in (np.float32, np.float64):
        v = vals.astype(dt)
        order = np.array(jnp.argsort(jnp.asarray(v)))
        key = tdev._order_key(torch.as_tensor(v))
        assert np.array_equal(torch.argsort(key, stable=True).numpy(), order)
        sk = jnp.asarray(v[order])
        tk = key[torch.as_tensor(order)]
        for side in ("left", "right"):
            assert np.array_equal(
                torch.searchsorted(tk, key, side=side).numpy(),
                np.asarray(jnp.searchsorted(sk, jnp.asarray(v), side=side)))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("merge", MERGES, ids=lambda m: m.name)
@pytest.mark.parametrize("pred_s", ["RID=RID", "CID=CID", "VAL=VAL",
                                    "CROSS"])
def test_device_tier_matches_host_tier(rng, pred_s, merge, density):
    a, b = _operands(rng, pred_s, density)
    pred = parse_join(pred_s)
    host = join_sparse(_bm(a), _bm(b), pred, merge)
    dev = join_sparse_device(_bm(a), _bm(b), pred, merge)
    assert dev.val.dtype == host.val.dtype
    assert dev.shape == host.shape
    np.testing.assert_allclose(dev.to_dense(), host.to_dense(), atol=1e-5)


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("pred_s", ["RID=VAL", "VAL=RID"])
def test_dimension_entry_joins(rng, pred_s, density):
    for merge in (product_merge(), sum_merge()):
        if pred_s == "RID=VAL":
            a = _sparse(rng, 24, 12, 0.4)
            b = _dimvals(rng, 6, 5, density, limit=24)
        else:
            a = _dimvals(rng, 6, 5, density, limit=24)
            b = _sparse(rng, 24, 12, 0.4)
        pred = parse_join(pred_s)
        host = join_sparse(_bm(a), _bm(b), pred, merge)
        dev = join_sparse_device(_bm(a), _bm(b), pred, merge)
        np.testing.assert_allclose(dev.to_dense(), host.to_dense(),
                                   atol=1e-5, err_msg=merge.name)


@pytest.mark.parametrize("pred_s", ["RID=RID", "CID=CID", "VAL=VAL",
                                    "CROSS", "RID=VAL"])
def test_host_tier_matches_reference_host_tier(rng, pred_s):
    """The host families are numpy in both packages: identical entries in
    identical order."""
    if pred_s == "RID=VAL":
        a = _sparse(rng, 24, 12, 0.4)
        b = _dimvals(rng, 6, 5, 0.3, limit=24)
    else:
        a, b = _operands(rng, pred_s, 0.3)
    want = j_join_sparse(JBlockMatrix.from_dense(jnp.asarray(a), BS),
                         JBlockMatrix.from_dense(jnp.asarray(b), BS),
                         j_parse_join(pred_s), j_product())
    got = join_sparse(_bm(a), _bm(b), parse_join(pred_s), product_merge())
    assert got.shape == want.shape
    assert np.array_equal(got.idx, want.idx)
    np.testing.assert_allclose(got.val, want.val, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pred_s", ["RID=RID", "CID=RID", "VAL=VAL",
                                    "CROSS", "RID=VAL", "VAL=CID"])
def test_exact_capacity_matches_reference(rng, pred_s):
    a = _sparse(rng, 12, 12, 0.3)
    b = _dimvals(rng, 12, 12, 0.3, limit=12) if "VAL" in pred_s \
        and pred_s != "VAL=VAL" else _sparse(rng, 12, 12, 0.3)
    if pred_s == "VAL=CID":
        a, b = b, a
    for merge, jmerge in ((product_merge(), j_product()),):
        got = tdev.exact_capacity(a, b, parse_join(pred_s),
                                  analyze_merge(merge))
        want = jdev.exact_capacity(a, b, j_parse_join(pred_s),
                                   j_analyze(jmerge))
        assert got == want


def test_capacity_too_small_raises(rng):
    a = _sparse(rng, 16, 16, 0.5)
    with pytest.raises(ValueError, match="capacity"):
        join_sparse_device(_bm(a), _bm(a), parse_join("RID=RID"),
                           sum_merge(), cap=8)


def test_cross_total_int32_wrap_still_overflows():
    """A dense 256×256 non-inducing cross has 2³² slots — the int32 wrap to
    zero; the float32 shadow product still flags the overflow."""
    a = np.ones((256, 256), np.float32)
    with pytest.raises(ValueError, match="capacity"):
        join_sparse_device(_bm(a), _bm(a), parse_join("CROSS"), sum_merge(),
                           cap=64)


def test_wide_dimension_uses_int32_coordinates(rng):
    a = _sparse(rng, 2, 1 << 15, 0.001)
    b = _sparse(rng, 2, 3, 1.0)
    out = tdev.d2d_device(torch.as_tensor(a), torch.as_tensor(b), Field.RID,
                          Field.RID, lambda x, y: x * y,
                          analyze_merge(product_merge()), 512)
    assert out.idx.dtype == torch.int32
    host = join_sparse(_bm(a), _bm(b), parse_join("RID=RID"),
                       product_merge())
    dev = tdev.coo_to_host(out, host.shape)
    np.testing.assert_allclose(dev.to_dense(), host.to_dense(), atol=1e-5)


def test_round_capacity_matches_reference():
    for c in (0, 1, 7, 8, 9, 4397299, 1 << 23):
        assert tdev.round_capacity(c) == jdev.round_capacity(c)


# ---------------------------------------------------------------------------
# The V2V Bloom filter, built over B's compacted entries.
# ---------------------------------------------------------------------------

def _bloom_operand(kind, seed):
    """B operands for the filter: ``special`` (±0.0, NaN of both signs,
    ±inf among rounded normals), ``zeros`` (all zero, -0.0 among them) or
    ``ints`` (small integers, many repeats)."""
    rng = np.random.default_rng(seed)
    if kind == "special":
        return _special(rng, 9, 11, 0.5)
    if kind == "zeros":
        v = np.zeros((9, 11), np.float32)
        v[rng.uniform(size=v.shape) < 0.3] = -0.0
        return v
    return _dimvals(rng, 9, 11, 0.4, limit=7)


def _probed_filter(a, b, merge, params):
    """The bitset ``v2v_device`` hands the ``bloom_probe`` kernel."""
    from repro_torch.kernels import registry
    spec = registry.get("bloom_probe")
    plain = spec.impls[registry.TORCH]
    seen = []

    def record(words, vals, **kw):
        seen.append(words.clone())
        return plain(words, vals, **kw)

    spec.impls[registry.TORCH] = record
    try:
        tdev.v2v_device(torch.as_tensor(a), torch.as_tensor(b), merge.fn,
                        analyze_merge(merge), _V2V_CAP, use_bloom=True,
                        bloom_params=params)
    finally:
        spec.impls[registry.TORCH] = plain
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("log2_bits", [5, 20, 21])
@pytest.mark.parametrize("kind", ["special", "zeros", "ints"])
@pytest.mark.parametrize("skip_zeros", [True, False])
def test_v2v_bloom_filter_from_compacted_entries_matches_reference_build(
        kind, skip_zeros, log2_bits):
    """``bloom.build_live`` over B's compacted entries, and the filter
    ``v2v_device`` probes with, equal the JAX package's ``bloom.build``
    over all of B's cells word for word (x*y skips zeros, x+y does not)."""
    from repro.core import bloom as jbloom
    from repro_torch.core import bloom as tbloom
    b = _bloom_operand(kind, 40 + log2_bits)
    want = np.asarray(jbloom.build(
        jnp.asarray(b), jbloom.BloomParams(log2_bits=log2_bits),
        skip_zeros=skip_zeros))
    tb = torch.as_tensor(b)
    idx_b, nb, slot_b = tdev._entry_compact(tdev._live(tb, skip_zeros),
                                            b.size)
    assert int(nb) <= b.size
    params = tbloom.BloomParams(log2_bits=log2_bits)
    built = tbloom.build_live(tb.reshape(-1)[idx_b], slot_b, params)
    assert np.array_equal(tbloom.to_numpy_words(built), want)
    merge = product_merge() if skip_zeros else sum_merge()
    a = _bloom_operand("ints", 7)
    probed = _probed_filter(a, b, merge, params)
    assert np.array_equal(tbloom.to_numpy_words(probed), want)


@pytest.mark.parametrize("use_bloom", [True, False])
@pytest.mark.parametrize("merge_name", ["mul", "add"])
def test_v2v_side_overflow_is_flagged(merge_name, use_bloom):
    """With more live B cells than ``cap_b`` (nb > cap_b) the join comes
    back overflowed, as in the JAX package, whatever the filter holds."""
    rng = np.random.default_rng(5)
    a = _dimvals(rng, 6, 5, 0.6, limit=5)
    b = _dimvals(rng, 6, 7, 0.6, limit=5)
    jm, tm = {"mul": (j_product(), product_merge()),
              "add": (j_sum(), sum_merge())}[merge_name]
    cap_b = int(np.count_nonzero(b)) // 2
    want = jdev.v2v_device(jnp.asarray(a), jnp.asarray(b), jm.fn,
                           j_analyze(jm), _V2V_CAP, cap_a=a.size,
                           cap_b=cap_b, use_bloom=use_bloom)
    got = tdev.v2v_device(torch.as_tensor(a), torch.as_tensor(b), tm.fn,
                          analyze_merge(tm), _V2V_CAP, cap_a=a.size,
                          cap_b=cap_b, use_bloom=use_bloom)
    assert tdev.overflowed(got)
    assert int(got.total) == int(want.total) == tdev._OVERFLOW_TOTAL


_BLOOM_JITTED = {}
_BLOOM_CAP = 16384         # ≥ every pair, zero pairs of x+y included


@pytest.mark.parametrize("log2_bits", [5, 20])
@pytest.mark.parametrize("merge_name", ["mul", "add"])
@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_v2v_bloom_join_matches_reference_device_tier(merge_name, log2_bits,
                                                      density):
    """``v2v_device(use_bloom=True)`` against the JAX package's on the same
    integer operands (many equal values; at 32 bits the filter passes
    most non-members too): exact totals, validity and coordinates, values
    within 1e-5."""
    from repro.core import bloom as jbloom
    from repro_torch.core import bloom as tbloom
    rng = np.random.default_rng(int(density * 100) + log2_bits)
    a = _dimvals(rng, 10, 9, density, limit=40)
    b = _dimvals(rng, 8, 12, density, limit=40)
    jm, tm = {"mul": (j_product(), product_merge()),
              "add": (j_sum(), sum_merge())}[merge_name]
    key = (merge_name, log2_bits)
    fn = _BLOOM_JITTED.get(key)
    if fn is None:
        prof, jp = j_analyze(jm), jbloom.BloomParams(log2_bits=log2_bits)
        fn = _BLOOM_JITTED[key] = jax.jit(
            lambda x, y: jdev.v2v_device(x, y, jm.fn, prof, _BLOOM_CAP,
                                         cap_a=x.size, cap_b=y.size,
                                         use_bloom=True, bloom_params=jp))
    want = fn(jnp.asarray(a), jnp.asarray(b))
    got = tdev.v2v_device(torch.as_tensor(a), torch.as_tensor(b), tm.fn,
                          analyze_merge(tm), _BLOOM_CAP, cap_a=a.size,
                          cap_b=b.size, use_bloom=True,
                          bloom_params=tbloom.BloomParams(log2_bits=log2_bits))
    assert not tdev.overflowed(got)
    _assert_same_coo(got, want)
