"""The port's kernel layer on the CPU: each kernel's plain PyTorch version
against the JAX package's dense backend (whose parity with the Pallas
bodies the JAX package's own tests establish), the merge op codes the
CUDA kernels evaluate, and the registry's device rule.

Tolerances: coordinates and bits exact; f32 values atol/rtol 1e-5, f64
atol 1e-10 (``tests/test_kernels_fused.py``)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro.kernels import registry as jreg
from repro_torch.core import bloom as tbloom
from repro_torch.core.sparsity import (
    left_merge, product_merge, safe_div, safe_div_merge, sum_merge,
)
from repro_torch.kernels import build, merge_codes, registry
from repro_torch.kernels.bloom_probe import bloom_probe_cuda
from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
from repro_torch.kernels.masked_matmul import masked_matmul_cuda
from repro_torch.kernels.merge_join import (
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, merge_join_cuda, merge_join_plain,
    mode_for,
)
from repro_torch.kernels.sddmm_agg import sddmm_agg_cuda

DENSITIES = [0.0, 0.01, 0.05, 0.2, 1.0]
MERGES = {
    "mul": lambda x, y: x * y,
    "add": lambda x, y: x + y,
    "affine": lambda x, y: 2.0 * x * y + x,
}


@contextlib.contextmanager
def _maybe_x64(dtype_s):
    if dtype_s == "float64":
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)
    else:
        yield


def _tol(dtype_s):
    return dict(atol=1e-5 if dtype_s == "float32" else 1e-10, rtol=1e-5)


# ---------------------------------------------------------------------------
# merge_join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [MODE_BOTH, MODE_X, MODE_Y, MODE_ALL])
@pytest.mark.parametrize("shape,bs", [((64, 48), 16), ((37, 50), 16)])
def test_merge_join_plain_matches_reference(rng, mode, shape, bs):
    m, n = shape
    grid = (-(-m // bs), -(-n // bs))
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    ma = rng.uniform(size=grid) < 0.6
    mb = rng.uniform(size=grid) < 0.6
    for name, fn in MERGES.items():
        want = np.asarray(jreg.dispatch(
            "merge_join", jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma),
            jnp.asarray(mb), backend=jreg.DENSE, merge=fn, mode=mode,
            block_size=bs))
        got = merge_join_plain(torch.as_tensor(a), torch.as_tensor(b),
                               torch.as_tensor(ma), torch.as_tensor(mb),
                               merge=fn, mode=mode, block_size=bs)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_mode_rule_matches_reference():
    from repro.kernels.merge_join import mode_for as jmode_for
    for ix in (False, True):
        for iy in (False, True):
            assert mode_for(ix, iy) == jmode_for(ix, iy)


# ---------------------------------------------------------------------------
# bloom_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4096, 1003])
def test_bloom_probe_plain_matches_reference(rng, n):
    members = np.round(rng.normal(size=800) * 50, 1).astype(np.float32)
    vals = np.concatenate([members[:200],
                           np.round(rng.normal(size=n - 200) * 50, 1)
                           ]).astype(np.float32)
    words = jbloom.build(jnp.asarray(members))
    want = np.asarray(jreg.dispatch("bloom_probe", words, jnp.asarray(vals),
                                    backend=jreg.DENSE, num_hashes=3,
                                    log2_bits=20))
    tw = tbloom.from_numpy_words(np.asarray(words))
    got = registry.dispatch("bloom_probe", tw, torch.as_tensor(vals),
                            num_hashes=3, log2_bits=20)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# coo_expand
# ---------------------------------------------------------------------------

def _segments(rng, ns, density, nb=None, max_run=3):
    """Per-segment match runs: ``density`` of the ``ns`` probe segments
    carry a 1..max_run-entry partner run. A fixed ``nb`` keeps the shapes
    of the sweep equal, so the JAX side compiles its ops once."""
    counts = np.where(rng.uniform(size=ns) < density,
                      rng.integers(1, max_run + 1, size=ns), 0) \
        .astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    total = int(ends[-1]) if ns else 0
    nb = max(total + 5, 1) if nb is None else nb
    starts = (ends - counts).astype(np.int32)
    base = np.array([rng.integers(0, nb - int(c) + 1) for c in counts],
                    np.int32)
    return ends, base - starts, total, nb


def _operands(rng, ns, nb, dtype_s):
    av = np.round(rng.normal(size=ns), 1).astype(dtype_s)
    ac = rng.integers(0, 100, size=(ns, 2)).astype(np.int32)
    bv = np.round(rng.normal(size=nb), 1).astype(dtype_s)
    bc = rng.integers(0, 100, size=(nb, 2)).astype(np.int32)
    return av, ac, bv, bc


def _both(ends, delta, av, ac, bv, bc, merge, cap):
    j_idx, j_val = jreg.dispatch(
        "coo_expand", jnp.asarray(ends), jnp.asarray(delta), jnp.asarray(av),
        jnp.asarray(ac), jnp.asarray(bv), jnp.asarray(bc),
        backend=jreg.DENSE, merge=merge, cap=cap)
    t = torch.as_tensor
    t_idx, t_val = registry.dispatch(
        "coo_expand", t(ends), t(delta.astype(np.int32)), t(av), t(ac),
        t(bv), t(bc), merge=merge, cap=cap)
    return (np.asarray(j_idx), np.asarray(j_val)), \
        (t_idx.numpy(), t_val.numpy())


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype_s", ["float32", "float64"])
@pytest.mark.parametrize("merge_name", sorted(MERGES))
def test_coo_expand_plain_matches_reference(rng, density, dtype_s,
                                            merge_name):
    # ns = 37 runs of at most 3: total ≤ 111 < cap, for every density
    cap = 120
    with _maybe_x64(dtype_s):
        ends, delta, total, nb = _segments(rng, 37, density, nb=128)
        av, ac, bv, bc = _operands(rng, 37, nb, dtype_s)
        (ji, jv), (ti, tv) = _both(ends, delta, av, ac, bv, bc,
                                   MERGES[merge_name], cap)
    assert ti.shape == (cap, 4) and tv.shape == (cap,)
    assert str(tv.dtype) == dtype_s
    # parity over valid slots: past the total both hold clamped values
    assert np.array_equal(ti[:total], ji[:total])
    np.testing.assert_allclose(tv[:total], jv[:total], **_tol(dtype_s))


# the edge cases keep the sweep's shapes (ns = 37, nb = 128, cap = 120)

def test_coo_expand_overflow_truncates_like_reference():
    """cap below the true total: both fill exactly cap slots, all valid."""
    rng = np.random.default_rng(7)
    counts = np.full(37, 4, np.int32)
    ends = np.cumsum(counts).astype(np.int32)           # total 148 > cap
    base = rng.integers(0, 128 - 4 + 1, 37).astype(np.int32)
    av, ac, bv, bc = _operands(rng, 37, 128, "float32")
    (ji, jv), (ti, tv) = _both(ends, base - (ends - counts), av, ac, bv, bc,
                               MERGES["mul"], 120)
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5)


def test_coo_expand_empty_input(rng):
    """All segments empty: every slot is clamped-but-present on both."""
    av, ac, bv, bc = _operands(rng, 37, 128, "float32")
    zeros = np.zeros(37, np.int32)
    (ji, jv), (ti, tv) = _both(zeros, zeros, av, ac, bv, bc, MERGES["add"],
                               120)
    assert ti.shape == ji.shape == (120, 4) and tv.shape == (120,)
    assert tv.dtype == np.float32


def test_coo_expand_unaligned_cap(rng):
    """A cap that is no multiple of a tile or of 8, with slack past the
    total: exactly cap slots come back."""
    ends, delta, total, nb = _segments(rng, 37, 0.5, nb=128)
    av, ac, bv, bc = _operands(rng, 37, nb, "float32")
    (ji, jv), (ti, tv) = _both(ends, delta, av, ac, bv, bc,
                               MERGES["affine"], 120)
    assert tv.shape == (120,) and total < 120
    np.testing.assert_allclose(tv[:total], jv[:total], atol=1e-5)
    assert np.array_equal(ti[:total], ji[:total])


def test_coo_expand_slots_past_total_clamp_to_last_segment(rng):
    """The kernel's rule past the total (searchsorted clamped to the last
    segment) — what ``coo_expand_cuda`` computes on the card."""
    ends = torch.tensor([2, 2, 3], dtype=torch.int32)
    delta = torch.tensor([0, -2, -3], dtype=torch.int32)
    av = torch.tensor([1.0, 2.0, 3.0])
    ac = torch.arange(6, dtype=torch.int16).reshape(3, 2)
    bv = torch.tensor([10.0, 20.0])
    bc = torch.tensor([[7], [8]], dtype=torch.int16)
    idx, val = coo_expand_plain(ends, delta, av, ac, bv, bc,
                                merge=MERGES["mul"], cap=6)
    assert val.tolist() == [10.0, 20.0, 30.0, 30.0, 60.0, 60.0]
    assert idx[:, 0].tolist() == [0, 0, 4, 4, 4, 4]
    assert idx[:, 2].tolist() == [7, 8, 7, 7, 8, 8]


# ---------------------------------------------------------------------------
# merge codes: what the CUDA kernels evaluate in place of a Python merge
# ---------------------------------------------------------------------------

SUPPORTED = {
    "mul": (product_merge().fn, (0, 0, 0, 1)),
    "add": (sum_merge().fn, (0, 1, 1, 0)),
    "sub": (lambda x, y: x - y, (0, 1, -1, 0)),
    "left": (left_merge().fn, (0, 1, 0, 0)),
    "affine": (MERGES["affine"], (0, 1, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(SUPPORTED))
def test_merge_code_of_supported_merges(name):
    fn, coeffs = SUPPORTED[name]
    code = merge_codes.merge_code(fn)
    assert code.op == merge_codes.BILINEAR
    assert code.coeffs == tuple(float(c) for c in coeffs)


def test_merge_code_of_safe_division():
    for merge in (safe_div_merge(), safe_div):
        code = merge_codes.merge_code(merge)
        assert code.op == merge_codes.SAFE_DIV
        assert code.coeffs == (0.0, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("fn", [
    lambda x, y: x * x, lambda x, y: x / y, lambda x, y: x * y * y,
    lambda x, y: torch.where(x > 0, x, y), lambda x, y: abs(x) + y,
], ids=["square", "quotient", "xy2", "where", "abs"])
def test_merge_code_rejects_other_merges(fn):
    with pytest.raises(NotImplementedError, match="general merge"):
        merge_codes.merge_code(fn)


def test_distinct_lambdas_do_not_share_a_code():
    f1, f2 = (lambda x, y: x * y), (lambda x, y: x + y)
    assert merge_codes.merge_code(f1) != merge_codes.merge_code(f2)


# ---------------------------------------------------------------------------
# registry: the backend is the tensors' device, and nothing falls back
# ---------------------------------------------------------------------------

def test_cpu_tensors_dispatch_to_the_plain_versions():
    assert registry.backend_for("cpu") == registry.TORCH
    assert registry.backend_for("cuda") == registry.CUDA
    assert registry.planned_backend("coo_expand", device="cpu") == "torch"
    assert registry.planned_backend("merge_join", device="cuda") == "cuda"
    assert set(registry.kernels()) == {"bloom_probe", "coo_expand",
                                       "masked_matmul", "merge_join",
                                       "sddmm_agg"}
    for name in registry.kernels():
        assert registry.get(name).backends() == ("torch", "cuda")


def test_backend_that_disagrees_with_the_device_raises():
    x = torch.zeros(8, 8)
    m = torch.ones(1, 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="does not run tensors"):
        registry.dispatch("merge_join", x, x, m, m, backend="cuda",
                          merge=MERGES["mul"], block_size=8)


def _refused_calls():
    x = torch.zeros(1, 4)
    m = torch.ones(1, 1, dtype=torch.bool)
    i = torch.zeros(2, dtype=torch.int32)
    return {
        "merge_join": lambda: merge_join_cuda(x, x, m, m, merge=MERGES["mul"],
                                              mode=MODE_ALL),
        "bloom_probe": lambda: bloom_probe_cuda(
            torch.zeros(1 << 15, dtype=torch.int32), x),
        "coo_expand": lambda: coo_expand_cuda(
            i, i, x[0, :2], i.reshape(1, 2).to(torch.int16).expand(2, 2),
            x[0, :2], i[:, None].to(torch.int16), merge=MERGES["mul"],
            cap=4),
        "masked_matmul": lambda: masked_matmul_cuda(x.T, x, m, block_size=4),
        "sddmm_agg": lambda: sddmm_agg_cuda(x, x.T, x, m, dim="row",
                                            block_size=4),
    }


@pytest.mark.parametrize("name", sorted(_refused_calls()))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _refused_calls()[name]()
    assert build.LAUNCHES == before        # a refusal counts no launch
