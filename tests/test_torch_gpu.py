"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided inside the fixture, so every pytest
worker collects the same tests). Tolerances: integers, coordinates and
bitsets exact; f32 values atol/rtol 1e-5, f64 1e-10 (the JAX package's
kernel tolerances). The PNMF kernels sum in another order than their
plain versions: ``masked_matmul`` f32 atol/rtol 1e-4 (K up to 300), bf16
atol 5e-2 rtol 1e-2 (the JAX package's, one bf16 rounding);
``sddmm_agg`` f32 atol 5e-4 rtol 1e-4 on non-negative inputs (no
cancellation), f64 1e-9 (``tests/test_kernels_fused.py``).

    python -m pytest -q -m gpu tests/test_torch_gpu.py      # on the card
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import bloom as tbloom
from repro_torch.kernels import build
from repro_torch.kernels.bloom_probe import bloom_probe_cuda, bloom_probe_plain
from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
from repro_torch.kernels.masked_matmul import (
    masked_matmul_cuda, masked_matmul_plain, pool,
)
from repro_torch.kernels.merge_join import (
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, merge_join_cuda, merge_join_plain,
)
from repro_torch.kernels.sddmm_agg import pool as sddmm_agg_pool
from repro_torch.kernels.sddmm_agg import sddmm_agg_cuda, sddmm_agg_plain

pytestmark = pytest.mark.gpu

MERGES = {
    "mul": lambda x, y: x * y,
    "add": lambda x, y: x + y,
    "affine": lambda x, y: 2.0 * x * y + x,
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _expand_inputs(rng, ns, nb, cb, density, dtype, cdt, cap_extra=0):
    counts = rng.integers(0, 6, ns) * (rng.uniform(size=ns) < density)
    ends = np.cumsum(counts).astype(np.int32)
    starts = ends - counts
    base = rng.integers(0, max(nb - 5, 1), ns)
    delta = (base - starts).astype(np.int32)
    a_vals = rng.normal(size=ns)
    b_vals = rng.normal(size=nb)
    a_coords = rng.integers(0, 1000, (ns, 2))
    b_coords = rng.integers(0, 1000, (nb, cb))
    total = int(ends[-1]) if ns else 0
    cap = max(total + cap_extra, 1)
    t = lambda x, d: torch.as_tensor(np.asarray(x), dtype=d)  # noqa: E731
    return (t(ends, torch.int32), t(delta, torch.int32), t(a_vals, dtype),
            t(a_coords, cdt), t(b_vals, dtype), t(b_coords, cdt)), cap, total


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("dtype,cdt,cb", [
    (torch.float32, torch.int16, 1), (torch.float32, torch.int32, 2),
    (torch.float64, torch.int16, 2)])
def test_coo_expand_kernel_matches_plain(cuda, density, merge, dtype, cdt,
                                         cb):
    rng = np.random.default_rng(0)
    ins, cap, total = _expand_inputs(rng, 3000, 2000, cb, density, dtype,
                                     cdt, cap_extra=37)
    ins = [x.to(cuda) for x in ins]
    fn = MERGES[merge]
    before = build.LAUNCHES["coo_expand"]
    idx_k, val_k = coo_expand_cuda(*ins, merge=fn, cap=cap)
    torch.cuda.synchronize()
    assert build.LAUNCHES["coo_expand"] == before + 1
    idx_p, val_p = coo_expand_plain(*ins, merge=fn, cap=cap)
    # every slot below the total is a real expansion slot; the clamp past
    # it is the same rule in both, so all slots agree
    assert torch.equal(idx_k, idx_p)
    tol = TOL[dtype]
    torch.testing.assert_close(val_k, val_p.to(dtype), atol=tol, rtol=tol)


EXPAND_RUN = 256 * 8      # merge items a CTA takes (kThreads × default vt)
EXPAND_TYPES = [(torch.float32, torch.int16, 1), (torch.float32, torch.int32, 2),
                (torch.float64, torch.int16, 2), (torch.float64, torch.int32, 1)]


def _counts_case(rng, case):
    """Segment counts and a capacity for one shape of the merge path."""
    rand = rng.integers(0, 6, 3000)
    total = int(rand.sum())
    cases = {
        # one segment longer than a CTA's run, between short ones
        "long segment": (np.r_[rand[:50], 20011, rand[50:100]], None),
        # more empty segments in a row than a CTA's run holds, at the
        # start, in the middle and at the end
        "empty runs": (np.r_[np.zeros(12000, int), rand[:500],
                             np.zeros(15000, int), rand[500:900],
                             np.zeros(11000, int)], None),
        "ns=1": (np.array([4321]), None),
        "cap=1": (rand, 1),
        "cap=run-1": (rand, EXPAND_RUN - 1),
        "cap=run": (rand, EXPAND_RUN),
        "cap=run+1": (rand, EXPAND_RUN + 1),
        "cap past total": (rand, total + 5 * EXPAND_RUN + 3),
        "all empty": (np.zeros(5000, int), 3 * EXPAND_RUN),
    }
    counts, cap = cases[case]
    return counts, int(counts.sum()) if cap is None else cap


def _inputs_from_counts(rng, counts, nb, cb, dtype, cdt, device, ca=2):
    ns = counts.size
    ends = np.cumsum(counts).astype(np.int32)
    delta = (rng.integers(0, max(nb - 5, 1), ns) - (ends - counts)) \
        .astype(np.int32)
    t = lambda x, d: torch.as_tensor(np.asarray(x), dtype=d,  # noqa: E731
                                     device=device)
    return (t(ends, torch.int32), t(delta, torch.int32),
            t(rng.normal(size=ns), dtype), t(rng.integers(0, 30000, (ns, ca)),
                                              cdt),
            t(rng.normal(size=nb), dtype), t(rng.integers(0, 30000, (nb, cb)),
                                             cdt))


@pytest.mark.parametrize("case", ["long segment", "empty runs", "ns=1",
                                  "cap=1", "cap=run-1", "cap=run",
                                  "cap=run+1", "cap past total", "all empty"])
@pytest.mark.parametrize("dtype,cdt,cb", EXPAND_TYPES)
def test_coo_expand_kernel_matches_plain_on_merge_path_edges(cuda, case,
                                                             dtype, cdt, cb):
    """Every slot below ``cap`` equal to the plain version, past the total
    too, where a CTA's run of the merge is all slots, all ends, cut by
    ``cap`` or one item off a run's length."""
    rng = np.random.default_rng(20)
    counts, cap = _counts_case(rng, case)
    ins = _inputs_from_counts(rng, counts, 25000, cb, dtype, cdt, cuda)
    fn = MERGES["affine"]
    idx_k, val_k = coo_expand_cuda(*ins, merge=fn, cap=cap)
    idx_p, val_p = coo_expand_plain(*ins, merge=fn, cap=cap)
    assert idx_k.shape == (cap, 2 + cb)
    assert torch.equal(idx_k, idx_p)
    tol = TOL[dtype]
    torch.testing.assert_close(val_k, val_p, atol=tol, rtol=tol)


@pytest.mark.parametrize("ca,cb", [(1, 1), (3, 2), (2, 3), (12, 12)])
@pytest.mark.parametrize("cdt", [torch.int16, torch.int32])
def test_coo_expand_kernel_matches_plain_at_other_widths(cuda, ca, cb, cdt):
    """Coordinate counts other than the joins' 2 + 1 and 2 + 2 take the
    kernel's run-time widths; 12 + 12 int32 coordinates need shorter runs
    to fit shared memory."""
    rng = np.random.default_rng(23)
    counts, cap = _counts_case(rng, "cap past total")
    ins = _inputs_from_counts(rng, counts, 9000, cb, torch.float32, cdt,
                              cuda, ca=ca)
    fn = MERGES["add"]
    idx_k, val_k = coo_expand_cuda(*ins, merge=fn, cap=cap)
    idx_p, val_p = coo_expand_plain(*ins, merge=fn, cap=cap)
    assert torch.equal(idx_k, idx_p)
    torch.testing.assert_close(val_k, val_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,cdt,cb", EXPAND_TYPES)
def test_coo_expand_writes_every_slot(cuda, dtype, cdt, cb):
    """Outputs come from ``torch.empty``: blocks the allocator hands back
    filled with junk must come out equal to the plain version, on a cap
    that is no multiple of a run and whose idx rows start off 16-byte
    boundaries."""
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 40, 4000) * (rng.uniform(size=4000) < 0.5)
    cap = int(counts.sum()) + 777
    ins = _inputs_from_counts(rng, counts, 9000, cb, dtype, cdt, cuda)
    fn = MERGES["mul"]
    want = coo_expand_plain(*ins, merge=fn, cap=cap)
    for _ in range(2):
        junk = (torch.full((cap, 2 + cb), -7, dtype=cdt, device=cuda),
                torch.full((cap,), float("nan"), dtype=dtype, device=cuda))
        del junk                  # the caching allocator reuses the blocks
        idx, val = coo_expand_cuda(*ins, merge=fn, cap=cap)
        assert torch.equal(idx, want[0])
        torch.testing.assert_close(val, want[1], atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_v2v_join_with_nan_on_the_card_matches_cpu(cuda):
    """The V2V NaN fault's operands and operands full of ±0.0, NaN and
    ±inf, joined on ``VAL=VAL`` through ``coo_expand`` on the card: the
    entries of the same query on the CPU."""
    from repro_torch.core import Session
    from repro_torch.core.sparsity import product_merge, sum_merge
    rng = np.random.default_rng(22)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 1.0, 2.0],
                        np.float32)

    def operand(m, n):
        v = np.round(rng.normal(size=(m, n)), 1).astype(np.float32)
        v[rng.uniform(size=(m, n)) < 0.7] = 0
        pick = rng.uniform(size=(m, n)) < 0.2
        v[pick] = rng.choice(specials, int(pick.sum()))
        return v

    pairs = [(np.array([[np.nan, 1, 0], [2, 0, 3]], np.float32),
              np.array([[1, 1, 0], [2, 0, np.nan]], np.float32)),
             (operand(40, 30), operand(35, 50))]
    for a, b in pairs:
        for merge in (product_merge(), sum_merge()):
            got = {}
            for dev in ("cpu", "cuda"):
                s = Session(block_size=16, device=dev)
                build.reset_launches()
                got[dev] = s.load(a, "A").join(s.load(b, "B"), "VAL=VAL",
                                               merge).collect()
            assert build.LAUNCHES["coo_expand"] == 1
            assert np.array_equal(got["cuda"].idx, got["cpu"].idx)
            np.testing.assert_allclose(got["cuda"].val, got["cpu"].val,
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [4096, 4096 + 17, 1])
def test_bloom_probe_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(1)
    members = torch.as_tensor(rng.integers(1, 5000, 3000).astype(np.float32),
                              device=cuda)
    words = tbloom.build(members)
    probe = torch.as_tensor(rng.integers(1, 10000, n).astype(np.float32),
                            device=cuda)
    got = bloom_probe_cuda(words, probe)
    want = bloom_probe_plain(words, probe)
    assert torch.equal(got, want)
    # every member hits (no false negatives)
    assert bool(bloom_probe_cuda(words, members).all())


BLOOM_SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0],
                          np.float32)
Q5_N = 268296              # the main path's Q5 probe: values a call


def _bloom_case(rng, n, log2_bits, num_hashes, offset=0, device="cuda"):
    """Members (small integers and the special values) built into a
    filter, and ``n`` probe values (members, non-members and specials)
    starting ``offset`` elements into their buffer."""
    members = np.concatenate([rng.integers(1, 5000, 3000), BLOOM_SPECIALS])
    params = tbloom.BloomParams(log2_bits=log2_bits, num_hashes=num_hashes)
    words = tbloom.build(torch.as_tensor(members.astype(np.float32),
                                         device=device), params,
                         skip_zeros=False)
    pool = np.concatenate([rng.integers(1, 10000, n + offset),
                           BLOOM_SPECIALS]).astype(np.float32)
    buf = torch.as_tensor(rng.permutation(pool)[:n + offset], device=device)
    return words, buf[offset:], members


def _check_bloom(words, vals, **kw):
    got = bloom_probe_cuda(words, vals, **kw)
    want = bloom_probe_plain(words, vals, **kw)
    assert got.dtype == torch.bool and got.shape == vals.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 255, 257, Q5_N])
def test_bloom_probe_matches_plain_at_every_length(cuda, n, offset):
    """Lengths around the four-value groups and the scalar head and tail;
    ``offset`` 1 moves the values off their 16-byte boundary."""
    rng = np.random.default_rng(n + offset)
    words, vals, _ = _bloom_case(rng, n, 20, 3, offset)
    before = build.LAUNCHES["bloom_probe"]
    _check_bloom(words, vals)
    assert build.LAUNCHES["bloom_probe"] == before + (n > 0)


@pytest.mark.parametrize("num_hashes", [1, 3, 5, 7])
@pytest.mark.parametrize("log2_bits", [5, 12, 20, 21, 24])
def test_bloom_probe_matches_plain_on_both_paths(cuda, log2_bits, num_hashes):
    """Bitsets from 4 bytes to 2 MiB (shared path up to log2_bits 20,
    global above) and hash counts compiled as constants (1, 3) or run in
    a loop (5, 7); every member hits."""
    from repro_torch.kernels.bloom_probe import plan
    rng = np.random.default_rng(log2_bits * 10 + num_hashes)
    words, vals, members = _bloom_case(rng, 4099, log2_bits, num_hashes, 1)
    kw = dict(num_hashes=num_hashes, log2_bits=log2_bits)
    assert plan(words, vals, **kw)["path"] == \
        ("shared" if log2_bits <= 20 else "global")
    _check_bloom(words, vals, **kw)
    mem = torch.as_tensor(members.astype(np.float32), device=cuda)
    assert bool(_check_bloom(words, mem, **kw).all())


@pytest.mark.parametrize("log2_bits", [5, 12, 20, 21])
@pytest.mark.parametrize("fill", [0, -1])
def test_bloom_probe_on_constant_bitsets(cuda, fill, log2_bits):
    """An all-zero bitset rejects every value, an all-ones one passes
    every value, NaN and ±inf included."""
    rng = np.random.default_rng(9)
    words = torch.full(((1 << log2_bits) // 32,), fill, dtype=torch.int32,
                       device=cuda).view(torch.uint32)
    _, vals, _ = _bloom_case(rng, 1001, log2_bits, 3)
    got = _check_bloom(words, vals, log2_bits=log2_bits)
    assert bool(got.all()) if fill else not bool(got.any())


def test_bloom_probe_main_path_copies_the_bitset_by_tma(cuda):
    """On the main path's Q5 shape the bitset goes into shared memory by
    TMA, one CTA an SM at most, and probes as the plain version does."""
    from repro_torch.kernels.bloom_probe import plan
    rng = np.random.default_rng(1)
    words, vals, _ = _bloom_case(rng, Q5_N, 20, 3)
    p = plan(words, vals)
    assert (p["path"], p["tma"]) == ("shared", True)
    assert p["grid"] <= torch.cuda.get_device_properties(0) \
        .multi_processor_count
    _check_bloom(words, vals)


def test_bloom_probe_is_bit_identical_across_launches(cuda):
    rng = np.random.default_rng(4)
    for log2_bits in (20, 21):
        words, vals, _ = _bloom_case(rng, Q5_N, log2_bits, 3, 1)
        first = bloom_probe_cuda(words, vals, log2_bits=log2_bits)
        assert torch.equal(bloom_probe_cuda(words, vals, log2_bits=log2_bits),
                           first)


def test_bloom_probe_refusals_launch_nothing(cuda):
    words = torch.zeros(1 << 15, dtype=torch.int32, device=cuda)
    vals = torch.ones(8, device=cuda)
    refused = [
        lambda: bloom_probe_cuda(words.cpu(), vals),           # two devices
        lambda: bloom_probe_cuda(words.float(), vals),         # word type
        lambda: bloom_probe_cuda(words[:-1], vals),            # word count
        lambda: bloom_probe_cuda(words[:0], vals, log2_bits=4),  # range
    ]
    before = dict(build.LAUNCHES)
    for call in refused:
        with pytest.raises(ValueError):
            call()
    assert build.LAUNCHES == before


def test_coo_expand_refuses_int32_overflow_without_a_launch(cuda):
    i = torch.zeros(2, dtype=torch.int32, device=cuda)
    v = torch.zeros(2, device=cuda)
    c = torch.zeros((2, 2), dtype=torch.int16, device=cuda)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        coo_expand_cuda(i, i, v, c, v, c, merge=MERGES["mul"],
                        cap=2 ** 31 - 2)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("mode", [MODE_BOTH, MODE_X, MODE_Y, MODE_ALL])
@pytest.mark.parametrize("shape,bs", [((1024, 768), 256), ((300, 257), 128),
                                      ((512, 510), 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_join_kernel_matches_plain(cuda, mode, shape, bs, dtype):
    rng = np.random.default_rng(2)
    m, n = shape
    grid = (-(-m // bs), -(-n // bs))
    a = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
    ma = torch.as_tensor(rng.uniform(size=grid) < 0.6, device=cuda)
    mb = torch.as_tensor(rng.uniform(size=grid) < 0.6, device=cuda)
    for fn in MERGES.values():
        kw = dict(merge=fn, mode=mode, block_size=bs)
        got = merge_join_cuda(a, b, ma, mb, **kw)
        want = merge_join_plain(a, b, ma, mb, **kw)
        tol = TOL[dtype]
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)



def test_session_on_the_card_launches_the_kernels_and_matches_cpu(cuda):
    """The main path on the card goes through all three kernels (their
    launch counts move) and agrees with the same queries on the CPU."""
    from repro_torch.core import Session
    from repro_torch.core.sparsity import product_merge
    rng = np.random.default_rng(3)
    n, bs = 512, 64
    ao = np.round(rng.normal(size=(n, n)), 1).astype(np.float32)
    bo = np.round(rng.normal(size=(n, n)), 1).astype(np.float32)
    g = n // bs
    for k in rng.permutation(g * g)[:20]:
        ao[(k // g) * bs:(k // g + 1) * bs, (k % g) * bs:(k % g + 1) * bs] = 0
    sp = lambda: np.where(rng.uniform(size=(n, n)) < 0.01,  # noqa: E731
                          rng.integers(1, 200, (n, n)), 0).astype(np.float32)
    a, b = sp(), sp()
    mul = product_merge()
    results = {}
    for dev in ("cpu", "cuda"):
        s = Session(block_size=bs, device=dev)
        m = {k: s.load(v, k) for k, v in
             {"Ao": ao, "Bo": bo, "A": a, "B": b}.items()}
        build.reset_launches()
        results[dev] = (
            m["Ao"].join(m["Bo"], "RID=RID AND CID=CID", mul).collect(),
            m["A"].join(m["B"], "RID=RID", mul).collect(),
            m["A"].join(m["B"], "VAL=VAL", mul).collect())
        launches = dict(build.LAUNCHES)
    assert launches == {"merge_join": 1, "coo_expand": 2, "bloom_probe": 1,
                        "masked_matmul": 0, "sddmm_agg": 0}
    (oc, dc, vc), (og, dg, vg) = results["cpu"], results["cuda"]
    torch.testing.assert_close(og.value.cpu(), oc.value, atol=1e-5,
                               rtol=1e-5)
    for host, card in ((dc, dg), (vc, vg)):
        assert np.array_equal(card.idx, host.idx)
        np.testing.assert_allclose(card.val, host.val, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# masked_matmul and sddmm_agg (the PNMF path)
# ---------------------------------------------------------------------------

PNMF_SHAPES = [(300, 257), (1024, 768)]
PNMF_BS = [16, 64, 128, 256, 512]
PNMF_K = [1, 7, 32, 300]
PNMF_DENSITY = [0.0, 0.4, 1.0]
MM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=5e-2, rtol=1e-2)}
AGG_TOL = {torch.float32: dict(atol=5e-4, rtol=1e-4),
           torch.float64: dict(atol=1e-9, rtol=1e-9)}


def _mask(rng, shape, bs, density, device):
    grid = (-(-shape[0] // bs), -(-shape[1] // bs))
    return torch.as_tensor(rng.uniform(size=grid) < density, device=device)


def _expand(mask, shape, bs):
    return mask.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[
        : shape[0], : shape[1]]


@pytest.mark.parametrize("shape", PNMF_SHAPES)
@pytest.mark.parametrize("bs", PNMF_BS)
@pytest.mark.parametrize("k", PNMF_K)
@pytest.mark.parametrize("density", PNMF_DENSITY)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_matmul_kernel_matches_plain(cuda, shape, bs, k, density,
                                            dtype):
    rng = np.random.default_rng(4)
    m, n = shape
    a = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.normal(size=(k, n)), dtype=dtype, device=cuda)
    mask = _mask(rng, shape, bs, density, cuda)
    before = build.LAUNCHES["masked_matmul"]
    got = masked_matmul_cuda(a, b, mask, block_size=bs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["masked_matmul"] == before + 1
    want = masked_matmul_plain(a, b, mask, block_size=bs)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **MM_TOL[dtype])
    dead = ~_expand(mask, shape, bs)
    assert bool((got[dead] == 0).all())


def test_masked_matmul_writes_every_dead_element(cuda):
    """The output comes from ``torch.empty``: dead tiles must be stored as
    zeros, not left as what the allocator handed back."""
    _check_dead_elements_written(cuda)


def test_masked_matmul_counter_starts_at_zero_on_every_call(cuda):
    """The same NaN-filled check twice in a row: a work counter left at
    its end count by the first call would make the second skip units and
    leave NaN behind."""
    _check_dead_elements_written(cuda)
    _check_dead_elements_written(cuda)


def _check_dead_elements_written(cuda):
    rng = np.random.default_rng(5)
    m, k, n, bs = 1000, 32, 1000, 256
    junk = torch.full((m, n), float("nan"), device=cuda)
    del junk                      # the caching allocator reuses the block
    a = torch.as_tensor(rng.uniform(size=(m, k)), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.uniform(size=(k, n)), dtype=torch.float32,
                        device=cuda)
    mask = _mask(rng, (m, n), bs, 0.4, cuda)
    got = masked_matmul_cuda(a, b, mask, block_size=bs)
    assert not bool(got.isnan().any())
    assert bool((got[~_expand(mask, (m, n), bs)] == 0).all())
    none = masked_matmul_cuda(a, b, torch.zeros_like(mask), block_size=bs)
    assert not bool(none.any())


def test_masked_matmul_reads_transposed_views_in_place(cuda):
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.normal(size=(40, 300)), dtype=torch.float32,
                        device=cuda)
    h = torch.as_tensor(rng.normal(size=(200, 40)), dtype=torch.float32,
                        device=cuda)
    mask = _mask(rng, (300, 200), 64, 0.5, cuda)
    got = masked_matmul_cuda(a.T, h.T, mask, block_size=64)
    want = masked_matmul_cuda(a.T.contiguous(), h.T.contiguous(), mask,
                              block_size=64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _mm_operands(rng, m, k, n, device):
    a = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                        device=device)
    b = torch.as_tensor(rng.normal(size=(k, n)), dtype=torch.float32,
                        device=device)
    return a, b


@pytest.mark.parametrize("live", [False, True])
def test_masked_matmul_4096_all_dead_and_all_live(cuda, live):
    """The two ends of the PNMF shapes (K = 32): every unit dead is zeros
    exactly, every unit live is the whole product."""
    rng = np.random.default_rng(12)
    m = n = 4096
    a, b = _mm_operands(rng, m, 32, n, cuda)
    mask = torch.full((m // 256, n // 256), live, device=cuda)
    got = masked_matmul_cuda(a, b, mask, block_size=256)
    if live:
        want = masked_matmul_plain(a, b, mask, block_size=256)
        torch.testing.assert_close(got, want, **MM_TOL[torch.float32])
    else:
        assert not bool(got.any())


def test_masked_matmul_grid_smaller_than_pool(cuda):
    """A 64 × 64 output is one unit: the launch has fewer units than the
    pool has CTAs, and every element is still written."""
    sms, per_sm = pool()
    assert sms >= 1 and per_sm >= 2
    rng = np.random.default_rng(13)
    a, b = _mm_operands(rng, 64, 7, 64, cuda)
    mask = _mask(rng, (64, 64), 16, 0.5, cuda)
    junk = torch.full((64, 64), float("nan"), device=cuda)
    del junk
    got = masked_matmul_cuda(a, b, mask, block_size=16)
    want = masked_matmul_plain(a, b, mask, block_size=16)
    torch.testing.assert_close(got, want, **MM_TOL[torch.float32])
    assert bool((got[~_expand(mask, (64, 64), 16)] == 0).all())


@pytest.mark.parametrize("bs", [16, 256])
def test_masked_matmul_is_bit_identical_across_launches(cuda, bs):
    rng = np.random.default_rng(14)
    a, b = _mm_operands(rng, 1024, 300, 768, cuda)
    mask = _mask(rng, (1024, 768), bs, 0.4, cuda)
    first = masked_matmul_cuda(a, b, mask, block_size=bs)
    for _ in range(3):
        assert torch.equal(masked_matmul_cuda(a, b, mask, block_size=bs),
                           first)


@pytest.mark.parametrize("view", ["transposed", "offset", "padded rows"])
def test_masked_matmul_load_paths_agree_bit_for_bit(cuda, view):
    """Aligned float32 operands take the 16-byte load paths (cp.async for
    B); the same values as a transposed or misaligned view take the
    element loads. Both stage the same floats, so the results are equal.
    "padded rows": B's 299 columns in rows of 300 floats take cp.async,
    zero-filled past column 299, against the contiguous B's element
    loads."""
    rng = np.random.default_rng(15)
    m, k = 520, 40
    n = 299 if view == "padded rows" else 300
    a, b = _mm_operands(rng, m, k, n, cuda)
    if view == "transposed":
        a2, b2 = a.T.contiguous().T, b.T.contiguous().T
    elif view == "offset":
        a2 = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
        b2 = torch.empty(k * n + 1, device=cuda)[1:].view(k, n)
        a2.copy_(a)
        b2.copy_(b)
    else:
        a2 = a
        b2 = torch.empty(k, n + 1, device=cuda)[:, :n]
        b2.copy_(b)
    assert torch.equal(a2, a) and torch.equal(b2, b)
    mask = _mask(rng, (m, n), 64, 0.6, cuda)
    got = masked_matmul_cuda(a2, b2, mask, block_size=64)
    want = masked_matmul_cuda(a, b, mask, block_size=64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_masked_matmul_refuses_float64(cuda):
    a = torch.zeros(8, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        masked_matmul_cuda(a, a, torch.ones(1, 1, dtype=torch.bool,
                                            device=cuda), block_size=8)


def _agg_inputs(rng, shape, k, bs, density, dtype, device):
    """sp zero under every dead mask entry, so the plain version (which
    reads no mask) computes the same function. float32 values are
    non-negative, as PNMF's are."""
    m, n = shape
    draw = rng.uniform if dtype == torch.float32 else rng.normal
    mask = _mask(rng, shape, bs, density, device)
    sp = torch.as_tensor(np.where(rng.uniform(size=shape) < 0.3,
                                  draw(size=shape), 0.0), dtype=dtype,
                         device=device)
    sp = torch.where(_expand(mask, shape, bs), sp, 0.0)
    w = torch.as_tensor(draw(size=(m, k)), dtype=dtype, device=device)
    h = torch.as_tensor(draw(size=(k, n)), dtype=dtype, device=device)
    return sp, w, h, mask


@pytest.mark.parametrize("shape", PNMF_SHAPES)
@pytest.mark.parametrize("bs", PNMF_BS)
@pytest.mark.parametrize("k", PNMF_K)
@pytest.mark.parametrize("density", PNMF_DENSITY)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sddmm_agg_kernel_matches_plain(cuda, shape, bs, k, density, dtype):
    rng = np.random.default_rng(7)
    sp, w, h, mask = _agg_inputs(rng, shape, k, bs, density, dtype, cuda)
    for dim in ("row", "col", "all"):
        before = build.LAUNCHES["sddmm_agg"]
        got = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=bs)
        torch.cuda.synchronize()
        assert build.LAUNCHES["sddmm_agg"] == before + 1
        want = sddmm_agg_plain(sp, w, h, mask, dim=dim, block_size=bs)
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, **AGG_TOL[dtype])


@pytest.mark.parametrize("dim", ["row", "col", "all"])
def test_sddmm_agg_is_bit_identical_across_launches(cuda, dim):
    rng = np.random.default_rng(8)
    sp, w, h, mask = _agg_inputs(rng, (1024, 768), 32, 256, 0.4,
                                 torch.float32, cuda)
    first = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=256)
    for _ in range(3):
        assert torch.equal(sddmm_agg_cuda(sp, w, h, mask, dim=dim,
                                          block_size=256), first)


@pytest.mark.parametrize("dim", ["row", "col", "all"])
def test_sddmm_agg_dead_tiles_contribute_nothing(cuda, dim):
    """A mask that drops live data: the dropped tiles add exactly zero, as
    in the Pallas body (held to a masked float64 numpy sum)."""
    rng = np.random.default_rng(9)
    m, k, n, bs = 300, 7, 257, 64
    sp = rng.normal(size=(m, n))
    w, h = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    mask = rng.uniform(size=(-(-m // bs), -(-n // bs))) < 0.5
    big = np.repeat(np.repeat(mask, bs, 0), bs, 1)[:m, :n]
    prod = np.where(big, sp * (w @ h), 0.0)
    axis = {"row": 1, "col": 0, "all": None}[dim]
    want = np.sum(prod, axis=axis, keepdims=axis is not None)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    got = sddmm_agg_cuda(t(sp), t(w), t(h), t(mask), dim=dim, block_size=bs)
    np.testing.assert_allclose(got.cpu().numpy().reshape(np.shape(want)),
                               want, atol=1e-9, rtol=1e-9)
    none = sddmm_agg_cuda(t(sp), t(w), t(h), t(np.zeros_like(mask)),
                          dim=dim, block_size=bs)
    assert not bool(none.any())


def test_sddmm_agg_reads_transposed_views_in_place(cuda):
    rng = np.random.default_rng(10)
    sp, w, h, mask = _agg_inputs(rng, (300, 257), 7, 64, 0.6,
                                 torch.float64, cuda)
    col_major = [x.T.contiguous().T for x in (sp, w, h)]
    for dim in ("row", "col", "all"):
        got = sddmm_agg_cuda(*col_major, mask, dim=dim, block_size=64)
        want = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=64)
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("dim", ["row", "col", "all"])
@pytest.mark.parametrize("live", [False, True])
def test_sddmm_agg_4096_all_dead_and_all_live(cuda, live, dim):
    """The two ends of the PNMF shapes (K = 32): every unit dead is zeros
    exactly, even with sp nonzero everywhere; every unit live is the whole
    sum."""
    rng = np.random.default_rng(16)
    m = n = 4096
    sp, w, h, _ = _agg_inputs(rng, (m, n), 32, 256, 1.0, torch.float32,
                              cuda)
    mask = torch.full((m // 256, n // 256), live, device=cuda)
    got = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=256)
    if live:
        want = sddmm_agg_plain(sp, w, h, mask, dim=dim, block_size=256)
        torch.testing.assert_close(got, want, **AGG_TOL[torch.float32])
    else:
        assert bool((sp != 0).any()) and not bool(got.any())


@pytest.mark.parametrize("dim", ["row", "col", "all"])
def test_sddmm_agg_grid_smaller_than_pool(cuda, dim):
    """A 64 × 64 sp is one unit in one batch: the launch has fewer draws
    than the pool has CTAs."""
    sms, per_sm = sddmm_agg_pool()
    assert sms >= 1 and per_sm >= 2
    rng = np.random.default_rng(17)
    sp, w, h, mask = _agg_inputs(rng, (64, 64), 7, 16, 0.5, torch.float32,
                                 cuda)
    got = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=16)
    want = sddmm_agg_plain(sp, w, h, mask, dim=dim, block_size=16)
    torch.testing.assert_close(got, want, **AGG_TOL[torch.float32])


@pytest.mark.parametrize("dim", ["row", "col", "all"])
def test_sddmm_agg_scratch_is_rewritten_on_every_call(cuda, dim):
    """Two calls in a row, the blocks of the partials and of the unit list
    filled with NaN and with a unit count past the end before each: the
    launch must write the list and every partial it reads (a dead unit's
    partial is read but never added)."""
    rng = np.random.default_rng(18)
    shape, bs = (1000, 1000), 256
    sp, w, h, mask = _agg_inputs(rng, shape, 32, bs, 0.4, torch.float32,
                                 cuda)
    want = sddmm_agg_plain(sp, w, h, mask, dim=dim, block_size=bs)
    um, un = -(-shape[0] // 128), -(-shape[1] // 128)   # 128² units
    size = {"row": un * shape[0], "col": um * shape[1], "all": um * un}[dim]
    for _ in range(2):
        junk = (torch.full((size,), float("nan"), device=cuda),
                torch.full((um * un + 1,), um * un, dtype=torch.int32,
                           device=cuda))
        del junk                  # the caching allocator reuses the blocks
        got = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=bs)
        torch.testing.assert_close(got, want, **AGG_TOL[torch.float32])


@pytest.mark.parametrize("view", ["transposed", "offset", "padded rows"])
def test_sddmm_agg_load_paths_agree_bit_for_bit(cuda, view):
    """Aligned float32 operands take the 16-byte load paths (cp.async for
    sp and H); the same values as a transposed or misaligned view take
    the element loads. Both stage the same floats, so the results are
    equal. "padded rows": sp and H with 299 columns in rows of 300 floats
    take cp.async, zero-filled past column 299, against the contiguous
    operands' element loads."""
    rng = np.random.default_rng(19)
    m, k = 520, 40
    n = 299 if view == "padded rows" else 300
    sp, w, h, mask = _agg_inputs(rng, (m, n), k, 64, 0.6, torch.float32,
                                 cuda)
    if view == "transposed":
        views = [x.T.contiguous().T for x in (sp, w, h)]
    elif view == "offset":
        views = []
        for x in (sp, w, h):
            y = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
            y.copy_(x)
            views.append(y)
    else:
        views = []
        for x in (sp, w, h):
            y = torch.empty(x.shape[0], 300, device=cuda)[:, : x.shape[1]]
            y.copy_(x)
            views.append(y)
    assert all(torch.equal(y, x) for x, y in zip((sp, w, h), views))
    for dim in ("row", "col", "all"):
        got = sddmm_agg_cuda(*views, mask, dim=dim, block_size=64)
        want = sddmm_agg_cuda(sp, w, h, mask, dim=dim, block_size=64)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_pnmf_queries_on_the_card_launch_the_kernels_and_match_cpu(cuda):
    """Q7–Q10's shapes of query, small: on the card the masked nodes
    launch masked_matmul and sddmm_agg, and agree with the CPU session."""
    from repro_torch.core import Session
    rng = np.random.default_rng(11)
    n, bs, k = 1024, 64, 8
    g = n // bs
    ap = np.where(rng.uniform(size=(n, n)) < 0.05,
                  np.abs(rng.normal(size=(n, n))), 0).astype(np.float32)
    for blk in rng.permutation(g * g)[: int(0.7 * g * g)]:
        ap[(blk // g) * bs:(blk // g + 1) * bs,
           (blk % g) * bs:(blk % g + 1) * bs] = 0
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    h = np.abs(rng.normal(size=(k, n))).astype(np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        s = Session(block_size=bs, device=dev)
        A, W, H = s.load(ap, "Ap"), s.load(w, "W"), s.load(h, "H")
        build.reset_launches()
        results[dev] = [A.ediv(W.multiply(H)).multiply(H.t()).collect()] + [
            A.emul(W.multiply(H)).sum(d).collect() for d in "rca"]
        launches = dict(build.LAUNCHES)
    assert launches["masked_matmul"] == 1 and launches["sddmm_agg"] == 3
    for host, card in zip(results["cpu"], results["cuda"]):
        torch.testing.assert_close(card.value.cpu(), host.value, atol=1e-5,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# faults and the serving tier on the card
# ---------------------------------------------------------------------------

def test_faulted_cuda_dispatch_raises_then_quarantines(cuda, monkeypatch):
    """A ``kernel_dispatch:backend=cuda`` schedule makes dispatch raise;
    after the breaker's threshold dispatch raises ``KernelQuarantined``;
    no launch is counted and the plain version is never called."""
    from repro_torch.kernels import registry
    from repro_torch.runtime import faults
    monkeypatch.setattr(registry, "BREAKER", registry.CircuitBreaker(
        threshold=3, cooldown_s=3600.0))
    spec = registry.get("masked_matmul")
    plain_calls = []
    plain = spec.impls[registry.TORCH]
    monkeypatch.setitem(spec.impls, registry.TORCH,
                        lambda *a, **kw: plain_calls.append(1) or
                        plain(*a, **kw))
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(256, 32)), dtype=torch.float32,
                        device=cuda)
    h = torch.as_tensor(rng.normal(size=(32, 256)), dtype=torch.float32,
                        device=cuda)
    mask = torch.ones((4, 4), dtype=torch.bool, device=cuda)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    with faults.inject("kernel_dispatch:backend=cuda"):
        for _ in range(3):
            with pytest.raises(faults.FaultInjected):
                registry.dispatch("masked_matmul", w, h, mask, block_size=64)
        with pytest.raises(registry.KernelQuarantined):
            registry.dispatch("masked_matmul", w, h, mask, block_size=64)
    # quarantined without a fault plan: still refused, nothing launched
    with pytest.raises(registry.KernelQuarantined):
        registry.dispatch("masked_matmul", w, h, mask, block_size=64)
    assert dict(build.LAUNCHES) == before
    assert plain_calls == []


def test_unsupported_merges_leave_the_card_serving(cuda, monkeypatch):
    """Three tickets whose overlay ``merge_join_cuda`` refuses (a merge of
    degree 3) fail alone: no launch, no retry, the breaker stays closed,
    and another tenant's supported overlay then launches the kernel."""
    from repro_torch.core import Session
    from repro_torch.core.sparsity import product_merge
    from repro_torch.kernels import registry
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(registry, "BREAKER", registry.CircuitBreaker(
        threshold=3, cooldown_s=3600.0))
    rng = np.random.default_rng(4)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    a[:64, :] = 0.0
    b[:, :64] = 0.0                          # 9 of 16 blocks live

    def cubic(x, y):
        return x * x * y

    s = Session(block_size=64, device="cuda")
    A, B = s.load(a, "A"), s.load(b, "B")
    before = build.LAUNCHES["merge_join"]
    with ServeEngine(s, cse=False, n_threads=1, retry_backoff_s=0.0) as eng:
        for _ in range(3):
            with pytest.raises(NotImplementedError):
                eng.run(A.join(B, "RID=RID AND CID=CID", cubic),
                        tenant="t0", timeout=120.0)
        assert build.LAUNCHES["merge_join"] == before
        got = eng.run(A.join(B, "RID=RID AND CID=CID", product_merge()),
                      tenant="t1", timeout=120.0)
        snap = eng.snapshot()
    assert build.LAUNCHES["merge_join"] == before + 1
    assert registry.BREAKER.state(registry.CUDA) == "closed"
    assert snap["exec_retries"] == 0 and snap["degraded_eager"] == 0
    assert snap["errors"] == 3 and snap["completed"] == 1
    torch.testing.assert_close(got.value.cpu(), torch.as_tensor(a * b),
                               atol=1e-6, rtol=1e-6)


def test_serving_engine_on_the_card_matches_the_cpu(cuda):
    """The dim-48 serving stream through ``ServeEngine`` on the card and
    on the CPU: every template's result equal (f32 atol/rtol 1e-5,
    reductions rtol 1e-4), the CSE counters equal with one worker."""
    from repro_torch.core import Session
    from repro_torch.serve import workload as wl
    from repro_torch.serve.engine import ServeEngine
    results, stats = {}, {}
    for dev in ("cpu", "cuda"):
        rng = np.random.default_rng(0)
        s = Session(block_size=8, device=dev)
        templates = wl.query_templates(wl.synthetic_catalog(s, rng, n=48))
        with ServeEngine(s, cse=True, n_threads=2) as eng:
            tickets = [(name, eng.submit(expr)) for name, expr in templates]
            results[dev] = {name: t.result(timeout=120.0).value.cpu()
                            for name, t in tickets}
        stream = wl.client_stream(rng, templates, n_clients=100)
        stats[dev] = wl.run_workload(s, stream, n_threads=1)["stats"]
    for name, want in results["cpu"].items():
        rtol = 1e-4 if name in ("gram_trace", "gram_rowsum",
                                "xy_colsum") else 1e-5
        torch.testing.assert_close(results["cuda"][name], want, atol=1e-5,
                                   rtol=rtol, msg=name)
    for key in ("completed", "errors", "root_hits", "inter_query_cse_nodes",
                "leaf_scans", "leaf_refs"):
        assert stats["cuda"][key] == stats["cpu"][key], key
    assert stats["cuda"]["errors"] == 0


def test_four_workers_launch_each_kernel_once_a_worker_on_the_card(cuda):
    """``Session(n_workers=4)`` on the card: a block-sparse overlay, a
    masked matmul and the three masked aggregations launch their kernel
    once a worker on that worker's shard (1024 rows split on 64-row block
    edges), and give the one-worker card result (the overlay exactly,
    the products and sums rtol 1e-4)."""
    from repro_torch.core import Session
    from repro_torch.core.sparsity import product_merge
    rng = np.random.default_rng(11)
    m, bs = 1024, 64
    g = m // bs

    def blocky(live, d):
        keep = np.kron(rng.uniform(size=(g, g)) < live, np.ones((bs, bs)))
        v = np.where(rng.uniform(size=(m, m)) < d, rng.normal(size=(m, m)),
                     0)
        return (v * keep).astype(np.float32)
    arrays = {"Ao": blocky(0.8, 0.1), "Bo": blocky(0.9, 0.1),
              "Ap": np.abs(blocky(0.3, 0.1)),
              "W": np.abs(rng.normal(size=(m, 16))).astype(np.float32),
              "H": np.abs(rng.normal(size=(16, m))).astype(np.float32)}

    def queries(s):
        mats = {n: s.load(v, n) for n, v in arrays.items()}
        wh = mats["W"].multiply(mats["H"])
        return {
            "merge_join": mats["Ao"].join(mats["Bo"], "RID=RID AND CID=CID",
                                          product_merge()),
            "masked_matmul": mats["Ap"].ediv(wh),
            "sddmm_agg r": mats["Ap"].emul(wh).sum("r"),
            "sddmm_agg c": mats["Ap"].emul(wh).sum("c"),
            "sddmm_agg a": mats["Ap"].emul(wh).sum("a"),
        }
    one = {k: q.collect().value for k, q in
           queries(Session(block_size=bs, device=cuda)).items()}
    s4 = Session(block_size=bs, device=cuda, n_workers=4)
    # a matrix of another session on the card loads as is ("cuda" names
    # the current card, "cuda:0" its index)
    other = Session(block_size=bs, device="cuda:0")
    other.load(arrays["W"], "W")
    s4.load(other.env["W"], "W0")
    for name, q in queries(s4).items():
        kernel = name.split()[0]
        q.physical_plan()                     # plan outside the count
        build.reset_launches()
        got = q.collect().value
        torch.cuda.synchronize()
        assert build.LAUNCHES[kernel] == 4, (name, dict(build.LAUNCHES))
        assert sum(build.LAUNCHES.values()) == 4, dict(build.LAUNCHES)
        if kernel == "merge_join":
            assert torch.equal(got, one[name]), name
        else:
            torch.testing.assert_close(got, one[name], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Tiles: every member of a kernel's grid changes its scheduling, never its
# bits; a tile outside the grid is a refusal.
# ---------------------------------------------------------------------------

def _grid(name):
    from repro_torch.kernels import registry
    spec = registry.get(name)
    return [dict(t) for t in spec.tile_grid], dict(spec.default_tiles)


def _same_bits(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8) if g.is_floating_point()
                           else g, w.view(torch.uint8)
                           if w.is_floating_point() else w)


def _q4_like(rng, device):
    """A D2D expansion of the main path's size: 268 435 probe entries
    (16384² at density 1e-3), each run ~16 partners long (≈4.4 M slots)."""
    counts = rng.poisson(16.4, 268435)
    return _inputs_from_counts(rng, counts, 268435, 1, torch.float32,
                               torch.int16, device), int(counts.sum())


@pytest.mark.parametrize("case", ["main path", "long segment", "empty runs",
                                  "ns=1", "cap=run+1", "cap past total"])
@pytest.mark.parametrize("dtype,cdt,cb", [(torch.float32, torch.int16, 1),
                                          (torch.float32, torch.int16, 2),
                                          (torch.float32, torch.int32, 2)])
def test_coo_expand_every_tile_gives_the_defaults_bits(cuda, case, dtype,
                                                       cdt, cb):
    rng = np.random.default_rng(30)
    if case == "main path":
        counts = rng.poisson(16.4, 268435)
        cap = int(counts.sum())
    else:
        counts, cap = _counts_case(rng, case)
    ins = _inputs_from_counts(rng, counts, 25000, cb, dtype, cdt, cuda)
    grid, default = _grid("coo_expand")
    fn = MERGES["affine"]
    want = coo_expand_cuda(*ins, merge=fn, cap=cap, tiles=default)
    _same_bits(coo_expand_cuda(*ins, merge=fn, cap=cap), want)
    for tiles in grid:
        _same_bits(coo_expand_cuda(*ins, merge=fn, cap=cap, tiles=tiles),
                   want)
    idx_p, val_p = coo_expand_plain(*ins, merge=fn, cap=cap)
    assert torch.equal(want[0], idx_p)
    torch.testing.assert_close(want[1], val_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ca,cb,dtype", [(3, 2, torch.float32),
                                         (12, 12, torch.float32),
                                         (3, 2, torch.float64)])
def test_coo_expand_run_time_widths_take_every_tile(cuda, ca, cb, dtype):
    rng = np.random.default_rng(31)
    counts, cap = _counts_case(rng, "cap past total")
    ins = _inputs_from_counts(rng, counts, 9000, cb, dtype, torch.int32,
                              cuda, ca=ca)
    grid, default = _grid("coo_expand")
    fn = MERGES["add"]
    want = coo_expand_cuda(*ins, merge=fn, cap=cap)
    for tiles in grid:
        _same_bits(coo_expand_cuda(*ins, merge=fn, cap=cap, tiles=tiles),
                   want)


def test_coo_expand_float64_joins_refuse_other_tiles(cuda):
    """float64 values at the joins' widths have the default's instance
    only: another vt raises ``ValueError`` and launches nothing."""
    rng = np.random.default_rng(32)
    counts, cap = _counts_case(rng, "cap=run+1")
    ins = _inputs_from_counts(rng, counts, 9000, 2, torch.float64,
                              torch.int16, cuda)
    grid, default = _grid("coo_expand")
    before = build.LAUNCHES["coo_expand"]
    for tiles in grid:
        if tiles == default:
            continue
        with pytest.raises(ValueError, match="float64"):
            coo_expand_cuda(*ins, merge=MERGES["mul"], cap=cap, tiles=tiles)
    assert build.LAUNCHES["coo_expand"] == before


@pytest.mark.parametrize("shape,k,bs,dtype", [
    ((4096, 4096), 32, 256, torch.float32),     # the PNMF shape, cut
    ((300, 257), 1, 16, torch.float32), ((300, 257), 7, 64, torch.float32),
    ((1024, 768), 300, 128, torch.float32),
    ((1024, 768), 300, 256, torch.bfloat16), ((300, 257), 33, 16,
                                              torch.bfloat16)])
@pytest.mark.parametrize("view", ["contiguous", "transposed"])
def test_masked_matmul_every_tile_gives_the_defaults_bits(cuda, shape, k, bs,
                                                          dtype, view):
    rng = np.random.default_rng(33)
    m, n = shape
    a = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.normal(size=(k, n)), dtype=dtype, device=cuda)
    if view == "transposed":
        a, b = a.T.contiguous().T, b.T.contiguous().T
    mask = _mask(rng, shape, bs, 0.3, cuda)
    grid, default = _grid("masked_matmul")
    want = masked_matmul_cuda(a, b, mask, block_size=bs)
    for tiles in grid:
        _same_bits(masked_matmul_cuda(a, b, mask, block_size=bs,
                                      tiles=tiles), want)
    torch.testing.assert_close(want.float(), masked_matmul_plain(
        a, b, mask, block_size=bs).float(), **MM_TOL[dtype])


def test_masked_matmul_pool_follows_the_tile(cuda):
    """Two CTAs an SM at kc 16 and 32; kc 64's panels (135,168 B) leave
    room for one."""
    assert pool({"kc": 16})[1] >= 2 and pool({"kc": 32})[1] >= 2
    assert pool({"kc": 64})[1] == 1
    assert pool() == pool({"kc": 32})


@pytest.mark.parametrize("n,log2_bits,num_hashes,offset", [
    (Q5_N, 20, 3, 0), (Q5_N, 20, 3, 1), (Q5_N, 12, 3, 0), (257, 20, 5, 1),
    (1, 20, 3, 0), (Q5_N, 21, 3, 0)])
def test_bloom_probe_every_tile_gives_the_defaults_bits(cuda, n, log2_bits,
                                                        num_hashes, offset):
    from repro_torch.kernels.bloom_probe import plan
    rng = np.random.default_rng(34)
    words, vals, _ = _bloom_case(rng, n, log2_bits, num_hashes, offset)
    kw = dict(num_hashes=num_hashes, log2_bits=log2_bits)
    grid, default = _grid("bloom_probe")
    want = _check_bloom(words, vals, **kw)
    for tiles in grid:
        _same_bits(bloom_probe_cuda(words, vals, tiles=tiles, **kw), want)
        p = plan(words, vals, tiles=tiles, **kw)
        # the shared path's CTA follows the tile; the global path keeps 256
        assert p["threads"] == (tiles["threads"] if p["path"] == "shared"
                                else 256)


@pytest.mark.parametrize("name", ["coo_expand", "masked_matmul",
                                  "bloom_probe", "merge_join", "sddmm_agg"])
def test_a_tile_outside_the_grid_is_a_refusal_on_the_card(cuda, monkeypatch,
                                                          name):
    """Through ``registry.dispatch``: ``ValueError`` before any launch,
    with the breaker left closed."""
    from repro_torch.kernels import registry
    breaker = registry.CircuitBreaker(threshold=1, cooldown_s=3600.0)
    monkeypatch.setattr(registry, "BREAKER", breaker)
    rng = np.random.default_rng(35)
    t = lambda x, d=torch.float32: torch.as_tensor(x, dtype=d,  # noqa: E731
                                                   device=cuda)
    if name == "coo_expand":
        counts, cap = _counts_case(rng, "cap=1")
        args = _inputs_from_counts(rng, counts, 900, 1, torch.float32,
                                   torch.int16, cuda)
        kw = {"merge": MERGES["mul"], "cap": cap}
    elif name == "bloom_probe":
        words, vals, _ = _bloom_case(rng, 100, 12, 3)
        args, kw = (words, vals), {"num_hashes": 3, "log2_bits": 12}
    elif name == "merge_join":
        a = t(rng.normal(size=(64, 64)))
        mk = torch.ones((4, 4), dtype=torch.bool, device=cuda)
        args, kw = (a, a, mk, mk), {"merge": MERGES["mul"],
                                    "block_size": 16}
    else:
        w, h = t(rng.normal(size=(64, 8))), t(rng.normal(size=(8, 64)))
        mk = torch.ones((4, 4), dtype=torch.bool, device=cuda)
        args, kw = ((w, h, mk), {"block_size": 16}) \
            if name == "masked_matmul" else \
            ((t(rng.normal(size=(64, 64))), w, h, mk),
             {"block_size": 16, "dim": "row"})
    before = dict(build.LAUNCHES)
    for bad in ({"vt": 5}, {"kc": 48}, {"threads": 128}):
        with pytest.raises(ValueError, match="outside its grid"):
            registry.dispatch(name, *args, tiles=bad, **kw)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == before
    assert breaker.state(registry.CUDA) == "closed"
    registry.dispatch(name, *args, **kw)      # and the backend still runs
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before[name] + 1


def test_best_tiles_with_a_real_runner_caches_a_member_of_the_grid(
        cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import autotune, registry
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    autotune.clear_cache()
    autotune.reset_stats()
    try:
        rng = np.random.default_rng(36)
        ins, cap = _q4_like(rng, cuda)
        fn = MERGES["mul"]
        shapes = registry._arg_shapes(ins)
        best = autotune.best_tiles(
            "coo_expand", shapes, "float32", registry.CUDA,
            runner=lambda tiles: coo_expand_cuda(*ins, merge=fn, cap=cap,
                                                 tiles=tiles))
        grid, _ = _grid("coo_expand")
        assert best in grid
        assert autotune.tune_stats()["trials"] == len(grid) * 3
        assert autotune.cached_tiles("coo_expand", shapes, "float32",
                                     registry.CUDA) == best
        saved = json.loads((tmp_path / "a.json").read_text())["entries"]
        assert list(saved.values()) == [best]
        assert autotune.device_kind().startswith("cuda:")
    finally:
        autotune.clear_cache()
        autotune.reset_stats()


# ---------------------------------------------------------------------------
# The LM substrate: card against CPU (f32 compute, rel 1e-4; the card's f32
# matmuls never run as TF32) and the MoE combine's determinism.
# ---------------------------------------------------------------------------

LM_ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b", "command-r-plus-104b",
            "qwen2.5-14b", "stablelm-12b", "qwen3-1.7b", "phi-3-vision-4.2b",
            "whisper-small", "jamba-v0.1-52b", "rwkv6-7b")


def _lm_rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _lm_setup(arch, compute, device):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api as tapi
    from repro_torch.models.module import init_params, tree_map
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype=compute)
    params = init_params(tapi.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (2, 17)), dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(2, 16, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.as_tensor(
            rng.normal(size=(2, cfg.n_img_tokens, cfg.img_embed_dim)),
            dtype=torch.float32)
    on = {k: v.to(device) for k, v in batch.items()}
    card = tree_map(lambda t: t.to(device), params)
    return tapi, cfg, params, batch, card, on


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_the_card_matches_cpu_f32(cuda, arch):
    assert not torch.backends.cuda.matmul.allow_tf32
    tapi, cfg, params, batch, card, on = _lm_setup(arch, torch.float32, cuda)
    want, _ = tapi.forward(params, cfg, batch)
    got, _ = tapi.forward(card, cfg, on)
    assert got.device == on["tokens"].device
    assert _lm_rel(got, want) < 1e-4, arch
    pre = {k: (v[:, :16] if k == "tokens" else v) for k, v in batch.items()}
    pre_on = {k: v.to(cuda) for k, v in pre.items()}
    pos = 16 + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    lp, c = tapi.prefill(params, cfg, pre, 32)
    lp_card, c_card = tapi.prefill(card, cfg, pre_on, 32)
    assert _lm_rel(lp_card, lp) < 1e-4, arch
    tok = batch["tokens"][:, 16:17]
    ld, _ = tapi.decode_step(params, cfg, c, tok, pos)
    ld_card, _ = tapi.decode_step(card, cfg, c_card, tok.to(cuda), pos)
    assert _lm_rel(ld_card, ld) < 1e-4, arch


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_moe_combine_is_deterministic_on_the_card(cuda, arch):
    from repro_torch.serve.step import generate
    tapi, cfg, params, batch, card, on = _lm_setup(arch, torch.bfloat16,
                                                   cuda)
    first, _ = tapi.forward(card, cfg, on)
    again, _ = tapi.forward(card, cfg, on)
    assert torch.equal(first, again)
    prompt = on["tokens"][:, :16]
    t1 = generate(card, cfg, prompt, 8, 32)
    t2 = generate(card, cfg, prompt, 8, 32)
    assert torch.equal(t1, t2)
