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
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, live_tiles, merge_join_cuda,
    merge_join_plain,
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
                s = Session(block_size=16, device=dev, n_workers=1)
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


@pytest.mark.parametrize("b_layout", ["contiguous", "transposed"])
def test_merge_join_refuses_more_units_than_a_grid_without_a_launch(
        cuda, b_layout):
    """A CTA a unit: a float32 46341² at block size 1 (one unit a tile)
    has more than 2**31 - 1 units, and the launcher refuses it."""
    m = n = 46341
    a = torch.empty((m, n), device=cuda)
    b = torch.empty((m, n), device=cuda)
    if b_layout == "transposed":
        b = b.T
    mask = torch.ones((m, n), dtype=torch.bool, device=cuda)
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError, match="merge_join kernel launch failed"):
        merge_join_cuda(a, b, mask, mask, merge=MERGES["mul"],
                        mode=MODE_BOTH, block_size=1)
    assert build.LAUNCHES == before
    del a, b, mask
    torch.cuda.empty_cache()


def _b_operand(rng, shape, dtype, device, b_layout):
    """B of ``shape`` as a contiguous tensor or as the view ``Bo.T`` of a
    contiguous Bo (a transpose overlay's operand)."""
    if b_layout == "contiguous":
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=device)
    bo = torch.as_tensor(rng.normal(size=shape[::-1]), dtype=dtype,
                         device=device)
    return bo.T


@pytest.mark.parametrize("b_layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("mode", [MODE_BOTH, MODE_X, MODE_Y, MODE_ALL])
@pytest.mark.parametrize("shape,bs", [((1024, 768), 256), ((300, 257), 128),
                                      ((512, 510), 256), ((260, 196), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_join_kernel_matches_plain(cuda, mode, shape, bs, dtype,
                                         b_layout):
    """Bit for bit: each element is the same bilinear merge of the same two
    values (2xy is exact, so contraction changes no bit)."""
    rng = np.random.default_rng(2)
    m, n = shape
    grid = (-(-m // bs), -(-n // bs))
    a = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
    b = _b_operand(rng, shape, dtype, cuda, b_layout)
    ma = torch.as_tensor(rng.uniform(size=grid) < 0.6, device=cuda)
    mb = torch.as_tensor(rng.uniform(size=grid) < 0.6, device=cuda)
    for name, fn in MERGES.items():
        kw = dict(merge=fn, mode=mode, block_size=bs)
        before = build.LAUNCHES["merge_join"]
        got = merge_join_cuda(a, b, ma, mb, **kw)
        assert build.LAUNCHES["merge_join"] == before + 1
        want = merge_join_plain(a, b, ma, mb, **kw)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("b_layout", ["contiguous", "transposed"])
def test_merge_join_dead_tiles_are_zeros_whatever_they_hold(cuda, b_layout):
    """A dead tile is never read: NaN and inf there give exact zeros."""
    rng = np.random.default_rng(6)
    shape, bs = (700, 520), 128
    a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda)
    b = _b_operand(rng, shape, torch.float32, cuda, b_layout)
    ma, mb = _mask(rng, shape, bs, 0.6, cuda), _mask(rng, shape, bs, 0.6,
                                                     cuda)
    for mode in (MODE_BOTH, MODE_X, MODE_Y):
        dead = ~_expand(live_tiles(ma, mb, mode), shape, bs)
        x, y = a.clone(), b.clone()
        x[dead] = float("nan")
        y[dead] = float("inf")
        got = merge_join_cuda(x, y, ma, mb, merge=MERGES["affine"],
                              mode=mode, block_size=bs)
        assert torch.equal(got[dead], torch.zeros_like(got[dead]))
        assert torch.equal(got, merge_join_plain(
            a, b, ma, mb, merge=MERGES["affine"], mode=mode, block_size=bs))


@pytest.mark.parametrize("b_layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_join_unaligned_operands_take_the_scalar_path(cuda, dtype,
                                                            b_layout):
    """Operands one element past a 16-byte boundary (views into a flat
    buffer) and a row length that no vector divides: the scalar path, the
    same bits."""
    rng = np.random.default_rng(7)

    def unaligned(m, n, transposed=False):
        flat = torch.as_tensor(rng.normal(size=m * n + 1), dtype=dtype,
                               device=cuda)[1:]
        return flat.view(n, m).T if transposed else flat.view(m, n)
    # (260, 196) / 64: rows a vector divides, pointers it does not;
    # (260, 250) / 50: a row length no 16-byte vector divides
    for (m, n), bs in (((260, 196), 64), ((260, 250), 50)):
        a = unaligned(m, n)
        b = unaligned(m, n, b_layout == "transposed")
        assert a.data_ptr() % 16 != 0 and b.data_ptr() % 16 != 0
        ma, mb = _mask(rng, (m, n), bs, 0.6, cuda), _mask(rng, (m, n), bs,
                                                          0.6, cuda)
        for mode in (MODE_BOTH, MODE_ALL):
            kw = dict(merge=MERGES["affine"], mode=mode, block_size=bs)
            assert torch.equal(merge_join_cuda(a, b, ma, mb, **kw),
                               merge_join_plain(a, b, ma, mb, **kw))


def test_merge_join_transposed_view_allocates_only_the_output(cuda):
    """B = Bo.T is read in place: the call's peak above what was allocated
    before it is the output (and the masks' copies), not a copy of B."""
    rng = np.random.default_rng(8)
    n, bs = 4096, 256
    a = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32,
                        device=cuda)
    bo = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32,
                         device=cuda)
    ma, mb = _mask(rng, (n, n), bs, 0.7, cuda), _mask(rng, (n, n), bs, 0.7,
                                                      cuda)
    mbt = mb.T
    kw = dict(merge=MERGES["mul"], mode=MODE_BOTH, block_size=bs)
    want = merge_join_plain(a, bo.T, ma, mbt, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = merge_join_cuda(a, bo.T, ma, mbt, **kw)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= a.nbytes + (1 << 20), grown     # 64 MiB out; B 64 MiB
    assert torch.equal(got, want)



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
        s = Session(block_size=bs, device=dev, n_workers=1)
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


@pytest.mark.parametrize("shape,k,bs", [((300, 257), 7, 16),
                                        ((1024, 768), 32, 256),
                                        ((520, 299), 300, 64)])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_masked_matmul_float64_matches_plain(cuda, shape, k, bs, density):
    """The float64 instance accumulates in double, as the Pallas body and
    the plain version do: within 1e-10 of the plain version, the same bits
    at every kc of the grid and from launch to launch, zeros under dead
    tiles; a transposed view gives the same bits."""
    from repro_torch.kernels import masked_matmul as mm
    rng = np.random.default_rng(16)
    m, n = shape
    a = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float64,
                        device=cuda)
    b = torch.as_tensor(rng.normal(size=(k, n)), dtype=torch.float64,
                        device=cuda)
    mask = _mask(rng, shape, bs, density, cuda)
    before = build.LAUNCHES["masked_matmul"]
    got = masked_matmul_cuda(a, b, mask, block_size=bs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["masked_matmul"] == before + 1
    want = masked_matmul_plain(a, b, mask, block_size=bs)
    assert got.dtype == torch.float64 and got.shape == (m, n)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)
    assert bool((got[~_expand(mask, shape, bs)] == 0).all())
    for tiles in mm.GRID:
        assert torch.equal(masked_matmul_cuda(a, b, mask, block_size=bs,
                                              tiles=tiles), got)
    at, bt = a.T.contiguous().T, b.T.contiguous().T
    assert torch.equal(masked_matmul_cuda(at, bt, mask, block_size=bs), got)


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
        s = Session(block_size=bs, device=dev, n_workers=1)
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
    """Three tickets whose overlay ``merge_join_cuda`` refuses (a merge
    the compiler refuses: a Python branch on a value) fail alone: no
    launch, no retry, the breaker stays closed, and another tenant's
    supported overlay then launches the kernel."""
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

    def branch(x, y):   # a Python branch on a value: refused (inducing
        return x * y if x > 0 else -x * y   # on both sides, as x*y is)

    s = Session(block_size=64, device="cuda", n_workers=1)
    A, B = s.load(a, "A"), s.load(b, "B")
    before = build.LAUNCHES["merge_join"]
    with ServeEngine(s, cse=False, n_threads=1, retry_backoff_s=0.0) as eng:
        for _ in range(3):
            with pytest.raises(NotImplementedError):
                eng.run(A.join(B, "RID=RID AND CID=CID", branch),
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
        s = Session(block_size=8, device=dev, n_workers=1)
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
    one = {k: q.collect().value for k, q in queries(
        Session(block_size=bs, device=cuda, n_workers=1)).items()}
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
# Several cards: every kernel launches on its operands' card whichever card
# is current, and a mesh puts one worker on each card. The fixture skips
# below two cards.
# ---------------------------------------------------------------------------

SUM_RTOL = 1e-4           # chip_smoke.py's: sums in another order


@pytest.fixture
def cards():
    """Every visible card; skips below two (decided here, never at
    import)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (the path across cards)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _kernel_case(name, dev):
    """``(cuda wrapper, plain version, args, kwargs, tolerance)`` of one
    call of kernel ``name`` on ``dev``, at shapes whose launches need the
    card's shared-memory opt-in (``masked_matmul`` at kc 64, the Bloom
    probe's shared path, ``coo_expand``'s instances); tolerance None is
    bit for bit."""
    rng = np.random.default_rng(17)
    shape, bs = (1024, 768), 128
    if name == "merge_join":
        a, b = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                device=dev) for _ in range(2))
        masks = [_mask(rng, shape, bs, 0.6, dev) for _ in range(2)]
        return (merge_join_cuda, merge_join_plain, (a, b, *masks),
                dict(merge=MERGES["affine"], mode=MODE_BOTH, block_size=bs),
                None)
    if name == "masked_matmul":
        a, b = _mm_operands(rng, shape[0], 32, shape[1], dev)
        return (masked_matmul_cuda, masked_matmul_plain,
                (a, b, _mask(rng, shape, bs, 0.4, dev)),
                dict(block_size=bs, tiles={"kc": 64}), MM_TOL[torch.float32])
    if name == "sddmm_agg":
        return (sddmm_agg_cuda, sddmm_agg_plain,
                _agg_inputs(rng, shape, 32, bs, 0.4, torch.float32, dev),
                dict(dim="row", block_size=bs), AGG_TOL[torch.float32])
    if name == "coo_expand":
        ins, cap, _ = _expand_inputs(rng, 3000, 2000, 2, 0.5, torch.float32,
                                     torch.int32, cap_extra=37)
        tol = TOL[torch.float32]
        return (coo_expand_cuda, coo_expand_plain, [x.to(dev) for x in ins],
                dict(merge=MERGES["mul"], cap=cap), dict(atol=tol, rtol=tol))
    words, vals, _ = _bloom_case(rng, Q5_N, 20, 3, device=dev)
    return (bloom_probe_cuda, bloom_probe_plain, (words, vals),
            dict(num_hashes=3, log2_bits=20), None)


def _same(got, want, tol):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _same(g, w, tol)
    elif tol is None or not got.is_floating_point():
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want.to(got.dtype), **tol)


@pytest.fixture
def launch_cards(monkeypatch):
    """``(operand card, current card)`` at every kernel launch: a wrapper
    takes its stream inside its device guard, just before the launch."""
    seen = []
    stream_ptr = build.stream_ptr

    def spy(t):
        seen.append((t.get_device(), torch.cuda.current_device()))
        return stream_ptr(t)
    monkeypatch.setattr(build, "stream_ptr", spy)
    return seen


@pytest.mark.parametrize("name", sorted(build.LAUNCHES))
def test_each_kernel_launches_on_its_operands_card(cards, launch_cards,
                                                   name):
    """With card 0 current, each kernel on every other card's operands
    (the last card first, so its one-time setup — pool, shared-memory
    opt-in — is made there before card 0's) equals its plain version
    there, launches on that card and leaves card 0 current; then on card
    0. Every card is synchronized first, so a fault on any shows."""
    with torch.cuda.device(0):
        for dev in cards[::-1]:
            fn, plain, args, kw, tol = _kernel_case(name, dev)
            launch_cards.clear()
            before = build.LAUNCHES[name]
            got = fn(*args, **kw)
            assert torch.cuda.current_device() == 0
            for card in cards:
                torch.cuda.synchronize(card)
            for t in (got if isinstance(got, tuple) else (got,)):
                assert t.device == dev
            _same(got, plain(*args, **kw), tol)
            assert build.LAUNCHES[name] == before + 1
            assert launch_cards == [(dev.index, dev.index)], launch_cards


def _mesh_arrays(rng, m, bs):
    """The main path's kernel queries' catalog at a small size: Q3's
    block-sparse overlay operands, Q5's integer values, Q7–Q10's Ap, W,
    H (chip_smoke.py's make_data, cut to m²)."""
    g = m // bs

    def blocky(live, d):
        keep = np.kron(rng.uniform(size=(g, g)) < live, np.ones((bs, bs)))
        v = np.where(rng.uniform(size=(m, m)) < d, rng.normal(size=(m, m)),
                     0)
        return (v * keep).astype(np.float32)

    def ints():
        keep = rng.uniform(size=(m, m)) < 0.01
        return np.where(keep, rng.integers(1, m + 1, (m, m)),
                        0).astype(np.float32)
    return {"Ao": blocky(0.8, 0.1), "Bo": blocky(0.9, 0.1),
            "Aq": ints(), "Bq": ints(), "Ap": np.abs(blocky(0.3, 0.1)),
            "W": np.abs(rng.normal(size=(m, 16))).astype(np.float32),
            "H": np.abs(rng.normal(size=(16, m))).astype(np.float32)}


def _mesh_queries(s, arrays):
    from repro_torch.core.sparsity import product_merge
    mats = {n: s.load(v, n) for n, v in arrays.items()}
    mul = product_merge()
    wh = mats["W"].multiply(mats["H"])
    out = {"Q3": mats["Ao"].join(mats["Bo"], "RID=RID AND CID=CID", mul),
           "Q5": mats["Aq"].join(mats["Bq"], "VAL=VAL", mul),
           "Q7": mats["Ap"].ediv(wh).multiply(mats["H"].t())}
    for qn, dim in (("Q8", "r"), ("Q9", "c"), ("Q10", "a")):
        out[qn] = mats["Ap"].emul(wh).sum(dim)
    return out


def _dense_pipeline(s, x, y):
    """``benchmarks/bench_dist_comm.py``'s ((σ(XᵀX) ⋈ Y) ⋈ Y) ⋈ Y."""
    from repro_torch.core.expr import MergeFn
    xm, ym = s.load(x, "X"), s.load(y, "Y")
    k = y.shape[0]
    add = MergeFn("dist_add", lambda a, b: a + b)
    mul = MergeFn("dist_mul", lambda a, b: a * b)
    return (xm.t().multiply(xm).select(f"RID>=0 AND RID<={k - 1}")
            .join(ym, "RID=RID AND CID=CID", add)
            .join(ym, "RID=RID AND CID=CID", mul)
            .join(ym, "RID=CID AND CID=RID", add))


def _counted(q):
    """The collective bytes of one more run of ``q`` on its session's
    mesh."""
    from repro_torch.plan import PlanExecutor
    s = q.session
    ex = PlanExecutor(s.env, device=s.device, mesh=s.mesh)
    ex.run(q.physical_plan())
    for d in set(s.mesh.devices):
        torch.cuda.synchronize(d)
    return ex.stats["collective_bytes"]


def test_mesh_across_cards_matches_the_one_card_mesh(cards, launch_cards,
                                                     monkeypatch):
    """Q3, Q5, Q7–Q10 and the dense pipeline on min(4, cards) workers, one
    a card, against the same worker count on card 0 alone: the overlay
    and the V2V join exactly, products and sums within ``SUM_RTOL``; the
    counted collective bytes equal (and the dense pipeline's equal the
    scheme pass's prediction); every shard of every value on its
    worker's card; the gated kernels launch once a worker, each on its
    worker's card, and Q5's COO join on worker 0's."""
    from repro_torch.core import Session, spmd
    from repro_torch.plan.schemes import ENTRY_BYTES
    w = min(4, len(cards))
    rng = np.random.default_rng(23)
    arrays = _mesh_arrays(rng, 1024, 64)
    x = rng.normal(size=(512, 256)).astype(np.float32)
    y = rng.normal(size=(256, 256)).astype(np.float32)

    def queries(one_card):
        sparse = Session(block_size=64, device="cuda", n_workers=w)
        dense = Session(block_size=64, device="cuda", n_workers=w,
                        mode="dense")
        with monkeypatch.context() as m:
            if one_card:
                m.setattr(torch.cuda, "device_count", lambda: 1)
            for s in (sparse, dense):       # each mesh is built here, once
                assert s.mesh.devices == (tuple(cards[:1]) * w if one_card
                                          else tuple(cards[:w]))
        out = _mesh_queries(sparse, arrays)
        out["pipeline"] = _dense_pipeline(dense, x, y)
        return out
    mine = queries(False)
    theirs = queries(True)
    want = {qn: q.collect() for qn, q in theirs.items()}
    gated = {"Q3": "merge_join", "Q7": "masked_matmul", "Q8": "sddmm_agg",
             "Q9": "sddmm_agg", "Q10": "sddmm_agg"}

    log = []
    init = spmd.Sharded.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        log.append(self)
    monkeypatch.setattr(spmd.Sharded, "__init__", record)
    for qn, q in mine.items():
        q.physical_plan()                     # plan outside the count
        log.clear()
        launch_cards.clear()
        build.reset_launches()
        got = q.collect()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        assert log and all(sh.devices == q.session.mesh.devices
                           for sh in log), qn
        if qn in gated:
            assert launches == {gated[qn]: w}, (qn, launches)
            assert sorted(launch_cards) == [(d.index, d.index)
                                            for d in cards[:w]], qn
        elif qn == "Q5":
            assert set(launches) == {"coo_expand", "bloom_probe"}, launches
            assert set(launch_cards) == {(0, 0)}, launch_cards
        else:
            assert not launches, launches
        if qn == "Q5":
            ga, wa = (np.lexsort(r.idx.T[::-1]) for r in (got, want[qn]))
            assert np.array_equal(got.idx[ga], want[qn].idx[wa])
            assert np.array_equal(got.val[ga], want[qn].val[wa])
        elif qn == "Q3":
            assert torch.equal(got.value, want[qn].value)
        else:
            assert got.value.device == want[qn].value.device
            torch.testing.assert_close(got.value, want[qn].value,
                                       rtol=SUM_RTOL, atol=1e-5)
        counted = _counted(q)
        assert counted == _counted(theirs[qn]), qn
        if qn == "pipeline":
            assert counted == q.physical_plan().total_comm_est * ENTRY_BYTES


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


# ---------------------------------------------------------------------------
# LM training on the card (-k train_): a step against the CPU's, remat, the
# chunked loss, and a checkpoint written on the CPU restored onto the card.
# Tolerances as in tests/test_torch_train.py: f32 loss rel 1e-5, grad norm
# rel 1e-4, parameters atol 5e-3 at lr 1e-3 (AdamW's first step moves a
# parameter by ≈ lr·sign(g)), remat rel 1e-6.
# ---------------------------------------------------------------------------

def _train_setup(arch, **over):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api as tapi
    from repro_torch.models.module import init_params
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype=torch.float32, **over)
    params = init_params(tapi.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (4, 17))
    host = {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
    return cfg, params, host


def _train_rel(got, want) -> float:
    return abs(float(got) / float(want) - 1)


@pytest.mark.parametrize("arch,chunk", [
    ("qwen3-1.7b", 0), ("qwen3-1.7b", 8), ("granite-moe-1b-a400m", 0),
    ("whisper-small", 0), ("jamba-v0.1-52b", 0), ("phi-3-vision-4.2b", 0)])
def test_train_step_on_the_card_matches_cpu(cuda, arch, chunk):
    from repro_torch.launch.train import device_batch
    from repro_torch.models.module import tree_items, tree_map
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import init_state, make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, params, host = _train_setup(arch, remat="full", loss_chunk=chunk)
    card = tree_map(lambda t: t.to(cuda), params)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    s_cpu, m_cpu = step(init_state(params, opt),
                        device_batch(cfg, host, 1, torch.device("cpu")))
    s_card, m_card = step(init_state(card, opt),
                          device_batch(cfg, host, 1, cuda))
    assert s_card.params["embed"].device.type == "cuda"
    assert _train_rel(m_card["loss"], m_cpu["loss"]) < 1e-5, arch
    assert _train_rel(m_card["grad_norm"], m_cpu["grad_norm"]) < 1e-4, arch
    for (k, a), (_, b) in zip(tree_items(s_card.params),
                              tree_items(s_cpu.params)):
        assert float((a.cpu() - b).abs().max()) < 5e-3, (arch, k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "whisper-small", "rwkv6-7b"])
def test_train_remat_policies_agree_on_the_card(cuda, arch):
    import dataclasses

    from repro_torch.launch.train import device_batch
    from repro_torch.models.module import tree_items, tree_map
    from repro_torch.train.step import make_grad_fn
    cfg, params, host = _train_setup(arch)
    card = tree_map(lambda t: t.to(cuda), params)
    batch = device_batch(cfg, host, 1, cuda)
    grads = {p: make_grad_fn(dataclasses.replace(cfg, remat=p))(card, batch)[0]
             for p in ("none", "full", "dots")}
    for p in ("full", "dots"):
        for (k, a), (_, b) in zip(tree_items(grads[p]),
                                  tree_items(grads["none"])):
            assert _lm_rel(a, b) <= 1e-6, (arch, p, k)


def test_train_checkpoint_written_on_the_cpu_restores_onto_the_card(
        cuda, tmp_path):
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.launch.train import device_batch
    from repro_torch.models.module import tree_items, tree_map
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.train.step import TrainState, init_state, \
        make_train_step
    cfg, params, host = _train_setup("qwen3-1.7b")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    state, _ = step(init_state(params, opt),
                    device_batch(cfg, host, 1, torch.device("cpu")))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": state.params, "opt": state.opt._asdict()},
            blocking=True)
    like = {"params": state.params, "opt": state.opt._asdict()}
    tree, step_no = ck.restore(like, device=cuda)
    assert step_no == 1
    for (k, a), (_, b) in zip(tree_items(like), tree_items(tree)):
        assert b.device.type == "cuda" and b.dtype == a.dtype, k
        assert torch.equal(a, b.cpu()), k
    restored = TrainState(tree["params"], AdamWState(**tree["opt"]), None,
                          tree["opt"]["count"])
    moved = TrainState(tree_map(lambda t: t.to(cuda), state.params),
                       AdamWState(*(tree_map(lambda t: t.to(cuda), x)
                                    for x in state.opt)), None,
                       state.step.to(cuda))
    batch = device_batch(cfg, host, 2, cuda)
    a, ma = step(restored, batch)
    b, mb = step(moved, batch)
    # within rel 1e-6 rather than equal: the embedding's backward may
    # accumulate its rows in another order from run to run
    assert _train_rel(ma["loss"], mb["loss"]) <= 1e-6
    for (k, x), (_, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert _lm_rel(x, y) <= 1e-6, k


# ---------------------------------------------------------------------------
# The dry run's one-card estimate against the step on the card: dot flops
# within 1e-3 (the same formulas over the same aten ops) and the traced
# peak within 10% of max_memory_allocated (chip_smoke.py's limits).
# ---------------------------------------------------------------------------

def test_dryrun_trace_matches_the_train_step_on_the_card(cuda):
    import dataclasses
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.opstats import trace_step
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as tapi
    from repro_torch.models.module import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import init_state, make_train_step
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2)
    b, s = 2, 64
    opt = AdamW()
    pred = trace_step(cfg, ShapeConfig("t", s, b, "train"), opt=opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(tapi.spec(cfg),
                         torch.Generator(cuda).manual_seed(0), cuda)
    state = init_state(params, opt)
    g = torch.Generator(cuda).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                              device=cuda, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert abs(fc.get_total_flops() / pred.stats.dot_flops - 1) <= 1e-3
    assert abs(pred.stats.peak_bytes / peak - 1) <= 0.10, \
        (pred.stats.peak_bytes, peak)


# ---------------------------------------------------------------------------
# general merges: the generated instances of merge_join and coo_expand
# ---------------------------------------------------------------------------

def _merge_case(name):
    """(merge, exact, device of the plain version it is held to): a merge
    that divides by a constant is held to the plain version on the CPU,
    which divides as the kernels do (torch on the card multiplies by the
    reciprocal)."""
    from torch_merge_cases import CARD_RECIPROCAL, GENERAL
    fn, exact = GENERAL[name]
    return fn, exact, "cpu" if name in CARD_RECIPROCAL else "cuda"


def _general_names():
    from torch_merge_cases import GENERAL
    return sorted(GENERAL)


@pytest.fixture(scope="module")
def generated():
    """Every merge of the compiler's tests built into its own library,
    all nvcc runs together (one a core), before the tests launch them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    from repro_torch.kernels import merge_codes
    from torch_merge_cases import GENERAL
    build.merge_libraries(merge_codes.merge_code(fn)
                          for fn, _ in GENERAL.values())


@pytest.mark.parametrize("shape,bs", [((80, 72), 16), ((67, 70), 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _general_names())
def test_merge_join_program_matches_plain(cuda, generated, name, dtype,
                                          shape, bs):
    """Every merge of the compiler's tests through its generated instance
    (16-byte lanes and element by element), on random values and every
    pair of special values: bit for bit for the exact ops, within
    TRANSCENDENTAL_ULPS for the others."""
    from torch_merge_cases import check, operands
    fn, exact, plain_on = _merge_case(name)
    xs, ys = operands(21, {torch.float32: "float32",
                           torch.float64: "float64"}[dtype])
    a = torch.as_tensor(np.resize(xs, shape), device=cuda)
    b = torch.as_tensor(np.resize(ys, shape), device=cuda)
    rng = np.random.default_rng(5)
    ma, mb = _mask(rng, shape, bs, 0.6, cuda), _mask(rng, shape, bs, 0.6,
                                                     cuda)
    for mode in (MODE_ALL, MODE_BOTH):
        kw = dict(merge=fn, mode=mode, block_size=bs)
        before = dict(build.GENERATED_LAUNCHES)
        got = merge_join_cuda(a, b, ma, mb, **kw)
        torch.cuda.synchronize()
        assert build.GENERATED_LAUNCHES["merge_join"] == \
            before["merge_join"] + 1
        want = merge_join_plain(*(t.to(plain_on) for t in (a, b, ma, mb)),
                                **kw)
        check(got.cpu(), want.cpu(), exact, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["gated", "maximum", "exp_log1p", "pow",
                                  "every_register", "erf", "quotient"])
def test_merge_join_program_on_a_transposed_view_matches_plain(
        cuda, generated, name, dtype):
    """A handful of generated merges with B the view ``Bo.T``: the
    transposed path of the generated instance, the same bits (or ulps) as
    the plain version and as the contiguous B."""
    from torch_merge_cases import check, operands
    fn, exact, plain_on = _merge_case(name)
    shape, bs = (67, 70), 32
    xs, ys = operands(21, {torch.float32: "float32",
                           torch.float64: "float64"}[dtype])
    a = torch.as_tensor(np.resize(xs, shape), device=cuda)
    bo = torch.as_tensor(np.resize(ys, shape[::-1]), device=cuda)
    rng = np.random.default_rng(5)
    ma, mb = _mask(rng, shape, bs, 0.6, cuda), _mask(rng, shape, bs, 0.6,
                                                     cuda)
    for mode in (MODE_ALL, MODE_BOTH):
        kw = dict(merge=fn, mode=mode, block_size=bs)
        got = merge_join_cuda(a, bo.T, ma, mb, **kw)
        # the same bits as on a contiguous B (NaN against NaN)
        check(got.cpu(), merge_join_cuda(a, bo.T.contiguous(), ma, mb,
                                         **kw).cpu(), True, name)
        want = merge_join_plain(*(t.to(plain_on) for t in (a, bo.T, ma, mb)),
                                **kw)
        check(got.cpu(), want.cpu(), exact, name)


@pytest.mark.parametrize("vt", [4, 6, 8])
@pytest.mark.parametrize("dtype,cdt,ca,cb", [
    (torch.float32, torch.int16, 2, 1), (torch.float32, torch.int32, 2, 2),
    (torch.float64, torch.int16, 2, 2), (torch.float64, torch.int32, 1, 3)])
@pytest.mark.parametrize("name", ["gated", "maximum", "square", "quotient",
                                  "every_register", "logic", "exp_log1p",
                                  "pow", "clamp", "flipped_gated", "erf",
                                  "remainder", "int_arith", "long", "wide",
                                  "special_aliases", "round_decimals",
                                  "casts", "narrow_ints", "reduced", "like",
                                  "like_typed", "type_as", "activations",
                                  "activations_elu", "activations_exact",
                                  "activations_log", "logaddexp",
                                  "nan_to_num", "float_power", "deg_sinc",
                                  "nextafter_isclose", "shifts_gcd", "gamma",
                                  "gamma_aliases", "normal", "bessel",
                                  "xlogy", "logit"])
def test_coo_expand_program_matches_plain(cuda, generated, name, dtype, cdt,
                                          ca, cb, vt):
    """The generated run-time-width instance takes every width and every
    vt of the grid, in float32 and float64 (a tuned vt never refuses a
    general merge), with special values among the operands."""
    from torch_merge_cases import SPECIALS, check
    fn, exact, plain_on = _merge_case(name)
    rng = np.random.default_rng(8)
    ins, cap, _ = _expand_inputs(rng, 3000, 2000, cb, 0.5, dtype, cdt,
                                 cap_extra=37)
    ends, delta, av, ac, bv, bc = ins
    with np.errstate(over="ignore"):
        sp = torch.as_tensor(SPECIALS.astype(
            "float32" if dtype == torch.float32 else "float64"), dtype=dtype)
    av[::7] = sp[torch.arange(0, av.numel(), 7) % sp.numel()]
    bv[::5] = sp[torch.arange(0, bv.numel(), 5) % sp.numel()]
    ac = torch.as_tensor(rng.integers(0, 1000, (ac.shape[0], ca)), dtype=cdt)
    ins = [x.to(cuda) for x in (ends, delta, av, ac, bv, bc)]
    before = dict(build.GENERATED_LAUNCHES)
    idx_k, val_k = coo_expand_cuda(*ins, merge=fn, cap=cap,
                                   tiles={"vt": vt})
    torch.cuda.synchronize()
    assert build.GENERATED_LAUNCHES["coo_expand"] == \
        before["coo_expand"] + 1
    idx_p, val_p = coo_expand_plain(*(t.to(plain_on) for t in ins), merge=fn,
                                    cap=cap)
    assert torch.equal(idx_k.cpu(), idx_p.cpu())
    check(val_k.cpu(), val_p.to(dtype).cpu(), exact, name)


def _sparse_pair(seed, n, bs):
    rng = np.random.default_rng(seed)
    a = np.round(np.where(rng.uniform(size=(n, n)) < 0.02,
                          rng.normal(size=(n, n)) * 8, 0), 1)
    b = np.round(np.where(rng.uniform(size=(n, n)) < 0.02,
                          rng.normal(size=(n, n)) * 8, 0), 1)
    a[:bs] = 0.0
    return a.astype(np.float32), b.astype(np.float32)


def test_general_merges_through_the_session_on_the_card(cuda):
    """The gated merge in an overlay and a D2D join through
    ``Session(device="cuda")``: the generated instances launch, and the
    results equal the same queries on the CPU."""
    from repro_torch.core import Session
    from repro_torch.core.expr import MergeFn
    n, bs = 512, 64
    a, b = _sparse_pair(9, n, bs)
    gated = MergeFn("gated_card", lambda x, y: torch.where(
        x > 0, torch.where(x < 10, x + y, 0.0), 0.0))
    out = {}
    for dev in ("cpu", "cuda"):
        s = Session(block_size=bs, device=dev, n_workers=1)
        A, B = s.load(a, "A"), s.load(b, "B")
        build.reset_launches()
        out[dev] = (A.join(B, "RID=RID AND CID=CID", gated).collect(),
                    A.join(B, "RID=RID", gated).collect())
    assert build.GENERATED_LAUNCHES == {"merge_join": 1, "coo_expand": 1}
    (oc, dc), (og, dg) = out["cpu"], out["cuda"]
    assert torch.equal(og.value.cpu(), oc.value)
    assert np.array_equal(dg.idx, dc.idx)
    np.testing.assert_array_equal(dg.val, dc.val)


def test_erf_join_through_the_session_equals_the_cpu(cuda):
    """``A.join(B, "RID=RID AND CID=CID", lambda x, y: torch.erf(x) * y)``
    on the card, which the register programs refused: the generated
    ``merge_join`` instance launches, and the result equals the CPU's
    within TRANSCENDENTAL_ULPS (torch's erf on the CPU is SLEEF's)."""
    from repro_torch.core import Session
    from torch_merge_cases import check
    n, bs = 512, 64
    a, b = _sparse_pair(10, n, bs)
    out = {}
    for dev in ("cpu", "cuda"):
        s = Session(block_size=bs, device=dev, n_workers=1)
        A, B = s.load(a, "A"), s.load(b, "B")
        build.reset_launches()
        out[dev] = A.join(B, "RID=RID AND CID=CID",
                          lambda x, y: torch.erf(x) * y).collect()
    assert build.GENERATED_LAUNCHES["merge_join"] == 1
    check(out["cuda"].value.cpu(), out["cpu"].value, False, "erf join")


def test_bfloat16_overlay_through_the_session_skips_dead_tiles(
        cuda, monkeypatch):
    """``(x * y).to(torch.bfloat16)`` through ``Session(device="cuda")``:
    the sparsity probe reads the bfloat16 product through torch and finds
    it inducing on both sides, so the overlay runs its generated
    ``merge_join`` instance at mode 0 (both masks: dead tiles skipped), and
    the result equals the CPU's bit for bit."""
    from repro_torch.core import Session
    from repro_torch.core.expr import MergeFn
    from repro_torch.core.sparsity import analyze_merge
    from repro_torch.kernels import registry
    n, bs = 512, 64
    a, b = _sparse_pair(13, n, bs)
    merge = MergeFn("bf16_overlay_card",
                    lambda x, y: (x * y).to(torch.bfloat16))
    prof = analyze_merge(merge)
    assert prof.inducing_x and prof.inducing_y
    spec = registry.get("merge_join")
    modes = []

    def recording(*args, _impl=spec.impls[registry.CUDA], **kw):
        modes.append(kw["mode"])
        return _impl(*args, **kw)

    monkeypatch.setitem(spec.impls, registry.CUDA, recording)
    out = {}
    for dev in ("cpu", "cuda"):
        s = Session(block_size=bs, device=dev, n_workers=1)
        A, B = s.load(a, "A"), s.load(b, "B")
        build.reset_launches()
        out[dev] = A.join(B, "RID=RID AND CID=CID", merge).collect()
    assert modes == [MODE_BOTH]
    assert build.GENERATED_LAUNCHES["merge_join"] == 1
    assert torch.equal(out["cuda"].value.cpu(), out["cpu"].value)
    assert not bool(out["cpu"].value[:bs].any())        # A's dead band


def test_a_merge_that_does_not_compile_launches_nothing(cuda, monkeypatch):
    """A generated unit that nvcc rejects raises ``RuntimeError`` with
    nvcc's log, from both kernels' wrappers, and nothing launches."""
    from repro_torch.kernels import coo_join, merge_codes
    from repro_torch.kernels import merge_join as mj
    bad = merge_codes.MergeCode(merge_codes.GENERATED,
                                source="this is not C++;\n")
    for mod in (mj, coo_join):
        monkeypatch.setattr(mod, "merge_code", lambda merge: bad)
    rng = np.random.default_rng(12)
    a = torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32,
                        device=cuda)
    mask = torch.ones((4, 4), dtype=torch.bool, device=cuda)
    ins, cap, _ = _expand_inputs(rng, 300, 200, 1, 0.5, torch.float32,
                                 torch.int16)
    ins = [x.to(cuda) for x in ins]
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        merge_join_cuda(a, a, mask, mask, merge=MERGES["mul"],
                        block_size=16)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        coo_expand_cuda(*ins, merge=MERGES["mul"], cap=cap)
    assert dict(build.LAUNCHES) == before
    assert bad.key not in build.BUILD_INFO.get("merges", {})


# ---------------------------------------------------------------------------
# LM serving sharded over four cards (one process a card, NCCL): the
# qwen3-1.7b gates of chip_smoke.py's lm mesh phase, f32 compute.
# ---------------------------------------------------------------------------

LM_MESH_CARD_RUNS = (((2, 2), 4), ((4, 1), 1))
LM_MESH_CARD_SERVE = (4, 128, 32)      # batch, prompt, new tokens
LM_MESH_CARD_RTOL = 1e-4               # of the largest |logit|


def _four_card_ranks(target, d, args, timeout, what, extra=()):
    """``target(rank, 4, store, *args, out, *extra)`` in four processes,
    one a card (skips below four cards, decided here): rank 0's
    result."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA devices ({what} across cards)")
    import os
    import pickle
    import time
    import torch.multiprocessing as mp
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=target,
                           args=(r, 4, str(d / "store")) + tuple(args)
                           + (str(d),) + tuple(extra))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung and [p.exitcode for p in procs] == [0] * 4
    with open(os.path.join(d, "result.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def lm_mesh_card_runs(tmp_path_factory):
    """Four ranks, one a card; skips below four cards."""
    import torch_lm_mesh_worker as worker
    return _four_card_ranks(
        worker.card_main, tmp_path_factory.mktemp("lm_mesh_cards"),
        (LM_MESH_CARD_RUNS, LM_MESH_CARD_SERVE), 900, "LM serving")


@pytest.mark.parametrize("shape,batch", LM_MESH_CARD_RUNS,
                         ids=["2x2_batch4", "4x1_batch1"])
def test_lm_mesh_qwen3_on_four_cards_matches_one_card(lm_mesh_card_runs,
                                                      shape, batch):
    """Greedy tokens equal the unsharded run's; prefill's logits, and each
    decode's against the forward pass, within ``LM_MESH_CARD_RTOL``; each
    card's parameter and cache bytes equal to the dry run's."""
    r = lm_mesh_card_runs[shape, batch]
    assert r["tokens_equal"]
    assert r["prefill_rel"] < LM_MESH_CARD_RTOL
    assert r["decode_rel"] < LM_MESH_CARD_RTOL
    assert r["bytes"] == [r["predicted"]] * 4


# ---------------------------------------------------------------------------
# LM training sharded over four cards (one process a card, NCCL): the
# train step at test widths against the unsharded port on card 0.
# ---------------------------------------------------------------------------

TRAIN_MESH_CARD_SHAPES = ((2, 2), (4, 1))
TRAIN_MESH_CARD_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128)
TRAIN_MESH_CARD_DATA = (4, 8)           # batch, seq
TRAIN_MESH_CARD_RTOL = 1e-4             # loss, grad norm, gradients (of
TRAIN_MESH_CARD_ATOL = 5e-3             # the leaf's largest |g|); params


@pytest.fixture(scope="module")
def train_mesh_card_runs(tmp_path_factory):
    """Four ranks, one a card; skips below four cards."""
    import torch_train_mesh_worker as worker
    return _four_card_ranks(
        worker.card_main, tmp_path_factory.mktemp("train_mesh_cards"),
        (TRAIN_MESH_CARD_SHAPES, TRAIN_MESH_CARD_OVER, TRAIN_MESH_CARD_DATA),
        600, "LM training")


@pytest.mark.parametrize("shape", TRAIN_MESH_CARD_SHAPES,
                         ids=["2x2", "4x1"])
def test_train_mesh_on_four_cards_matches_one_card(train_mesh_card_runs,
                                                   shape):
    """Step 1's loss and grad norm, every gradient, and the parameters
    after three AdamW steps against the unsharded port on card 0; each
    gradient in its parameter's placements; each card's train-state bytes
    equal to the dry run's."""
    import torch_train_mesh_worker as worker
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import default_rules
    from repro_torch.sharding.partition import Mesh
    r = train_mesh_card_runs[shape]
    assert r["loss_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["gnorm_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["grad_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["param_abs"] < TRAIN_MESH_CARD_ATOL
    assert r["placed"]
    cfg = worker.port_cfg("qwen3-1.7b", TRAIN_MESH_CARD_OVER)
    mesh = Mesh(shape, worker.AXES)
    cell = ShapeConfig("train_mesh", TRAIN_MESH_CARD_DATA[1],
                       TRAIN_MESH_CARD_DATA[0], "train")
    want = (dryrun.argument_bytes(cfg, cell, mesh, default_rules(mesh))
            - dryrun.input_bytes(cfg, cell, mesh, default_rules(mesh)))
    assert r["bytes"] == [want] * 4


# ---------------------------------------------------------------------------
# The recurrent families sharded over four cards (one process a card,
# NCCL): rwkv6-7b's block at 4 WKV heads and jamba's 8-layer interleave,
# ``test_torch_ssm_mesh_serve.py``'s models, f32, against the unsharded
# port on card 0; the card's torch is another version than the CPU
# tests', so its DTensor rules run here too.
# ---------------------------------------------------------------------------

SSM_MESH_CARD_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128)
SSM_MESH_CARD_MODELS = {
    "rwkv": ("rwkv6-7b", dict(SSM_MESH_CARD_OVER,
                              ssm=(("rwkv_head_dim", 16),))),
    "jamba": ("jamba-v0.1-52b", dict(SSM_MESH_CARD_OVER, n_layers=8)),
}
SSM_MESH_CARD_RUNS = (((2, 2), 4), ((1, 4), 4), ((4, 1), 1))
SSM_MESH_CARD_SERVE = (4, 16, 8)        # batch, prompt, new tokens
SSM_MESH_CARD_SHAPES = ((2, 2), (1, 4))


@pytest.fixture(scope="module", params=sorted(SSM_MESH_CARD_MODELS))
def ssm_mesh_card_serving(request, tmp_path_factory):
    """The model's serving runs on four cards; skips below four cards."""
    import torch_lm_mesh_worker as worker
    return request.param, _four_card_ranks(
        worker.card_main,
        tmp_path_factory.mktemp(f"ssm_mesh_cards_{request.param}"),
        (SSM_MESH_CARD_RUNS, SSM_MESH_CARD_SERVE), 600, "recurrent serving",
        (SSM_MESH_CARD_MODELS[request.param],))


@pytest.mark.parametrize("shape,batch", SSM_MESH_CARD_RUNS,
                         ids=["2x2_batch4", "1x4_batch4", "4x1_batch1"])
def test_ssm_mesh_serving_on_four_cards_matches_one_card(
        ssm_mesh_card_serving, shape, batch):
    """Greedy tokens equal the unsharded run's; prefill's logits, and each
    decode's against the forward pass, within ``LM_MESH_CARD_RTOL``; each
    card's parameter and cache bytes equal to the dry run's."""
    _, runs = ssm_mesh_card_serving
    r = runs[shape, batch]
    assert r["tokens_equal"]
    assert r["prefill_rel"] < LM_MESH_CARD_RTOL
    assert r["decode_rel"] < LM_MESH_CARD_RTOL
    assert r["bytes"] == [r["predicted"]] * 4


@pytest.fixture(scope="module", params=sorted(SSM_MESH_CARD_MODELS))
def ssm_mesh_card_training(request, tmp_path_factory):
    """The model's train runs on four cards; skips below four cards."""
    import torch_train_mesh_worker as worker
    arch, over = SSM_MESH_CARD_MODELS[request.param]
    return (arch, over), _four_card_ranks(
        worker.card_main,
        tmp_path_factory.mktemp(f"ssm_train_cards_{request.param}"),
        (SSM_MESH_CARD_SHAPES, over, TRAIN_MESH_CARD_DATA), 600,
        "recurrent training", (arch,))


@pytest.mark.parametrize("shape", SSM_MESH_CARD_SHAPES, ids=["2x2", "1x4"])
def test_ssm_train_mesh_on_four_cards_matches_one_card(
        ssm_mesh_card_training, shape):
    """As ``test_train_mesh_on_four_cards_matches_one_card``, for rwkv's
    and jamba's blocks."""
    import torch_train_mesh_worker as worker
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import default_rules
    from repro_torch.sharding.partition import Mesh
    (arch, over), runs = ssm_mesh_card_training
    r = runs[shape]
    assert r["loss_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["gnorm_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["grad_rel"] < TRAIN_MESH_CARD_RTOL
    assert r["param_abs"] < TRAIN_MESH_CARD_ATOL
    assert r["placed"]
    cfg = worker.port_cfg(arch, over)
    mesh = Mesh(shape, worker.AXES)
    cell = ShapeConfig("train_mesh", TRAIN_MESH_CARD_DATA[1],
                       TRAIN_MESH_CARD_DATA[0], "train")
    want = (dryrun.argument_bytes(cfg, cell, mesh, default_rules(mesh))
            - dryrun.input_bytes(cfg, cell, mesh, default_rules(mesh)))
    assert r["bytes"] == [want] * 4
