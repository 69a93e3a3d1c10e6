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
import numpy as np
import pytest
import torch

from repro_torch.core import bloom as tbloom
from repro_torch.kernels import build
from repro_torch.kernels.bloom_probe import bloom_probe_cuda, bloom_probe_plain
from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
from repro_torch.kernels.masked_matmul import (
    masked_matmul_cuda, masked_matmul_plain,
)
from repro_torch.kernels.merge_join import (
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, merge_join_cuda, merge_join_plain,
)
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
PNMF_BS = [16, 64, 256]
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
