"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided inside the fixture, so every pytest
worker collects the same tests). Tolerances: integers, coordinates and
bitsets exact; f32 values atol/rtol 1e-5, f64 1e-10 (the JAX package's
kernel tolerances).

    python -m pytest -q -m gpu tests/test_torch_gpu.py      # on the card
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bloom as tbloom
from repro_torch.kernels import build
from repro_torch.kernels.bloom_probe import bloom_probe_cuda, bloom_probe_plain
from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
from repro_torch.kernels.merge_join import (
    MODE_ALL, MODE_BOTH, MODE_X, MODE_Y, merge_join_cuda, merge_join_plain,
)

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
    assert launches == {"merge_join": 1, "coo_expand": 2, "bloom_probe": 1}
    (oc, dc, vc), (og, dg, vg) = results["cpu"], results["cuda"]
    torch.testing.assert_close(og.value.cpu(), oc.value, atol=1e-5,
                               rtol=1e-5)
    for host, card in ((dc, dg), (vc, vg)):
        assert np.array_equal(card.idx, host.idx)
        np.testing.assert_allclose(card.val, host.val, atol=1e-5, rtol=1e-5)
