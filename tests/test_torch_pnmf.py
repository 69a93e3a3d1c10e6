"""The PNMF path on the CPU: the port's ``masked_matmul`` and ``sddmm_agg``
(their plain versions, which the CPU runs) against the JAX package's
``dense`` backend and its Pallas bodies in interpret mode (grids of at
most 4 × 4 tiles); Q7–Q10 of ``chip_smoke.py`` through both packages'
Sessions, on the staged, eager and tree-walk paths; and the PNMF
iteration of ``repro_torch.pnmf`` against ``benchmarks/bench_pnmf.py``.

Tolerances: ``masked_matmul`` f32 atol 1e-4 rtol 1e-2 and bf16 atol 5e-2
(``tests/test_kernels.py``); ``sddmm_agg`` f32 atol 5e-4 rtol 1e-4, f64
1e-9 (``tests/test_kernels_fused.py``); query results and PNMF updates
rtol 1e-4 (float32 sums in another order)."""
import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.core.matrix import compute_block_mask as j_block_mask
from repro.kernels import ops as jkops
from repro.kernels import registry as jreg
from repro_torch import pnmf
from repro_torch.core import Session
from repro_torch.core.matrix import compute_block_mask
from repro_torch.kernels import ops as kops
from repro_torch.kernels import registry
from repro_torch.kernels.sddmm_agg import sddmm_agg_plain
from repro_torch.plan import PlanExecutor
from repro_torch.plan import ops as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# masked_matmul
# ---------------------------------------------------------------------------

# the reference's shapes (tests/test_kernels.py) and two ragged ones
MM_SHAPES = [(32, 32, 32, 16), (64, 32, 48, 16), (37, 5, 50, 16),
             (70, 9, 33, 32)]
MM_DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
             "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


@pytest.mark.parametrize("m,k,n,bs", MM_SHAPES)
@pytest.mark.parametrize("dtype_s", sorted(MM_DTYPES))
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_masked_matmul_matches_reference(m, k, n, bs, dtype_s, density):
    tdt, jdt, atol = MM_DTYPES[dtype_s]
    rng = np.random.default_rng(0)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    mask = rng.uniform(size=(-(-m // bs), -(-n // bs))) < density
    got = kops.masked_matmul(torch.as_tensor(a).to(tdt),
                             torch.as_tensor(b).to(tdt),
                             torch.as_tensor(mask), block_size=bs)
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.float().numpy()
    for force in ("ref", "pallas"):   # dense oracle, interpret-mode body
        want = jkops.masked_matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                                   jnp.asarray(mask), block_size=bs,
                                   force=force)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=atol, rtol=1e-2)
    dead = ~np.repeat(np.repeat(mask, bs, 0), bs, 1)[:m, :n]
    assert not got[dead].any()


# ---------------------------------------------------------------------------
# sddmm_agg
# ---------------------------------------------------------------------------

def _sddmm_case(rng, density, dtype_s, m=33, k=7, n=41, bs=16):
    """``tests/test_kernels_fused.py``'s case, as numpy."""
    sp = np.where(rng.uniform(size=(m, n)) < density,
                  rng.normal(size=(m, n)), 0.0).astype(dtype_s)
    w = rng.normal(size=(m, k)).astype(dtype_s)
    h = rng.normal(size=(k, n)).astype(dtype_s)
    return sp, w, h, bs


def _agg_tol(dtype_s):
    return dict(atol=5e-4, rtol=1e-4) if dtype_s == "float32" \
        else dict(atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.2, 1.0])
@pytest.mark.parametrize("dtype_s", ["float32", "float64"])
@pytest.mark.parametrize("dim", ["row", "col", "all"])
def test_sddmm_agg_matches_reference(density, dtype_s, dim):
    rng = np.random.default_rng(2)
    sp, w, h, bs = _sddmm_case(rng, density, dtype_s)
    tsp = torch.as_tensor(sp)
    got = kops.sddmm_agg(tsp, torch.as_tensor(w), torch.as_tensor(h),
                         compute_block_mask(tsp, bs), dim=dim, block_size=bs)
    assert str(got.dtype) == f"torch.{dtype_s}"
    axis = {"row": 1, "col": 0, "all": None}[dim]
    oracle = np.sum(sp.astype(np.float64) * (w.astype(np.float64) @ h),
                    axis=axis, keepdims=axis is not None)
    oracle = oracle.reshape({"row": (33, 1), "col": (1, 41),
                             "all": (1, 1)}[dim])
    assert got.shape == oracle.shape
    np.testing.assert_allclose(got.double().numpy(), oracle,
                               **_agg_tol(dtype_s))
    with _maybe_x64(dtype_s):
        jsp = jnp.asarray(sp)
        mask = j_block_mask(jsp, bs)
        for backend in (jreg.DENSE, jreg.INTERPRET):
            want = jreg.dispatch("sddmm_agg", jsp, jnp.asarray(w),
                                 jnp.asarray(h), mask, backend=backend,
                                 dim=dim, block_size=bs)
            np.testing.assert_allclose(got.double().numpy(),
                                       np.asarray(want, np.float64),
                                       **_agg_tol(dtype_s))


def test_sddmm_agg_dead_blocks_do_not_leak():
    """``tests/test_kernels_fused.py``'s block-structured case: rows of sp
    that live only in dead blocks sum to exactly zero, in both packages."""
    rng = np.random.default_rng(3)
    m, k, n, bs = 32, 5, 32, 8
    sp = np.zeros((m, n), np.float32)
    sp[:8, :16] = rng.normal(size=(8, 16))   # two live blocks, fourteen dead
    w = rng.normal(size=(m, k)).astype(np.float32)
    h = rng.normal(size=(k, n)).astype(np.float32)
    tsp = torch.as_tensor(sp)
    mask = compute_block_mask(tsp, bs)
    assert int(mask.sum()) == 2
    got = kops.sddmm_agg(tsp, torch.as_tensor(w), torch.as_tensor(h), mask,
                         dim="row", block_size=bs).numpy()
    want = jreg.dispatch("sddmm_agg", jnp.asarray(sp), jnp.asarray(w),
                         jnp.asarray(h), j_block_mask(jnp.asarray(sp), bs),
                         backend=jreg.INTERPRET, dim="row", block_size=bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert not got[8:].any()


def test_sddmm_agg_rejects_an_unknown_dim():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="dim"):
        sddmm_agg_plain(x, x, x, torch.ones(1, 1, dtype=torch.bool),
                        dim="diag", block_size=4)


# ---------------------------------------------------------------------------
# Q7–Q10 through both packages' Sessions
# ---------------------------------------------------------------------------

QUERIES = {
    "Q7": (lambda m: m["Ap"].ediv(m["W"].multiply(m["H"]))
           .multiply(m["H"].t()), P.MASKED_ELEMWISE, "masked_matmul"),
    "Q8": (lambda m: m["Ap"].emul(m["W"].multiply(m["H"])).sum("r"),
           P.MASKED_AGG, "sddmm_agg"),
    "Q9": (lambda m: m["Ap"].emul(m["W"].multiply(m["H"])).sum("c"),
           P.MASKED_AGG, "sddmm_agg"),
    "Q10": (lambda m: m["Ap"].emul(m["W"].multiply(m["H"])).sum("a"),
            P.MASKED_AGG, "sddmm_agg"),
}


def _pnmf_data(n=1024, bs=64, k=8, empty=0.7, seed=4):
    rng = np.random.default_rng(seed)
    g = n // bs
    ap = np.where(rng.uniform(size=(n, n)) < 0.05,
                  np.abs(rng.normal(size=(n, n))), 0).astype(np.float32)
    for blk in rng.permutation(g * g)[: int(empty * g * g)]:
        ap[(blk // g) * bs:(blk // g + 1) * bs,
           (blk % g) * bs:(blk % g + 1) * bs] = 0
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    h = np.abs(rng.normal(size=(k, n))).astype(np.float32)
    return {"Ap": ap, "W": w, "H": h}, bs


@pytest.fixture(scope="module")
def pnmf_sessions():
    data, bs = _pnmf_data()
    js, ts = JSession(block_size=bs), Session(block_size=bs, device="cpu")
    return ({k: js.load(v, k) for k, v in data.items()},
            {k: ts.load(v, k) for k, v in data.items()}, ts, data)


@pytest.fixture
def dispatches(monkeypatch):
    """Counts of the registry's ``torch`` entries of the two kernels."""
    counts = {"masked_matmul": 0, "sddmm_agg": 0}
    for name in counts:
        spec = registry.get(name)
        inner = spec.impls[registry.TORCH]

        def counted(*a, _inner=inner, _name=name, **kw):
            counts[_name] += 1
            return _inner(*a, **kw)
        monkeypatch.setitem(spec.impls, registry.TORCH, counted)
    return counts


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pnmf_queries_plan_like_the_reference(pnmf_sessions, name):
    from repro.plan import masks as jmasks
    from repro_torch.plan import masks as tmasks
    jm, tm, _, _ = pnmf_sessions
    build, kind, kernel = QUERIES[name]
    jq, tq = build(jm), build(tm)
    jp, tp = jq.physical_plan(), tq.physical_plan()
    jmasks.annotate(jp, jq.session.env)
    tmasks.annotate(tp, tq.session.env)
    assert [(n.kind, n.kernel) for n in tp.nodes] == \
        [(n.kind, n.kernel) for n in jp.nodes]
    masked = [n for n in tp.nodes if n.kind == kind]
    assert len(masked) == 1 and masked[0].kernel == kernel
    assert tp.jit_safe and jp.jit_safe
    for tn, jn in zip(tp.nodes, jp.nodes):
        assert tn.meta.get("demote_dense") == jn.meta.get("demote_dense")
    assert masked[0].meta["demote_dense"] is False


def _run(path, query, session):
    if path == "staged":
        return query.collect()
    if path == "tree":
        return query.collect(engine="tree")
    return PlanExecutor(session.env, device=session.device)._run_eager(
        query.physical_plan())


# dispatches per path: the tree walk sees the logical Agg∘ElemWise, so
# Q8–Q10 run masked_matmul and then the aggregate there
EXPECTED = {
    ("staged", "Q7"): (1, 0), ("eager", "Q7"): (1, 0), ("tree", "Q7"): (1, 0),
    **{(p, q): (0, 1) for p in ("staged", "eager") for q in ("Q8", "Q9",
                                                               "Q10")},
    **{("tree", q): (1, 0) for q in ("Q8", "Q9", "Q10")},
}


@pytest.mark.parametrize("path", ["staged", "eager", "tree"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pnmf_queries_match_the_reference(pnmf_sessions, dispatches, path,
                                          name):
    jm, tm, ts, data = pnmf_sessions
    build = QUERIES[name][0]
    got = _run(path, build(tm), ts).value.numpy()
    assert (dispatches["masked_matmul"], dispatches["sddmm_agg"]) == \
        EXPECTED[(path, name)]
    want = np.asarray(build(jm).collect().value)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and float64 numpy over the data
    a, w, h = (data[k].astype(np.float64) for k in ("Ap", "W", "H"))
    wh = w @ h
    oracle = {"Q7": np.where(a != 0, a / wh, 0.0) @ h.T,
              "Q8": (a * wh).sum(1, keepdims=True),
              "Q9": (a * wh).sum(0, keepdims=True),
              "Q10": (a * wh).sum().reshape(1, 1)}[name]
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the PNMF iteration (benchmarks/bench_pnmf.py, examples/pnmf.py)
# ---------------------------------------------------------------------------

def _bench_pnmf():
    sys.path.insert(0, ROOT)
    from benchmarks import bench_pnmf
    return bench_pnmf


def _pnmf_inputs(n=512, k=8, seed=5):
    rng = np.random.default_rng(seed)
    a = np.abs(np.where(rng.uniform(size=(n, n)) < 5e-3,
                        rng.normal(size=(n, n)), 0)).astype(np.float32)
    a[:256, 256:] = 0                          # one of four blocks dead
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    h = np.abs(rng.normal(size=(k, n))).astype(np.float32)
    return a, w, h


def test_pnmf_constants_and_mask_match_the_reference():
    bench = _bench_pnmf()
    assert (pnmf.K, pnmf.BS) == (bench.K, bench.BS)
    a, w, h = _pnmf_inputs()
    *_, mask = pnmf.from_numpy(a, w, h, "cpu")
    want = np.asarray(j_block_mask(jnp.asarray(a), bench.BS))
    assert np.array_equal(mask.numpy(), want)
    assert not want.all()


def test_pnmf_opt_step_and_objective_match_the_reference():
    bench = _bench_pnmf()
    a, w, h = _pnmf_inputs()
    ta, tw, th, tmask = pnmf.from_numpy(a, w, h, "cpu")
    ja, jmask = jnp.asarray(a), j_block_mask(jnp.asarray(a), bench.BS)
    w2, h2 = pnmf.pnmf_opt_step(ta, tmask, tw, th)
    jw2, jh2 = bench.pnmf_opt_step(ja, jmask, jnp.asarray(w), jnp.asarray(h))
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=1e-4,
                               atol=1e-6)
    got = float(pnmf.objective(ta, tmask, w2, h2))
    want = float(bench.objective(ja, jmask, jw2, jh2))
    assert got == pytest.approx(want, rel=1e-4)


def test_pnmf_sparse_step_equals_the_dense_step():
    """``tests/test_system.py``'s PNMF check, on the port."""
    a, w, h = _pnmf_inputs()
    ta, tw, th, mask = pnmf.from_numpy(a, w, h, "cpu")
    e = torch.ones(ta.shape, dtype=torch.float32)
    w1, h1 = pnmf.pnmf_opt_step(ta, mask, tw, th)
    w2, h2 = pnmf.pnmf_naive_step(ta, tw, th, e)
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-3, atol=1e-4)


def test_pnmf_objective_decreases():
    a, w, h = _pnmf_inputs()
    ta, tw, th, mask = pnmf.from_numpy(a, w, h, "cpu")
    objs = [float(pnmf.objective(ta, mask, tw, th))]
    for _ in range(5):
        tw, th = pnmf.pnmf_opt_step(ta, mask, tw, th)
        objs.append(float(pnmf.objective(ta, mask, tw, th)))
    assert all(b < a_ for a_, b in zip(objs, objs[1:])), objs


def test_pnmf_main_prints_the_example_objectives(capsys):
    """``python -m repro_torch.pnmf --device cpu`` prints what
    ``examples/pnmf.py`` prints (same seed, same data)."""
    pnmf.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "A: (1500, 1500), nnz=2260, nonzero blocks 36/36" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("[iter")]
    assert [ln.split("]")[0] for ln in lines] == [
        "[iter  0", "[iter  3", "[iter  6", "[iter  9", "[iter 12"]
    objs = [float(ln.split("=")[1].replace(",", "")) for ln in lines]
    assert objs[0] == pytest.approx(45_816_856.0, rel=1e-4)
    assert objs[-1] == pytest.approx(7_092.9, rel=1e-4)


def test_pnmf_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pnmf.main([])
