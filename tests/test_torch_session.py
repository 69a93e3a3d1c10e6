"""End to end on the CPU: the quickstart's queries through the port's
``Session(device="cpu")`` and ``collect()`` against the JAX package's
``Session``, the tree-walk oracle against the DAG engine, and a
block-sparse overlay that takes the ``merge_join`` route.

Tolerances: counts and coordinates exact; f32 values atol/rtol 1e-5;
reductions rtol 1e-4 (float32 sums in another order)."""
import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.core import sparsity as j_sparsity
from repro_torch.core import Session, catalog_from_numpy
from repro_torch.core import sparsity as t_sparsity
from repro_torch.core.sparsity import product_merge
from repro_torch.kernels import registry


@pytest.fixture
def fresh_merge_profiles():
    """The merge-profile caches key on the merge NAME (every lambda given
    to ``join`` is named "f"), so the quickstart's results depend on which
    "f" was analysed first. Start both packages from an empty cache, as a
    fresh quickstart process does, and restore them afterwards."""
    saved = dict(j_sparsity._CACHE), dict(t_sparsity._CACHE)
    j_sparsity._CACHE.clear()
    t_sparsity._CACHE.clear()
    yield
    for cache, old in zip((j_sparsity._CACHE, t_sparsity._CACHE), saved):
        cache.clear()
        cache.update(old)


def _quickstart(session, to_np):
    """``examples/quickstart.py``'s queries, in its order, on ``session``."""
    rng = np.random.default_rng(0)
    out = {}
    x = np.where(rng.uniform(size=(2000, 1000)) < 1e-3,
                 rng.normal(size=(2000, 1000)), 0).astype(np.float32)
    X = session.load(x, "X")
    out["trace"] = float(X.t().multiply(X).trace().to_numpy().ravel()[0])
    out["g11"] = float(X.t().multiply(X).select("RID=1 AND CID=1")
                       .to_numpy().ravel()[0])
    a = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    b = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    A, B = session.load(a, "A"), session.load(b, "B")
    overlay = A.join(B, "RID=RID AND CID=CID", lambda x_, y_: x_ * y_)
    out["overlay"] = to_np(overlay.collect().value)
    out["d2d"] = A.join(B, "RID=RID", lambda x_, y_: x_ * y_).collect()
    out["v2v"] = A.join(B, "VAL=VAL", lambda x_, y_: x_ + y_).collect()
    dirty = a.copy()
    dirty[::7] = 0.0
    D = session.load(dirty, "D")
    out["rows"] = D.select("rows != NULL").to_numpy()
    return out


def test_quickstart_matches_reference(fresh_merge_profiles):
    want = _quickstart(JSession(), np.asarray)
    got = _quickstart(Session(device="cpu"), lambda t: t.numpy())
    # the values the quickstart prints
    assert got["trace"] == pytest.approx(2065.5595703125, rel=1e-4)
    assert got["g11"] == pytest.approx(2.831875801086426, rel=1e-4)
    assert int(np.count_nonzero(got["overlay"])) == 6
    assert got["d2d"].order == 3 and got["d2d"].nnz == 3468
    assert got["v2v"].order == 4 and got["v2v"].nnz == 0
    assert got["rows"].shape == (407, 512)
    # ... and the reference's results
    assert got["trace"] == pytest.approx(want["trace"], rel=1e-4)
    assert got["g11"] == pytest.approx(want["g11"], rel=1e-4)
    np.testing.assert_allclose(got["overlay"], want["overlay"], atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(got["d2d"].idx, want["d2d"].idx)
    np.testing.assert_allclose(got["d2d"].val, want["d2d"].val, atol=1e-5,
                               rtol=1e-5)
    assert got["v2v"].nnz == want["v2v"].nnz
    np.testing.assert_array_equal(got["rows"], want["rows"])


def _blocky(rng, n, bs, empty):
    v = np.round(rng.normal(size=(n, n)), 1).astype(np.float32)
    g = n // bs
    for k in empty:
        v[(k // g) * bs:(k // g + 1) * bs, (k % g) * bs:(k % g + 1) * bs] = 0
    return v


def test_block_sparse_overlay_takes_the_merge_join_route(rng, monkeypatch):
    """Live block share 11/16 ∈ (0.5, 1): the staged overlay dispatches
    ``merge_join`` (counted here on its CPU entry; on the card it is the
    kernel's launch count, ``test_torch_gpu.py``)."""
    a = _blocky(rng, 128, 32, (0, 5, 10, 15))
    b = _blocky(rng, 128, 32, (3,))
    calls = []
    spec = registry.get("merge_join")
    inner = spec.impls[registry.TORCH]
    monkeypatch.setitem(spec.impls, registry.TORCH,
                        lambda *a_, **k: calls.append(1) or inner(*a_, **k))
    s = Session(block_size=32, device="cpu")
    A, B = s.load(a, "A"), s.load(b, "B")
    q = A.join(B, "RID=RID AND CID=CID", product_merge())
    got = q.collect()
    assert calls == [1]
    live = q.physical_plan().node(q.physical_plan().root).meta["mask"]
    assert live.mean() == 11 / 16
    js = JSession(block_size=32)
    from repro.core.sparsity import product_merge as j_mul
    want = js.load(a, "A").join(js.load(b, "B"), "RID=RID AND CID=CID",
                                j_mul()).collect()
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               atol=1e-5, rtol=1e-5)
    assert np.array_equal(got.block_mask.numpy(), np.asarray(want.block_mask))


@pytest.mark.parametrize("pred", ["RID=RID AND CID=CID", "RID=RID", "CID=CID",
                                  "VAL=VAL", "CROSS"])
def test_dag_engine_matches_tree_oracle(rng, pred):
    a = np.round(np.where(rng.uniform(size=(24, 20)) < 0.2,
                          rng.normal(size=(24, 20)), 0), 1).astype(np.float32)
    b = np.round(np.where(rng.uniform(size=(24, 20)) < 0.2,
                          rng.normal(size=(24, 20)), 0), 1).astype(np.float32)
    s = Session(block_size=8, device="cpu")
    q = s.load(a, "A").join(s.load(b, "B"), pred, product_merge())
    dag, tree = q.collect(), q.collect(engine="tree")
    if pred == "RID=RID AND CID=CID":
        torch.testing.assert_close(dag.value, tree.value)
    else:
        np.testing.assert_allclose(dag.to_dense(), tree.to_dense(),
                                   atol=1e-5)


def test_reference_catalog_runs_in_the_port(rng):
    """A reference session's catalog, handed over as numpy, gives the same
    answers in the port."""
    js = JSession()
    x = np.round(np.where(rng.uniform(size=(300, 200)) < 0.05,
                          rng.normal(size=(300, 200)), 0), 2)
    js.load(x, "X")
    cat = catalog_from_numpy({k: np.asarray(bm.value)
                              for k, bm in js.env.items()}, device="cpu")
    assert cat["X"].value.dtype == torch.float32
    s = Session(device="cpu")
    m = s.load_catalog({k: np.asarray(bm.value) for k, bm in js.env.items()})
    from repro.core.api import Matrix as JMatrix
    from repro.core.expr import Leaf
    jx = JMatrix(js, Leaf("X", (300, 200), float(np.mean(x != 0))))
    want = float(np.asarray(jx.t().multiply(jx).trace().collect().value)[0, 0])
    got = float(m["X"].t().multiply(m["X"]).trace().collect().value[0, 0])
    assert got == pytest.approx(want, rel=1e-4)


# the V2V NaN fault's operands (the DAG engine's device tier once paired a
# 1 with the NaN and dropped the NaN pair), and operands holding ±0.0, NaN
# of both signs and ±inf among rounded normals
_NAN_A = np.array([[np.nan, 1, 0], [2, 0, 3]], np.float32)
_NAN_B = np.array([[1, 1, 0], [2, 0, np.nan]], np.float32)
_SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0],
                     np.float32)


def _special_operand(rng, m, n):
    v = np.round(np.where(rng.uniform(size=(m, n)) < 0.3,
                          rng.normal(size=(m, n)), 0), 1).astype(np.float32)
    pick = rng.uniform(size=(m, n)) < 0.3
    v[pick] = rng.choice(_SPECIALS, int(pick.sum()))
    return v


@pytest.mark.parametrize("bs", [4, 256])
@pytest.mark.parametrize("merge", ["mul", "add"])
@pytest.mark.parametrize("operands", ["fault", "specials"])
def test_v2v_join_with_nan_matches_reference(rng, operands, merge, bs):
    """``VAL=VAL`` on the DAG engine (the staged device tier) against the
    reference's ``Session``: the same entries in the same order."""
    from repro.core.sparsity import product_merge as j_mul
    from repro.core.sparsity import sum_merge as j_add
    from repro_torch.core.sparsity import sum_merge
    if operands == "fault":
        a, b = _NAN_A, _NAN_B
    else:
        a, b = _special_operand(rng, 10, 9), _special_operand(rng, 8, 11)
    tm, jm = {"mul": (product_merge(), j_mul()),
              "add": (sum_merge(), j_add())}[merge]
    s, js = Session(block_size=bs, device="cpu"), JSession(block_size=bs)
    got = s.load(a, "A").join(s.load(b, "B"), "VAL=VAL", tm).collect()
    want = js.load(a, "A").join(js.load(b, "B"), "VAL=VAL", jm).collect()
    assert got.nnz == want.nnz
    assert np.array_equal(got.idx, want.idx)
    np.testing.assert_allclose(got.val, want.val, atol=1e-5, rtol=1e-5)
    if operands == "fault":
        assert got.idx.tolist() == [[0, 0, 1, 2], [0, 1, 0, 0], [0, 1, 0, 1],
                                    [1, 0, 1, 0]]


def test_quickstart_module_prints_what_the_reference_example_prints(
        fresh_merge_profiles, capsys, monkeypatch):
    """``python -m repro_torch.quickstart --device cpu`` against
    ``examples/quickstart.py``: every line equal, the two printed values
    (trace, G[1,1]) within rtol 1e-4."""
    import runpy
    from pathlib import Path
    from repro_torch import quickstart
    root = Path(__file__).resolve().parents[1]
    runpy.run_path(str(root / "examples" / "quickstart.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    j_sparsity._CACHE.clear()
    t_sparsity._CACHE.clear()
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    values = {}
    for g, w in zip(got, want):
        if g.startswith(("trace =", "G[1,1] =")):
            key, gv = g.split(" = ")
            values[key] = float(gv)
            assert float(gv) == pytest.approx(float(w.split(" = ")[1]),
                                              rel=1e-4)
        else:
            assert g == w
    assert values["trace"] == pytest.approx(2065.5595703125, rel=1e-4)
    assert values["G[1,1]"] == pytest.approx(2.831875801086426, rel=1e-4)
    assert "direct overlay nnz: 6" in got
    assert "D2D join → order-3 tensor, 3468 matches" in got
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
