"""Multi-worker sessions: the port's SPMD executor against the JAX package.

The JAX package's side runs in one subprocess with eight forced host
devices (as ``tests/test_distributed.py`` runs ``tests/spmd_check.py``):
it prints, as JSON, its single-device tree oracle's values, its
physical plans, its predicted collective bytes (``total_comm_est`` ×
4) and its HLO-measured ones (``staged_collective_bytes``) for the
fixed D2D case, four seeds of random dense queries, the pipeline of
``benchmarks/bench_dist_comm.py`` and two sparse plans. The port runs
the same queries on ``Session(n_workers=8, device="cpu")``:

* values: the reference's oracle at atol/rtol 1e-3, and the port's
  single-worker result exactly (rtol 1e-4 where a sum is in the plan);
* bytes: the port's counted bytes equal its prediction on every dense
  plan, its prediction equals the reference's, and it equals the
  reference's measured bytes wherever the reference's measurement
  agrees with its own prediction (where it does not, the plan is listed
  in ROADMAP §3 and not held here).

    python tests/test_torch_distributed.py --reference   # the JSON side
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
DIMS = (24, 16)
SEEDS = range(4)


def _rand(rng, density):
    v = rng.normal(size=DIMS).astype(np.float32)
    keep = rng.uniform(size=DIMS) < density
    return np.where(keep, v, 0).astype(np.float32)


def build_query(s, rng, pkg):
    """``tests/spmd_check.py``'s random pipeline, in either package
    (``pkg`` is ``repro`` or ``repro_torch``): same draws, same query."""
    api = __import__(f"{pkg}.core.api", fromlist=["Matrix"])
    expr = __import__(f"{pkg}.core.expr", fromlist=["Leaf", "MergeFn"])
    add = expr.MergeFn("spmd_add", lambda x, y: x + y)
    mul = expr.MergeFn("spmd_mul", lambda x, y: x * y)
    a = api.Matrix(s, expr.Leaf("A", DIMS, 1.0))
    b = api.Matrix(s, expr.Leaf("B", DIMS, 1.0))
    mx = a
    for _ in range(int(rng.integers(2, 5))):
        op = rng.choice(["t", "scalar", "ewadd", "matmul", "overlay",
                         "overlay_t", "select", "reuse"])
        if op == "t":
            mx = mx.t()
        elif op == "scalar":
            mx = mx.add(float(rng.choice([-1.5, 0.5, 2.0])))
        elif op == "ewadd" and mx.plan.shape == b.plan.shape:
            mx = mx.add(b)
        elif op == "matmul":
            if mx.plan.shape[1] == b.plan.shape[0]:
                mx = mx.multiply(b)
            elif mx.plan.shape[1] == b.plan.shape[1]:
                mx = mx.multiply(b.t())
        elif op == "overlay" and mx.plan.shape == b.plan.shape:
            mx = mx.join(b, "RID=RID AND CID=CID",
                         add if rng.random() < 0.5 else mul)
        elif op == "overlay_t" and mx.plan.shape == b.plan.shape[::-1]:
            mx = mx.join(b, "RID=CID AND CID=RID", add)
        elif op == "select":
            hi = mx.plan.shape[0] - 1
            mx = mx.select(f"RID>={0} AND RID<={max(hi // 2, 0)}")
        elif op == "reuse":
            mx = mx.add(mx)
    if rng.random() < 0.5:
        mx = mx.agg(str(rng.choice(["sum", "max"])),
                    str(rng.choice(["r", "c", "a"])))
    return mx


def cases(pkg, session_kw):
    """``{name: (session, query)}`` for the dense cases, built with
    ``pkg``'s API from the seeds the reference's check uses."""
    api = __import__(f"{pkg}.core.api", fromlist=["Session", "Matrix"])
    expr = __import__(f"{pkg}.core.expr", fromlist=["Leaf", "MergeFn"])
    out = {}
    rng = np.random.default_rng(99)
    s = api.Session(block_size=8, mode="dense", **session_kw)
    s.load(_rand(rng, 1.0), "A")
    s.load(_rand(rng, 1.0), "B")
    a = api.Matrix(s, expr.Leaf("A", DIMS, 1.0))
    b = api.Matrix(s, expr.Leaf("B", DIMS, 1.0))
    out["d2d"] = (s, a.join(b.t(), "CID=RID",
                            expr.MergeFn("spmd_d2d", lambda x, y: x * y)))
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        s = api.Session(block_size=8, mode="dense", **session_kw)
        s.load(_rand(rng, float(rng.choice([0.2, 1.0]))), "A")
        s.load(_rand(rng, float(rng.choice([0.2, 1.0]))), "B")
        out[f"seed{seed}"] = (s, build_query(s, rng, pkg))
    # benchmarks/bench_dist_comm.py's pipeline, its data from seed 0
    rng = np.random.default_rng(0)
    m, k = 512, 256
    s = api.Session(block_size=128, mode="dense", **session_kw)
    s.load(rng.normal(size=(m, k)).astype(np.float32), "X")
    s.load(rng.normal(size=(k, k)).astype(np.float32), "Y")
    x = api.Matrix(s, expr.Leaf("X", (m, k), 1.0))
    y = api.Matrix(s, expr.Leaf("Y", (k, k), 1.0))
    add = expr.MergeFn("dist_add", lambda p, q: p + q)
    mul = expr.MergeFn("dist_mul", lambda p, q: p * q)
    out["pipeline"] = (s, x.t().multiply(x)
                       .select(f"RID>=0 AND RID<={k - 1}")
                       .join(y, "RID=RID AND CID=CID", add)
                       .join(y, "RID=RID AND CID=CID", mul)
                       .join(y, "RID=CID AND CID=RID", add))
    return out


def sparse_cases(pkg, session_kw):
    """The sparse-tier plans of the reference's multi-device tests."""
    api = __import__(f"{pkg}.core.api", fromlist=["Session", "Matrix"])
    expr = __import__(f"{pkg}.core.expr", fromlist=["Leaf", "MergeFn"])
    out = {}
    rng = np.random.default_rng(1)
    v = np.where(rng.uniform(size=DIMS) < 0.3,
                 rng.normal(size=DIMS), 0).astype(np.float32)
    s = api.Session(block_size=8, mode="sparse", **session_kw)
    s.load(v, "X")
    x = api.Matrix(s, expr.Leaf("X", DIMS, 0.3))
    out["overlay"] = (s, x.join(x, "RID=RID AND CID=CID",
                                expr.MergeFn("sp_add", lambda p, q: p + q)))
    out["val_select"] = (s, x.select("VAL>0").join(
        x, "RID=RID AND CID=CID", expr.MergeFn("sp_add", lambda p, q: p + q)))
    # tests/test_sparse_device.py's staged-SPMD case (BS = 8, 32²)
    rng = np.random.default_rng(0)

    def _sparse(m, n, d):
        return np.where(rng.uniform(size=(m, n)) < d,
                        rng.normal(size=(m, n)), 0).astype(np.float32)
    s = api.Session(block_size=8, mode="sparse", **session_kw)
    s.load(_sparse(32, 32, 0.2), "A")
    s.load(_sparse(32, 32, 0.3), "B")
    a = api.Matrix(s, expr.Leaf("A", (32, 32), 0.2))
    b = api.Matrix(s, expr.Leaf("B", (32, 32), 0.3))
    mul = expr.MergeFn("sd_mul", lambda p, q: p * q)
    out["sparse_device"] = (
        s, a.join(b, "RID=RID AND CID=CID", mul).multiply(b).sum("c"))
    return out


def _dense(r):
    return np.asarray(r.to_dense() if not hasattr(r, "value") else r.value)


def reference_main() -> None:
    """The JAX package's side, under eight forced host devices."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from repro.plan import render, staged_collective_bytes
    from repro.plan.schemes import ENTRY_BYTES
    out = {}
    for name, (s, q) in list(cases("repro", {"n_workers": N}).items()) \
            + list(sparse_cases("repro", {"n_workers": N}).items()):
        plan = q.physical_plan()
        want = s.execute(q.optimized_plan().plan, optimize=False,
                         engine="tree")
        out[name] = {
            "want": _dense(want).tolist(),
            "render": render(plan),
            "total_comm_est": plan.total_comm_est,
            "predicted": plan.total_comm_est * ENTRY_BYTES,
            "measured": staged_collective_bytes(plan, s.env, s.mesh),
        }
    print(json.dumps(out))


@pytest.fixture(scope="module")
def ref():
    env = dict(
        os.environ,
        PYTHONPATH=os.path.join(ROOT, "src"),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=8").strip(),
    )
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--reference"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# Values.
# ---------------------------------------------------------------------------

def _has_sum(plan) -> bool:
    from repro_torch.core.expr import AggFn
    from repro_torch.plan import ops as P
    return any(n.kind in (P.MATMUL, P.MASKED_AGG, P.MASKED_ELEMWISE)
               or (n.kind == P.AGG and n.expr.fn in (AggFn.SUM, AggFn.AVG))
               for n in plan.nodes)


def _single_worker(name, sparse=False):
    build = sparse_cases if sparse else cases
    s, q = build("repro_torch", {"device": "cpu"})[name]
    return _dense(q.collect()), q.physical_plan()


@pytest.mark.parametrize("name", ["d2d"] + [f"seed{i}" for i in SEEDS]
                         + ["pipeline"])
def test_dense_spmd_matches_reference_oracle_and_one_worker(ref, name):
    from repro_torch.plan import PlanExecutor
    s, q = cases("repro_torch", {"n_workers": N, "device": "cpu"})[name]
    plan = q.physical_plan()
    ex = PlanExecutor(s.env, mesh=s.mesh)
    got = _dense(ex.run(plan))
    assert ex.stats["staged_spmd"] == 1
    assert ex.stats["staged"] == 0
    want = np.asarray(ref[name]["want"], np.float32)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3,
                               err_msg=name)
    one, one_plan = _single_worker(name)
    if _has_sum(plan) or _has_sum(one_plan):
        np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-6)
    else:
        assert np.array_equal(got, one), name


@pytest.mark.parametrize("name", ["overlay", "sparse_device"])
def test_sparse_spmd_stages_once_and_matches(ref, name):
    from repro_torch.plan import PlanExecutor
    s, q = sparse_cases("repro_torch", {"n_workers": N,
                                        "device": "cpu"})[name]
    plan = q.physical_plan()
    ex = PlanExecutor(s.env, mesh=s.mesh)
    got = _dense(ex.run(plan))
    assert ex.stats["staged_sparse_spmd"] == 1      # one staged program
    assert plan._staged_sparse_spmd_fn is not None
    assert plan.node(plan.root).scheme is not None  # schemes propagated
    np.testing.assert_allclose(got, np.asarray(ref[name]["want"]),
                               atol=1e-3, rtol=1e-3)
    one, one_plan = _single_worker(name, sparse=True)
    if _has_sum(plan):
        np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-6)
    else:
        assert np.array_equal(got, one)


def test_value_predicate_sparse_plan_runs_eagerly(ref):
    """A value-predicate selection is not stageable: the plan runs on the
    eager path (one device, as the reference's eager path), not SPMD."""
    from repro_torch.plan import PlanExecutor
    s, q = sparse_cases("repro_torch", {"n_workers": N,
                                        "device": "cpu"})["val_select"]
    ex = PlanExecutor(s.env, mesh=s.mesh)
    got = _dense(ex.run(q.physical_plan()))
    assert ex.stats["staged_sparse_spmd"] == 0
    assert ex.stats["node_evals"] > 0
    np.testing.assert_allclose(got, np.asarray(ref["val_select"]["want"]),
                               atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Bytes and plans.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["d2d"] + [f"seed{i}" for i in SEEDS]
                         + ["pipeline"])
def test_counted_bytes_equal_the_prediction(ref, name):
    from repro_torch.plan import render, staged_collective_bytes
    from repro_torch.plan.schemes import ENTRY_BYTES
    s, q = cases("repro_torch", {"n_workers": N, "device": "cpu"})[name]
    plan = q.physical_plan()
    counted = staged_collective_bytes(plan, s.env, s.mesh)
    predicted = plan.total_comm_est * ENTRY_BYTES
    assert counted == predicted, (name, counted, predicted)
    # the same plan, schemes and prediction as the reference's
    assert render(plan) == ref[name]["render"]
    assert plan.total_comm_est == ref[name]["total_comm_est"]
    r = ref[name]
    if r["measured"] == r["predicted"]:
        assert counted == r["measured"], name


def test_pipeline_counts_each_conversion_once(ref):
    """bench_dist_comm's pipeline at N = 8: X (512×256, c) gathered for
    the product, (N−1)·|X|, and Y (256², r) moved to c for the transpose
    overlay, (N−1)/N·|Y| — once each although Y feeds three joins."""
    from repro_torch.plan import PlanExecutor
    s, q = cases("repro_torch", {"n_workers": N, "device": "cpu"})["pipeline"]
    ex = PlanExecutor(s.env, mesh=s.mesh)
    ex.run(q.physical_plan())
    want = ((N - 1) * 512 * 256 + (N - 1) * 256 * 256 // N) * 4
    assert ex.stats["collective_bytes"] == want == 3899392
    assert ref["pipeline"]["predicted"] == want


def test_sparse_and_unstageable_plans_measure_none(ref):
    from repro_torch.plan import staged_collective_bytes
    for name in ("overlay", "val_select"):
        s, q = sparse_cases("repro_torch", {"n_workers": N,
                                            "device": "cpu"})[name]
        assert staged_collective_bytes(q.physical_plan(), s.env,
                                       s.mesh) is None
        assert ref[name]["measured"] is None
    s, q = cases("repro_torch", {"n_workers": N, "device": "cpu"})["seed0"]
    assert staged_collective_bytes(q.physical_plan(), s.env, None) is None


# ---------------------------------------------------------------------------
# The per-call path, the session mesh, staging and EXPLAIN.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred_s", ["RID=RID AND CID=CID",
                                    "RID=CID AND CID=RID", "RID=RID"])
def test_per_join_entry(pred_s):
    from repro.core.joins import join_dense as j_join_dense
    from repro.core.predicates import parse_join as jparse
    from repro_torch.core import MergeFn, Session
    from repro_torch.core.joins import join_distributed
    from repro_torch.core.matrix import BlockMatrix
    from repro_torch.core.predicates import parse_join
    s = Session(block_size=8, mode="dense", n_workers=N, device="cpu")
    rng = np.random.default_rng(123)
    a_np = rng.normal(size=(16, 16)).astype(np.float32)
    b_np = rng.normal(size=(16, 16)).astype(np.float32)
    A = BlockMatrix.from_dense(torch.as_tensor(a_np), 8)
    B = BlockMatrix.from_dense(torch.as_tensor(b_np), 8)
    mul = MergeFn("pj_mul", lambda x, y: x * y)
    got, plan = join_distributed(s.mesh, A, B, parse_join(pred_s), mul)
    assert plan.n_workers == N
    from repro.core.expr import MergeFn as JMergeFn
    want = j_join_dense(a_np, b_np, jparse(pred_s),
                        JMergeFn("pj_mul", lambda x, y: x * y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3, err_msg=pred_s)


def test_per_join_entry_rejects_entry_joins():
    from repro_torch.core import MergeFn, Session
    from repro_torch.core.joins import join_distributed
    from repro_torch.core.matrix import BlockMatrix
    from repro_torch.core.predicates import parse_join
    s = Session(mode="dense", n_workers=N, device="cpu")
    A = BlockMatrix.from_dense(torch.ones(8, 8), 8)
    with pytest.raises(NotImplementedError, match="per-call distributed"):
        join_distributed(s.mesh, A, A, parse_join("VAL=VAL"),
                         MergeFn("pj_mul", lambda x, y: x * y))


def test_session_mesh_owned_and_cached():
    from repro_torch.core import Session
    from repro_torch.core.partitioner import mesh_workers
    s = Session(mode="dense", n_workers=8, device="cpu")
    m1 = s.mesh
    assert m1 is s.mesh, "mesh must be built once per session"
    assert mesh_workers(m1) == 8 and m1.device == torch.device("cpu")
    s2 = Session(mode="dense", n_workers=2, device="cpu")
    assert s2._mesh_key() != s._mesh_key()
    # changing the worker count rebuilds the mesh; one worker has none
    s.n_workers = 4
    assert mesh_workers(s.mesh) == 4 and s.mesh is not m1
    assert Session(device="cpu").mesh is None
    assert Session(device="cpu").workers == 1


def test_spmd_staged_once_then_cached():
    from repro_torch.core import Session
    from repro_torch.core.api import Matrix
    from repro_torch.core.expr import Leaf
    rng = np.random.default_rng(0)
    s = Session(block_size=8, mode="dense", n_workers=8, device="cpu")
    s.load(rng.normal(size=(24, 16)).astype(np.float32), "X")
    x = Matrix(s, Leaf("X", (24, 16), 1.0))
    q = x.t().multiply(x).add(2.0)
    q.collect()
    pplan = s.physical_plan(s._optimized(q.plan))
    staged = pplan._staged_spmd_fn
    assert staged is not None
    assert pplan._staged_fn is None  # the plain path was never needed
    q.collect()
    assert pplan._staged_spmd_fn is staged


def test_explain_measured_comm_on_mesh():
    from repro_torch.core import Session
    from repro_torch.core.api import Matrix
    from repro_torch.core.expr import Leaf
    rng = np.random.default_rng(2)
    s = Session(block_size=8, mode="dense", n_workers=8, device="cpu")
    s.load(rng.normal(size=(32, 16)).astype(np.float32), "X")
    x = Matrix(s, Leaf("X", (32, 16), 1.0))
    out = x.t().multiply(x).explain(physical=True, measure_comm=True)
    assert "scheme=" in out
    assert "predicted" in out and "measured" in out
    line = next(ln for ln in out.splitlines() if "measured" in ln)
    predicted = float(re.search(r"~([0-9.e+]+) B", line)[1])
    measured = int(re.search(r"measured (\d+) collective", line)[1])
    assert measured == pytest.approx(predicted, rel=1e-3)


# ---------------------------------------------------------------------------
# The sparse tier's kernels: once a worker on aligned splits, once on
# gathered operands otherwise.
# ---------------------------------------------------------------------------

def _count_dispatches(monkeypatch):
    from repro_torch.kernels import registry
    calls = {}
    for name in ("merge_join", "masked_matmul", "sddmm_agg"):
        spec = registry.get(name)
        inner = spec.impls[registry.TORCH]

        def rec(*args, _inner=inner, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*args, **kw)
        monkeypatch.setitem(spec.impls, registry.TORCH, rec)
    return calls


def _kernel_catalog(m):
    rng = np.random.default_rng(5)
    bs = 8
    g = m // bs

    def blocky(live, d):
        keep = np.kron(rng.uniform(size=(g, g)) < live, np.ones((bs, bs)))
        v = np.where(rng.uniform(size=(m, m)) < d, rng.normal(size=(m, m)),
                     0)
        return (v * keep).astype(np.float32)
    return {"Ao": blocky(0.8, 0.5), "Bo": blocky(0.9, 0.5),
            "Ap": np.abs(blocky(0.3, 0.5)),
            "W": np.abs(rng.normal(size=(m, 4))).astype(np.float32),
            "H": np.abs(rng.normal(size=(4, m))).astype(np.float32)}


def _kernel_queries(mats):
    from repro_torch.core.sparsity import product_merge
    mul = product_merge()
    wh = mats["W"].multiply(mats["H"])
    return {
        "merge_join": mats["Ao"].join(mats["Bo"], "RID=RID AND CID=CID", mul),
        "masked_matmul": mats["Ap"].ediv(wh).multiply(mats["H"].t()),
        "sddmm_agg_r": mats["Ap"].emul(wh).sum("r"),
        "sddmm_agg_c": mats["Ap"].emul(wh).sum("c"),
        "sddmm_agg_a": mats["Ap"].emul(wh).sum("a"),
    }


@pytest.mark.parametrize("m,aligned", [(64, True), (48, False)])
def test_kernels_launch_once_a_worker_on_aligned_shards(monkeypatch, m,
                                                        aligned):
    """64 rows at N = 8 and block 8 split on block edges: each of the
    three kernels runs once a worker on its shard; 48 rows do not (6 a
    worker): the node gathers its operands and runs the kernel once.
    Every result equals the single-worker run (exact, sums rtol 1e-4)."""
    from repro_torch.core import Session
    from repro_torch.plan import PlanExecutor
    arrays = _kernel_catalog(m)
    one = Session(block_size=8, device="cpu")
    want = {k: _dense(q.collect()) for k, q in _kernel_queries(
        {n: one.load(v, n) for n, v in arrays.items()}).items()}
    s = Session(block_size=8, n_workers=N, device="cpu")
    queries = _kernel_queries({n: s.load(v, n) for n, v in arrays.items()})
    for name, q in queries.items():
        plan = q.physical_plan()
        calls = _count_dispatches(monkeypatch)
        ex = PlanExecutor(s.env, mesh=s.mesh)
        got = _dense(ex.run(plan))
        kernel = name.rsplit("_", 1)[0] if name.startswith("sddmm") else name
        assert ex.stats["staged_sparse_spmd"] == 1
        assert calls == {kernel: N if aligned else 1}, (name, calls)
        assert ex.stats["spmd_sharded_nodes"] == int(aligned)
        assert ex.stats["spmd_gathered_nodes"] == int(not aligned)
        if name == "merge_join":
            assert np.array_equal(got, want[name])
        else:
            np.testing.assert_allclose(got, want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_masks_are_computed_once_for_all_workers(monkeypatch):
    """The mask pass propagates once a plan on the mesh, as on one
    worker: the workers take slices of the same plan-time masks, and a
    second run reuses them."""
    from repro_torch.core import Session
    from repro_torch.plan import PlanExecutor
    from repro_torch.plan import masks as masksmod
    calls = []
    inner = masksmod.propagate

    def counting(plan, env, *a, **kw):
        calls.append(id(plan))
        return inner(plan, env, *a, **kw)
    monkeypatch.setattr(masksmod, "propagate", counting)
    s = Session(block_size=8, n_workers=N, device="cpu")
    mats = {n: s.load(v, n) for n, v in _kernel_catalog(64).items()}
    plan = _kernel_queries(mats)["merge_join"].physical_plan()
    calls.clear()
    for _ in range(2):
        ex = PlanExecutor(s.env, mesh=s.mesh)
        ex.run(plan)
        assert ex.stats["spmd_sharded_nodes"] == 1
    assert calls == [id(plan)]


if __name__ == "__main__" and "--reference" in sys.argv:
    reference_main()
