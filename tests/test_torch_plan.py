"""Optimizer and planner parity: on the quickstart queries (plus a
block-sparse overlay and a non-inducing V2V), the port picks the same
optimized plan (equal ``expr_key`` up to the package's own classes), the
same ``PhysicalCost``, the same DAG — kinds, strategies, kernels, masks,
nnz bounds and capacities — and prints the same EXPLAIN text apart from
backend names."""
import dataclasses
import enum
import re

import numpy as np
import pytest

from repro.core import Session as JSession
from repro.core.expr import expr_key as j_expr_key
from repro.core.sparsity import product_merge as j_mul, sum_merge as j_add
from repro_torch.core import Session
from repro_torch.core.expr import expr_key
from repro_torch.core.sparsity import product_merge, sum_merge


def _norm(x):
    """A key both packages can compare: enums by value, merges by name,
    dataclasses field by field."""
    if isinstance(x, tuple):
        return tuple(_norm(v) for v in x)
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if type(x).__name__ == "MergeFn":
        return ("MergeFn", x.name)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple(_norm(getattr(x, f.name)) for f in dataclasses.fields(x)))
    return x


def _data():
    rng = np.random.default_rng(0)
    x = np.where(rng.uniform(size=(2000, 1000)) < 1e-3,
                 rng.normal(size=(2000, 1000)), 0).astype(np.float32)
    a = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    b = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    dirty = a.copy()
    dirty[::7] = 0.0
    # block-sparse overlay operands: 16 blocks of 64, 4 and 2 of them empty
    ao = np.round(rng.normal(size=(256, 256)), 1).astype(np.float32)
    bo = np.round(rng.normal(size=(256, 256)), 1).astype(np.float32)
    for k in (0, 5, 10, 15):
        ao[(k // 4) * 64:(k // 4 + 1) * 64, (k % 4) * 64:(k % 4 + 1) * 64] = 0
    for k in (3, 6):
        bo[(k // 4) * 64:(k // 4 + 1) * 64, (k % 4) * 64:(k % 4 + 1) * 64] = 0
    w = rng.uniform(size=(512, 8)).astype(np.float32)
    h = rng.uniform(size=(8, 512)).astype(np.float32)
    return {"X": x, "A": a, "B": b, "D": dirty, "Ao": ao, "Bo": bo, "W": w,
            "H": h}


QUERIES = {
    "trace": lambda m, mg: m["X"].t().multiply(m["X"]).trace(),
    "g11": lambda m, mg: m["X"].t().multiply(m["X"]).select(
        "RID=1 AND CID=1"),
    "overlay": lambda m, mg: m["A"].join(m["B"], "RID=RID AND CID=CID",
                                         mg["mul"]),
    "d2d": lambda m, mg: m["A"].join(m["B"], "RID=RID", mg["mul"]),
    "v2v": lambda m, mg: m["A"].join(m["B"], "VAL=VAL", mg["mul"]),
    "v2v_add": lambda m, mg: m["A"].join(m["B"], "VAL=VAL", mg["add"]),
    "rows": lambda m, mg: m["D"].select("rows != NULL"),
    "overlay_blocks": lambda m, mg: m["Ao"].join(
        m["Bo"], "RID=RID AND CID=CID", mg["mul"]),
    "d2d_cid": lambda m, mg: m["A"].join(m["B"], "CID=CID", mg["mul"]),
    "masked": lambda m, mg: m["A"].emul(m["W"].multiply(m["H"])),
    "masked_sum": lambda m, mg: m["A"].emul(
        m["W"].multiply(m["H"])).sum("r"),
}


@pytest.fixture(scope="module")
def sessions():
    data = _data()
    js, ts = JSession(block_size=64), Session(block_size=64, device="cpu")
    jm = {k: js.load(v, k) for k, v in data.items()}
    tm = {k: ts.load(v, k) for k, v in data.items()}
    return (jm, {"mul": j_mul(), "add": j_add()}), \
        (tm, {"mul": product_merge(), "add": sum_merge()})


def _both(sessions, name):
    (jm, jmg), (tm, tmg) = sessions
    return QUERIES[name](jm, jmg), QUERIES[name](tm, tmg)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_same_optimized_plan_and_cost(sessions, name):
    jq, tq = _both(sessions, name)
    jr, tr = jq.optimized_plan(), tq.optimized_plan()
    assert _norm(expr_key(tr.plan)) == _norm(j_expr_key(jr.plan))
    assert tr.fired == jr.fired
    for got, want in ((tr.physical, jr.physical),
                      (tr.physical_original, jr.physical_original)):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.flops == pytest.approx(want.flops, rel=1e-12)
            assert got.comm == pytest.approx(want.comm, rel=1e-12)
            assert got.nnz == pytest.approx(want.nnz, rel=1e-12)
    assert tr.optimized_cost == pytest.approx(jr.optimized_cost, rel=1e-12)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_same_dag_strategies_masks_and_capacities(sessions, name):
    from repro.plan import masks as jmasks
    from repro_torch.plan import masks as tmasks
    jq, tq = _both(sessions, name)
    jp, tp = jq.physical_plan(), tq.physical_plan()
    jmasks.annotate(jp, jq.session.env)
    tmasks.annotate(tp, tq.session.env)
    assert tp.n_nodes == jp.n_nodes and tp.root == jp.root
    for tn, jn in zip(tp.nodes, jp.nodes):
        assert (tn.kind, tn.strategy, tn.kernel, tn.children) == \
            (jn.kind, jn.strategy, jn.kernel, jn.children)
        assert tn.jit_safe == jn.jit_safe
        for key in ("cap", "cap_sides", "device", "demote_dense",
                    "nnz_bound"):
            assert tn.meta.get(key) == jn.meta.get(key), key
        tmask, jmask = tn.meta.get("mask"), jn.meta.get("mask")
        assert (tmask is None) == (jmask is None)
        if tmask is not None:
            assert np.array_equal(tmask, np.asarray(jmask))


def _strip_backends(text: str) -> str:
    return re.sub(r"backend=\S+", "backend=*", text)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_same_explain_text(sessions, name):
    jq, tq = _both(sessions, name)
    assert tq.explain() == jq.explain()
    got = tq.explain(physical=True)
    assert _strip_backends(got) == _strip_backends(jq.explain(physical=True))
    # the port's kernel nodes name the backend of the session's device
    assert "backend=dense" not in got
    if "kernel=" in got:
        assert "backend=torch" in got


def test_explain_golden_bloom_join_with_schemes_four_workers():
    """The JAX package's n_workers = 4 golden (``tests/test_plan.py``):
    the join's §4.7 scheme pair, the propagated schemes and the predicted
    comm render line for line as there (backend names aside)."""
    import textwrap
    from repro.core.expr import Join as JJoin, Leaf as JLeaf
    from repro.core.expr import MergeFn as JMergeFn
    from repro.core.predicates import parse_join as jparse
    from repro.plan import build_plan as j_build_plan, render as j_render
    from repro_torch.core.expr import Join, Leaf, MergeFn
    from repro_torch.core.predicates import parse_join
    from repro_torch.plan import build_plan, render
    j = Join(Leaf("A", (512, 512), 0.5), Leaf("B", (512, 512), 0.5),
             parse_join("VAL=VAL"), MergeFn("mul", lambda x, y: x * y))
    jj = JJoin(JLeaf("A", (512, 512), 0.5), JLeaf("B", (512, 512), 0.5),
               jparse("VAL=VAL"), JMergeFn("mul", lambda x, y: x * y))
    got = render(build_plan(j, mode="sparse", block_size=8, n_workers=4))
    ref = j_render(j_build_plan(jj, mode="sparse", block_size=8,
                                n_workers=4, kernel_backend="dense"))
    expected = textwrap.dedent("""\
        == physical plan: mode=sparse workers=4 | 3 ops from 3 logical nodes (0 shared) | est 1.718e+10 flops ==
        == comm: predicted 3.932e+05 entries moved (~1.573e+06 B) ==
        #2 Join[VAL=VAL, f=mul]  shape=(512, 512, 512, 512) sp=0.025 cost=1.718e+10  [strategy=bloom-sortmerge kernel=bloom_probe backend=dense schemes=(r,r) comm=6.55e+05 scheme=r←(r,r) moved=3.93e+05]
          #0 Leaf[A]  shape=(512, 512) sp=0.5 cost=0  [scheme=r moved=0]
          #1 Leaf[B]  shape=(512, 512) sp=0.5 cost=0  [scheme=r moved=0]""")
    assert ref == expected
    assert _strip_backends(got).splitlines() == \
        _strip_backends(expected).splitlines()
    assert "backend=torch" in got
    # the reference's default of one worker: no schemes, no comm line
    one = render(build_plan(j, mode="sparse", block_size=8))
    assert "workers=1" in one and "scheme" not in one
