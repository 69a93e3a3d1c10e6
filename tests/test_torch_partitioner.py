"""The port's partitioner and collective layer against the JAX package.

The scheme algebra (transpose rule, placement ranks), the §4.7 golden
table of ``plan_join_static`` (equal to ``repro.core.partitioner``'s
choice for the four join families × n ∈ {2, 4, 8}), the explicit worker
mesh, and the bytes each collective family counts at N = 8 on a 512²
float32 matrix (the convention of the JAX package's ``_FLEET_SCALE``).
"""
import numpy as np
import pytest
import torch

from repro.core import partitioner as jpart
from repro_torch.core import cost as C
from repro_torch.core import spmd
from repro_torch.core.partitioner import (
    WORKER_AXIS, Placement, mesh_workers, measured_collective_bytes,
    measured_network_bytes, plan_join_static, scheme_spec, sharding_for,
    worker_mesh,
)
from repro_torch.core.predicates import parse_join
from repro_torch.plan.schemes import transpose_scheme

BIG_A, BIG_B = 1e7, 8e6
TINY = 1e3
N, SIDE = 8, 512
B_BYTES = SIDE * SIDE * 4


# ---------------------------------------------------------------------------
# Scheme algebra.
# ---------------------------------------------------------------------------

def test_transpose_scheme_rule():
    assert transpose_scheme(C.ROW) == C.COL
    assert transpose_scheme(C.COL) == C.ROW
    assert transpose_scheme(C.BCAST) == C.BCAST
    assert transpose_scheme(C.RANDOM) == C.RANDOM


def test_transpose_rule_matches_spec_swap():
    swap = {Placement(0): Placement(1), Placement(1): Placement(0),
            Placement(None): Placement(None)}
    for s in (C.ROW, C.COL, C.BCAST):
        assert scheme_spec(transpose_scheme(s)) == swap[scheme_spec(s)]


@pytest.mark.parametrize("scheme,ndim", [
    (C.ROW, 2), (C.COL, 2), (C.BCAST, 2), (C.RANDOM, 2), (C.ROW, 3),
    (C.BCAST, 4)])
def test_scheme_spec_ranks_match_the_reference(scheme, ndim):
    """Same split dimension as the reference's PartitionSpec, entry for
    entry; order-3/4 outputs split the leading dimension."""
    got = scheme_spec(scheme, ndim=ndim).spec
    want = tuple(jpart.scheme_spec(scheme, ndim=ndim))
    assert got == want
    assert got.count(WORKER_AXIS) == (0 if scheme == C.BCAST else 1)


def test_column_is_undefined_above_rank_two():
    with pytest.raises(ValueError):
        scheme_spec(C.COL, ndim=3)
    with pytest.raises(ValueError):
        jpart.scheme_spec(C.COL, ndim=3)


def test_worker_mesh_is_explicit():
    """The device is named, n < 1 is refused, and — unlike the reference,
    whose workers are devices — any n runs on the one device given."""
    for bad in (0, -1):
        with pytest.raises(ValueError, match="n >= 1"):
            worker_mesh(bad, "cpu")
    mesh = worker_mesh(16, "cpu")
    assert mesh_workers(mesh) == 16 and mesh.device == torch.device("cpu")
    assert mesh.axis_names == (WORKER_AXIS,)
    sh = sharding_for(mesh, C.COL)
    assert sh.mesh is mesh and sh.placement == Placement(1)


# ---------------------------------------------------------------------------
# Golden table: plan_join_static over the join families × n_workers, the
# reference's hand-derived values and the reference's own choice.
# ---------------------------------------------------------------------------

def _same_choice(pred_s, size_a, size_b, n, **kw):
    from repro.core.predicates import parse_join as jparse
    got = plan_join_static(parse_join(pred_s), size_a, size_b, n, **kw)
    want = jpart.plan_join_static(jparse(pred_s), size_a, size_b, n, **kw)
    c, w = got.choice, want.choice
    assert (c.scheme_a, c.scheme_b) == (w.scheme_a, w.scheme_b)
    assert (c.comm_cost, c.conversion_cost, c.total) == \
        (w.comm_cost, w.conversion_cost, w.total)
    assert got.spec_a.spec == tuple(want.spec_a)
    assert got.spec_b.spec == tuple(want.spec_b)
    assert got.describe() == want.describe()
    return got


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_direct_overlay(n):
    c = _same_choice("RID=RID AND CID=CID", BIG_A, BIG_B, n).choice
    assert (c.scheme_a, c.scheme_b) == (C.ROW, C.ROW)
    assert c.comm_cost == 0.0
    assert c.conversion_cost == BIG_A + BIG_B


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_transpose_overlay(n):
    c = _same_choice("RID=CID AND CID=RID", BIG_A, BIG_B, n).choice
    assert (c.scheme_a, c.scheme_b) == (C.ROW, C.COL)
    assert c.comm_cost == 0.0
    mismatched = C.join_comm_cost(parse_join("RID=CID AND CID=RID"),
                                  C.ROW, C.ROW, BIG_A, BIG_B, n)
    assert mismatched == pytest.approx((n - 1) / n * BIG_B)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("gamma,want", [
    ("RID=RID", (C.ROW, C.ROW)),
    ("RID=CID", (C.ROW, C.COL)),
    ("CID=RID", (C.COL, C.ROW)),
    ("CID=CID", (C.COL, C.COL)),
])
def test_golden_d2d_aligns_with_predicate(n, gamma, want):
    c = _same_choice(gamma, BIG_A, BIG_B, n).choice
    assert (c.scheme_a, c.scheme_b) == want
    assert c.comm_cost == 0.0
    assert c.total == BIG_A + BIG_B


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_v2v_large_sides(n):
    c = _same_choice("VAL=VAL", BIG_A, BIG_B, n).choice
    assert (c.scheme_a, c.scheme_b) == (C.ROW, C.ROW)
    assert c.comm_cost == pytest.approx((n - 1) * BIG_B)
    assert c.total == pytest.approx(BIG_A + BIG_B + (n - 1) * BIG_B)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_v2v_tiny_side(n):
    c = _same_choice("VAL=VAL", BIG_A, TINY, n).choice
    assert (c.scheme_a, c.scheme_b) == (C.ROW, C.ROW)
    assert c.total == pytest.approx(BIG_A + n * TINY)
    c = _same_choice("VAL=VAL", BIG_A, TINY, n, s_a=C.ROW,
                     s_b=C.BCAST).choice
    assert c.scheme_b == C.BCAST
    assert c.comm_cost == 0.0 and c.total == 0.0


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("pred_s", ["RID=VAL", "VAL=CID"])
def test_golden_dimension_entry_joins(n, pred_s):
    """D2V / V2D: the fourth family, held to the reference's choice."""
    _same_choice(pred_s, BIG_A, BIG_B, n)
    _same_choice(pred_s, BIG_A, TINY, n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_golden_preserves_existing_schemes(n):
    c = _same_choice("RID=RID", BIG_A, BIG_B, n, s_a=C.ROW,
                     s_b=C.ROW).choice
    assert (c.scheme_a, c.scheme_b) == (C.ROW, C.ROW)
    assert c.total == 0.0


# ---------------------------------------------------------------------------
# The collective layer: bytes per family at N = 8 on a 512² float32 matrix.
# ---------------------------------------------------------------------------

@pytest.fixture
def mat():
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.normal(size=(SIDE, SIDE)).astype(np.float32))


@pytest.mark.parametrize("src,dst,family,want", [
    (C.COL, C.ROW, "all-to-all", (N - 1) * B_BYTES // N),
    (C.ROW, C.COL, "all-to-all", (N - 1) * B_BYTES // N),
    (C.ROW, C.BCAST, "all-gather", (N - 1) * B_BYTES),
    (C.COL, C.BCAST, "all-gather", (N - 1) * B_BYTES),
    (C.BCAST, C.ROW, None, 0),
    (C.BCAST, C.COL, None, 0),
    (C.ROW, C.ROW, None, 0),
])
def test_reshard_bytes_per_family(mat, src, dst, family, want):
    """Table 3 in bytes: r↔c is an all-to-all of (N−1)/N·|B|, r/c → b an
    all-gather of (N−1)·|B|, and a slice of a replica moves nothing; the
    value is unchanged bit for bit."""
    x = spmd.place(mat, src, N)
    with spmd.recording() as rec:
        y = spmd.consume(x, dst)
    assert rec.total == want
    assert rec.by_family == ({} if family is None else {family: want})
    if family is not None:
        # the per-device operand: worker 0's shard, |B|/N
        assert rec.per_worker == B_BYTES // N
    assert torch.equal(spmd.assemble(y), mat)
    assert y.dim == spmd.scheme_dim(dst)


def test_gather_and_reduce_bytes(mat):
    x = spmd.place(mat, C.ROW, N)
    with spmd.recording() as rec:
        whole = spmd.gather(x)
    assert torch.equal(whole, mat)
    assert rec.by_family == {"gather": (N - 1) * B_BYTES // N}
    partials = [s.sum(dim=0, keepdim=True) for s in x.shards]
    with spmd.recording() as rec:
        out = spmd.reduce(partials, lambda p: sum(p[1:], p[0]), N)
    assert rec.by_family == {"reduce": SIDE * 4}   # the output, once
    assert out.dim is None and out.n == N
    torch.testing.assert_close(spmd.assemble(out), mat.sum(0, keepdim=True),
                               rtol=1e-4, atol=1e-4)


def test_permute_counts_only_rows_that_change_worker(mat):
    x = spmd.place(mat, C.ROW, N)
    shifted = tuple((min(lo + 8, SIDE), min(hi + 8, SIDE)) if i else
                    (0, hi + 8) for i, (lo, hi) in enumerate(x.bounds))
    with spmd.recording() as rec:
        y = spmd.redistribute(x, 0, shifted)
    # every worker but the last takes 8 rows from its right neighbour
    assert rec.by_family == {"collective-permute": (N - 1) * 8 * SIDE * 4}
    assert torch.equal(spmd.assemble(y), mat)


def test_nested_recordings_each_see_the_traffic(mat):
    x = spmd.place(mat, C.COL, N)
    with spmd.recording() as outer:
        with spmd.recording() as inner:
            spmd.consume(x, C.ROW)
        spmd.consume(x, C.BCAST)
    assert inner.total == (N - 1) * B_BYTES // N
    assert outer.total == inner.total + (N - 1) * B_BYTES


def test_measured_bytes_of_a_function(mat):
    def fn(t):
        return spmd.consume(spmd.place(t, C.COL, N), C.ROW)
    assert measured_network_bytes(fn, mat, n_workers=N) == \
        (N - 1) * B_BYTES // N
    assert measured_collective_bytes(fn, mat) == B_BYTES // N


@pytest.mark.parametrize("scheme", [C.ROW, C.COL, C.BCAST])
def test_every_worker_owns_its_storage(mat, scheme):
    """Shards (and replicas) never share storage with each other or with
    the placed tensor: a worker reading another's data would have to go
    through a counted collective."""
    x = spmd.place(mat, scheme, N)
    ptrs = {s.untyped_storage().data_ptr() for s in x.shards}
    assert len(ptrs) == N
    assert mat.untyped_storage().data_ptr() not in ptrs
    assert all(s.is_contiguous() for s in x.shards)
    x.shards[0].fill_(0.0)
    assert not torch.equal(spmd.assemble(x), mat) or scheme == C.BCAST
    assert all(bool((s != 0).any()) for s in x.shards[1:])


@pytest.mark.parametrize("size,n,want", [
    (24, 8, ((0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18),
             (18, 21), (21, 24))),
    (12, 8, ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 12),
             (12, 12))),
    (5, 4, ((0, 2), (2, 4), (4, 5), (5, 5))),
])
def test_chunks_follow_xla_tiling(size, n, want):
    assert spmd.xla_bounds(size, n) == want


@pytest.mark.parametrize("shape", [(24, 16), (12, 7), (5, 40)])
@pytest.mark.parametrize("src", [C.ROW, C.COL, C.BCAST])
@pytest.mark.parametrize("dst", [C.ROW, C.COL, C.BCAST])
def test_reshards_keep_values_on_uneven_splits(shape, src, dst):
    rng = np.random.default_rng(1)
    t = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    y = spmd.consume(spmd.place(t, src, N), dst)
    assert torch.equal(spmd.assemble(y), t)
    assert [s.shape[y.dim] for s in y.shards] == \
        [hi - lo for lo, hi in y.bounds] if y.dim is not None else True
