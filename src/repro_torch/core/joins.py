"""Physical join execution over matrix data (paper §4).

Three execution tiers, mirroring the paper's local/distributed split:

* ``*_dense``   — plain tensor reference semantics (the oracle for tests
                  and the dense tier).
* ``*_sparse``  — sparsity-aware eager execution exploiting block masks and
                  COO entry sets (the paper's "never densify" fast path; this
                  is what makes the paper's headline speedups reproducible).
* distributed   — not ported yet (the multi-worker slice of the ROADMAP).

Join outputs of order 3/4 are returned as ``COOTensor`` on the sparse tier
(exact relational semantics, nnz-proportional memory) and dense tensors
on the reference tier.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bloom as bloommod
from repro_torch.core import cost as costmod
from repro_torch.core.expr import MergeFn
from repro_torch.core.matrix import BlockMatrix
from repro_torch.core.predicates import Field, JoinKind, JoinPred
from repro_torch.core.sparsity import analyze_merge


@dataclasses.dataclass
class COOTensor:
    """Coordinate-format tensor: the relational view of a join output."""

    idx: np.ndarray    # [nnz, order] int64
    val: np.ndarray    # [nnz]
    shape: Tuple[int, ...]

    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.val.dtype)
        if self.nnz:
            out[tuple(self.idx.T)] = self.val
        return out


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; numpy has no bfloat16, so a bfloat16
    merge's values come as the float32 that holds each exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _coo_of(m: Union[BlockMatrix, torch.Tensor]):
    v = _host(m.value if isinstance(m, BlockMatrix) else m)
    idx = np.argwhere(v != 0)
    return idx, v[tuple(idx.T)], v


def _out_dtype(adense: np.ndarray, bdense: np.ndarray) -> np.dtype:
    """Value dtype of a join result: the promoted input dtype — also on
    the empty paths, so an empty result has the same dtype as a populated
    one (float32 under JAX defaults, never a hardcoded float64)."""
    return np.result_type(adense.dtype, bdense.dtype)


# ---------------------------------------------------------------------------
# Dense reference implementations (jit-able oracles).
# ---------------------------------------------------------------------------

def cross_dense(a: torch.Tensor, b: torch.Tensor, f: Callable) -> torch.Tensor:
    """A ⊗ B as an order-4 tensor out[i,j,k,l] = f(a_ij, b_kl) (§4.2)."""
    return f(a[:, :, None, None], b[None, None, :, :])


def overlay_dense(a: torch.Tensor, b: torch.Tensor, f: Callable,
                  transpose: bool = False) -> torch.Tensor:
    """Direct overlay f(A, B) or transpose overlay f(A, Bᵀ) (§4.3).

    Missing entries are implicit zeros (full-outer semantics of Fig. 4);
    shapes must match after the optional transpose.
    """
    bb = b.T if transpose else b
    return f(a, bb)


def d2d_dense(a: torch.Tensor, b: torch.Tensor, left: Field, right: Field,
              f: Callable) -> torch.Tensor:
    """Single-dimension join (§4.4): out[i, j, l] = f(A⟨i,j⟩, B⟨i,l⟩) where
    i ranges over the matched dimension; output is a 3rd-order tensor with
    the matched dimension leading (paper's D1-first layout heuristic)."""
    aa = a if left is Field.RID else a.T
    bb = b if right is Field.RID else b.T
    d1 = min(aa.shape[0], bb.shape[0])  # inner join on the key domain
    return f(aa[:d1, :, None], bb[:d1, None, :])


def v2v_dense(a: torch.Tensor, b: torch.Tensor, f: Callable) -> torch.Tensor:
    """Entry join (§4.5): out[i,j,k,l] = f(a_ij, b_kl) iff a_ij == b_kl ≠ 0."""
    eq = (a[:, :, None, None] == b[None, None, :, :]) \
        & (a != 0)[:, :, None, None]
    return torch.where(eq, f(a[:, :, None, None], b[None, None, :, :]), 0.0)


def d2v_dense(a: torch.Tensor, b: torch.Tensor, dim: Field,
              f: Callable) -> torch.Tensor:
    """Dimension-entry join (§4.6): γ = dim_A = val_B.

    out[i,j,k,l] = f(A[i,j], B[k,l]) iff B[k,l] == (i if dim is RID else j).
    """
    m, n = a.shape
    p, q = b.shape
    dimvals = torch.arange(m if dim is Field.RID else n, dtype=a.dtype,
                           device=a.device)
    d = dimvals[:, None, None, None] if dim is Field.RID \
        else dimvals[None, :, None, None]
    eq = (b[None, None, :, :] == d) & (b != 0)[None, None, :, :]
    return torch.where(eq, f(a[:, :, None, None], b[None, None, :, :]), 0.0)


def join_dense(a: torch.Tensor, b: torch.Tensor, pred: JoinPred,
               merge: MergeFn) -> torch.Tensor:
    k = pred.kind
    if k is JoinKind.CROSS:
        return cross_dense(a, b, merge.fn)
    if k is JoinKind.DIRECT_OVERLAY:
        return overlay_dense(a, b, merge.fn, transpose=False)
    if k is JoinKind.TRANSPOSE_OVERLAY:
        return overlay_dense(a, b, merge.fn, transpose=True)
    if k is JoinKind.D2D:
        return d2d_dense(a, b, pred.left, pred.right, merge.fn)
    if k is JoinKind.V2V:
        return v2v_dense(a, b, merge.fn)
    if k is JoinKind.D2V:
        return d2v_dense(a, b, pred.left, merge.fn)
    if k is JoinKind.V2D:
        # val_A = dim_B is the mirror of D2V with roles swapped
        t = d2v_dense(b, a, pred.right, lambda x, y: merge.fn(y, x))
        return t.permute(2, 3, 0, 1)
    raise ValueError(k)


# ---------------------------------------------------------------------------
# Sparse eager implementations (paper's optimized execution).
# ---------------------------------------------------------------------------

def _merge_host(fn: Callable, x: np.ndarray, y) -> np.ndarray:
    """The merge over host operands (numpy arrays or a numpy scalar), as
    CPU tensors: the port's merges are torch code (``torch.where`` and
    ``torch.maximum`` refuse numpy arrays, as jnp's take them in the JAX
    package)."""
    out = fn(torch.as_tensor(x), torch.as_tensor(y))
    return _host(out) if isinstance(out, torch.Tensor) else np.asarray(out)


def cross_sparse(a: BlockMatrix, b: BlockMatrix,
                 merge: MergeFn) -> COOTensor:
    """Sparsity-inducing cross-product: iterate only nonzero entries of the
    inducing side(s); memory/compute ∝ nnz(A)·nnz(B) instead of |A|·|B|."""
    prof = analyze_merge(merge)
    ai, av, adense = _coo_of(a)
    bi, bv, bdense = _coo_of(b)
    if not prof.inducing_x:
        ai = np.argwhere(np.ones_like(adense, dtype=bool))
        av = adense[tuple(ai.T)]
    if not prof.inducing_y:
        bi = np.argwhere(np.ones_like(bdense, dtype=bool))
        bv = bdense[tuple(bi.T)]
    na, nb = av.shape[0], bv.shape[0]
    if na * nb == 0:
        return COOTensor(np.zeros((0, 4), np.int64),
                         np.zeros((0,), _out_dtype(adense, bdense)),
                         a.shape + b.shape)
    # all pairs (vectorized): [na*nb]
    vals = _merge_host(merge.fn, np.repeat(av, nb), np.tile(bv, na))
    idx = np.concatenate(
        [np.repeat(ai, nb, axis=0), np.tile(bi, (na, 1))], axis=1)
    keep = vals != 0
    return COOTensor(idx[keep], vals[keep], a.shape + b.shape)


def overlay_sparse(a: BlockMatrix, b: BlockMatrix, merge: MergeFn,
                   transpose: bool = False,
                   kernel_backend: Optional[str] = None) -> BlockMatrix:
    """Block-skip overlay: compute only blocks allowed by the merge profile.

    Output block mask:  inducing on both ⇒ maskA & maskB; on x ⇒ maskA;
    on y ⇒ maskB; otherwise every block is computed (paper's straw man).
    """
    prof = analyze_merge(merge)
    bs = a.block_size
    dev = a.value.device
    bmask = _host(b.block_mask)
    bval = b.value
    if transpose:
        bval, bmask = bval.T, bmask.T
    amask = _host(a.block_mask)
    from repro_torch.core.matrix import mask_overlay
    out_mask = mask_overlay(prof.inducing_x, prof.inducing_y, amask, bmask)
    # adaptive execution: when most blocks are live, the block gather/
    # scatter machinery is pure overhead — evaluate the merge as one
    # block-masked kernel over the full matrices (the paper reports the
    # same parity for direct overlays, Fig. 10)
    if out_mask.mean() > 0.5:
        if out_mask.all():
            out = merge.fn(a.value, bval)
        else:
            from repro_torch.kernels import registry
            from repro_torch.kernels.merge_join import mode_for
            mode = mode_for(prof.inducing_x, prof.inducing_y)
            out = registry.dispatch(
                "merge_join", a.value, bval,
                torch.as_tensor(amask, device=dev),
                torch.as_tensor(np.ascontiguousarray(bmask), device=dev),
                backend=kernel_backend, merge=merge.fn, mode=mode,
                block_size=bs)
        return BlockMatrix(out, torch.as_tensor(out_mask, device=dev), bs,
                           a.scheme)
    ib, jb = np.nonzero(out_mask)
    out = torch.zeros(a.shape, dtype=a.dtype, device=dev)
    if ib.size:
        # gather the live blocks, apply the (elementwise) merge to the
        # stacked [k, bs, bs] tiles, scatter back
        from repro_torch.core.matrix import blocks_of, unblock
        ibt = torch.as_tensor(ib, device=dev)
        jbt = torch.as_tensor(jb, device=dev)
        at = blocks_of(a.value, bs)
        bt = blocks_of(bval, bs)
        merged = merge.fn(at[ibt, jbt], bt[ibt, jbt])  # [k, bs, bs]
        full = torch.zeros((a.grid[0], a.grid[1], bs, bs), dtype=a.dtype,
                           device=dev)
        full[ibt, jbt] = merged.to(a.dtype)
        out = unblock(full, *a.shape)
    return BlockMatrix(out, torch.as_tensor(out_mask, device=dev), bs,
                       a.scheme)


def d2d_sparse(a: BlockMatrix, b: BlockMatrix, left: Field, right: Field,
               merge: MergeFn) -> COOTensor:
    """COO group-join on the shared dimension (§4.4): sort both entry sets by
    the join key, emit the per-key cartesian products."""
    prof = analyze_merge(merge)
    ai, av, adense = _coo_of(a)
    bi, bv, bdense = _coo_of(b)
    if not prof.inducing_x:  # must consider all of A's cells
        ai = np.argwhere(np.ones_like(adense, bool))
        av = adense[tuple(ai.T)]
    if not prof.inducing_y:
        bi = np.argwhere(np.ones_like(bdense, bool))
        bv = bdense[tuple(bi.T)]
    akey = ai[:, 0] if left is Field.RID else ai[:, 1]
    aoth = ai[:, 1] if left is Field.RID else ai[:, 0]
    bkey = bi[:, 0] if right is Field.RID else bi[:, 1]
    both = bi[:, 1] if right is Field.RID else bi[:, 0]
    d1a = a.shape[0] if left is Field.RID else a.shape[1]
    d1b = b.shape[0] if right is Field.RID else b.shape[1]
    d1 = min(d1a, d1b)  # inner join on the key domain
    d2 = a.shape[1] if left is Field.RID else a.shape[0]
    d3 = b.shape[1] if right is Field.RID else b.shape[0]
    # group-by join key
    sa = np.argsort(akey, kind="stable")
    sb = np.argsort(bkey, kind="stable")
    akey, aoth, av = akey[sa], aoth[sa], av[sa]
    bkey, both, bv = bkey[sb], both[sb], bv[sb]
    a_starts = np.searchsorted(akey, np.arange(d1 + 1))
    b_starts = np.searchsorted(bkey, np.arange(d1 + 1))
    counts = (a_starts[1:] - a_starts[:-1]) * (b_starts[1:] - b_starts[:-1])
    total = int(counts.sum())
    if total == 0:
        return COOTensor(np.zeros((0, 3), np.int64),
                         np.zeros((0,), _out_dtype(adense, bdense)),
                         (d1, d2, d3))
    out_i = np.empty(total, np.int64)
    out_j = np.empty(total, np.int64)
    out_l = np.empty(total, np.int64)
    out_x = np.empty(total, av.dtype)
    out_y = np.empty(total, bv.dtype)
    pos = 0
    for key in np.nonzero(counts)[0]:
        a0, a1 = a_starts[key], a_starts[key + 1]
        b0, b1 = b_starts[key], b_starts[key + 1]
        na, nb = a1 - a0, b1 - b0
        k = na * nb
        out_i[pos:pos + k] = key
        out_j[pos:pos + k] = np.repeat(aoth[a0:a1], nb)
        out_l[pos:pos + k] = np.tile(both[b0:b1], na)
        out_x[pos:pos + k] = np.repeat(av[a0:a1], nb)
        out_y[pos:pos + k] = np.tile(bv[b0:b1], na)
        pos += k
    vals = _merge_host(merge.fn, out_x, out_y)
    keep = vals != 0
    idx = np.stack([out_i, out_j, out_l], axis=1)[keep]
    return COOTensor(idx, vals[keep], (d1, d2, d3))


def v2v_sparse(a: BlockMatrix, b: BlockMatrix, merge: MergeFn,
               use_bloom: bool = True,
               bloom_params: bloommod.BloomParams = bloommod.BloomParams(),
               kernel_backend: Optional[str] = None,
               strategy: Optional[str] = None) -> COOTensor:
    """Entry join with Bloom pre-filter + sort-merge on exact values (§4.5/§4.7).

    The Bloom filter is built over the (nonzero, if sparsity-inducing) entries
    of B; A's entries are probed and only survivors enter the exact join.
    ``strategy`` (``"bloom-sortmerge"`` / ``"sortmerge"``) overrides
    ``use_bloom`` — the physical planner passes its cost-gated choice here.
    """
    if strategy is not None:
        use_bloom = strategy == costmod.BLOOM_SORTMERGE
    prof = analyze_merge(merge)
    skip_zeros = prof.inducing_x or prof.inducing_y
    ai, av, adense = _coo_of(a)
    bi, bv, bdense = _coo_of(b)
    if not skip_zeros:
        ai = np.argwhere(np.ones_like(adense, bool))
        av = adense[tuple(ai.T)]
        bi = np.argwhere(np.ones_like(bdense, bool))
        bv = bdense[tuple(bi.T)]
    if use_bloom and av.size and bv.size:
        from repro_torch.kernels import registry
        dev = a.value.device
        filt = bloommod.build(torch.as_tensor(bv, device=dev), bloom_params,
                              skip_zeros=skip_zeros)
        hits = _host(registry.dispatch(
            "bloom_probe", filt, torch.as_tensor(av, device=dev),
            backend=kernel_backend,
            num_hashes=bloom_params.num_hashes,
            log2_bits=bloom_params.log2_bits))
        ai, av = ai[hits], av[hits]
    if av.size == 0 or bv.size == 0:
        return COOTensor(np.zeros((0, 4), np.int64),
                         np.zeros((0,), _out_dtype(adense, bdense)),
                         a.shape + b.shape)
    # exact sort-merge on float32-rounded keys (Bloom hashing is float32,
    # equality is evaluated exactly here)
    order_b = np.argsort(bv, kind="stable")
    bv_s, bi_s = bv[order_b], bi[order_b]
    lo = np.searchsorted(bv_s, av, side="left")
    hi = np.searchsorted(bv_s, av, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return COOTensor(np.zeros((0, 4), np.int64),
                         np.zeros((0,), _out_dtype(adense, bdense)),
                         a.shape + b.shape)
    rep_a = np.repeat(np.arange(av.size), counts)
    gather_b = np.concatenate(
        [np.arange(l, h) for l, h in zip(lo, hi) if h > l]) \
        if total else np.zeros((0,), np.int64)
    vals = _merge_host(merge.fn, av[rep_a], bv_s[gather_b])
    idx = np.concatenate([ai[rep_a], bi_s[gather_b]], axis=1)
    keep = vals != 0
    return COOTensor(idx[keep], vals[keep], a.shape + b.shape)


def d2v_sparse(a: BlockMatrix, b: BlockMatrix, dim: Field,
               merge: MergeFn) -> COOTensor:
    """γ = dim_A = val_B (§4.6): route matched B entries to A rows/cols."""
    prof = analyze_merge(merge)
    bi, bv, _ = _coo_of(b)
    m, n = a.shape
    limit = m if dim is Field.RID else n
    as_int = bv.astype(np.int64)
    valid = (bv == as_int) & (as_int >= 0) & (as_int < limit)
    bi, bv, keys = bi[valid], bv[valid], as_int[valid]
    host_a = _host(a.value)
    rows = []
    for (k_idx, key, bval) in zip(bi, keys, bv):
        line = host_a[key, :] if dim is Field.RID else host_a[:, key]
        # zero entries of A can only be skipped when f(0,·) ≡ 0
        nz = np.nonzero(line)[0] if prof.inducing_x \
            else np.arange(line.shape[0])
        if nz.size == 0:
            continue
        merged = _merge_host(merge.fn, line[nz], bval)
        live = merged != 0
        nz, merged = nz[live], merged[live]
        for o, v in zip(nz, merged):
            ij = (key, o) if dim is Field.RID else (o, key)
            rows.append((ij[0], ij[1], k_idx[0], k_idx[1], v))
    if not rows:
        return COOTensor(np.zeros((0, 4), np.int64),
                         np.zeros((0,), _out_dtype(host_a, _host(b.value))),
                         a.shape + b.shape)
    arr = np.array(rows)
    return COOTensor(arr[:, :4].astype(np.int64), arr[:, 4],
                     a.shape + b.shape)


def join_distributed(mesh, a: BlockMatrix, b: BlockMatrix, pred: JoinPred,
                     merge: MergeFn, plan=None):
    """Distributed entry point: one cost-model-sharded join per call.

    Routes through ``core.partitioner`` (schemes from §4.7, realized on
    the workers of the session mesh). This is the per-join path; the
    whole-plan SPMD staging in ``repro_torch.plan.executor`` keeps a
    multi-op query's intermediates on the workers between joins.
    """
    from repro_torch.core import partitioner as partmod
    k = pred.kind
    if k in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        return partmod.distributed_overlay(
            mesh, a, b, merge, transpose=(k is JoinKind.TRANSPOSE_OVERLAY),
            plan=plan)
    if k is JoinKind.D2D:
        return partmod.distributed_d2d(mesh, a, b, pred.left, pred.right,
                                       merge, plan=plan)
    raise NotImplementedError(
        f"per-call distributed execution not defined for {k}; "
        "use the whole-plan SPMD path (repro.plan)")


def join_sparse_device(a: BlockMatrix, b: BlockMatrix, pred: JoinPred,
                       merge: MergeFn, cap: Optional[int] = None,
                       use_bloom: bool = False,
                       kernel_backend: Optional[str] = None):
    """Per-call entry to the device-resident COO tier (§4.4–§4.6).

    Runs one join through ``repro.core.joins_device`` and converts the
    static-capacity buffers back to a host ``COOTensor`` — the eager
    counterpart of the whole-plan staged path (``repro.plan.executor``),
    used by the parity tests and benchmarks. ``cap`` defaults to the
    exact expansion count (one host scan); an explicit ``cap`` that turns
    out too small raises instead of silently truncating. Overlay joins
    have no COO form — use ``join_sparse`` (already block-skip + kernel
    based) for those.
    """
    from repro_torch.core import joins_device as jdev
    prof = analyze_merge(merge)
    if cap is None:
        cap = jdev.round_capacity(jdev.exact_capacity(
            _host(a.value), _host(b.value), pred, prof))
    av, bv = a.value, b.value
    k = pred.kind

    def _side(v, skip):
        c = int(torch.count_nonzero(v)) if skip else v.numel()
        return jdev.round_capacity(c)

    if k is JoinKind.CROSS:
        out = jdev.cross_device(av, bv, merge.fn, prof, cap,
                                cap_a=_side(av, prof.inducing_x),
                                cap_b=_side(bv, prof.inducing_y))
    elif k is JoinKind.D2D:
        out = jdev.d2d_device(av, bv, pred.left, pred.right, merge.fn,
                              prof, cap,
                              cap_a=_side(av, prof.inducing_x),
                              cap_b=_side(bv, prof.inducing_y),
                              kernel_backend=kernel_backend)
    elif k is JoinKind.V2V:
        skip = prof.inducing_x or prof.inducing_y
        out = jdev.v2v_device(av, bv, merge.fn, prof, cap,
                              cap_a=_side(av, skip), cap_b=_side(bv, skip),
                              use_bloom=use_bloom,
                              kernel_backend=kernel_backend)
    elif k is JoinKind.D2V:
        out = jdev.d2v_device(av, bv, pred.left, merge.fn, prof, cap,
                              cap_a=_side(av, prof.inducing_x))
    elif k is JoinKind.V2D:
        out = jdev.v2d_device(av, bv, pred.right, merge.fn, prof, cap,
                              cap_a=_side(bv, prof.inducing_y))
    else:
        raise ValueError(f"no device COO form for {k}")
    if jdev.overflowed(out):
        raise ValueError(
            f"device join capacity {cap} < required {int(out.total)}")
    if k is JoinKind.D2D:
        aa = a.shape if pred.left is Field.RID else a.shape[::-1]
        bb = b.shape if pred.right is Field.RID else b.shape[::-1]
        out_shape = (min(aa[0], bb[0]), aa[1], bb[1])
    else:
        out_shape = a.shape + b.shape
    return jdev.coo_to_host(out, out_shape)


def join_sparse(a: BlockMatrix, b: BlockMatrix, pred: JoinPred,
                merge: MergeFn, use_bloom: bool = True,
                kernel_backend: Optional[str] = None,
                strategy: Optional[str] = None):
    k = pred.kind
    if k is JoinKind.CROSS:
        return cross_sparse(a, b, merge)
    if k is JoinKind.DIRECT_OVERLAY:
        return overlay_sparse(a, b, merge, transpose=False,
                              kernel_backend=kernel_backend)
    if k is JoinKind.TRANSPOSE_OVERLAY:
        return overlay_sparse(a, b, merge, transpose=True,
                              kernel_backend=kernel_backend)
    if k is JoinKind.D2D:
        return d2d_sparse(a, b, pred.left, pred.right, merge)
    if k is JoinKind.V2V:
        return v2v_sparse(a, b, merge, use_bloom=use_bloom,
                          kernel_backend=kernel_backend, strategy=strategy)
    if k is JoinKind.D2V:
        return d2v_sparse(a, b, pred.left, merge)
    if k is JoinKind.V2D:
        t = d2v_sparse(b, a, pred.right,
                       MergeFn(f"flip_{merge.name}",
                               lambda x, y: merge.fn(y, x)))
        idx = t.idx[:, [2, 3, 0, 1]]
        return COOTensor(idx, t.val, a.shape + b.shape)
    raise ValueError(k)
