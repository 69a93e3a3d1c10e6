"""Device-resident COO join tier (paper §4.4–§4.6).

The host tier in ``repro_torch.core.joins`` materializes join outputs as
numpy COO sets — exact, nnz-proportional, but on the host: every sparse
join forces a device→host→device round trip. This module is the same
relational semantics as torch ops over **static-capacity buffers** on
the session's device, so a staged sparse plan keeps its joins on the
card.

The trick shared by every family is segment expansion over static
buffers: both entry sets compact row-major into nnz-bounded side buffers
(entries stay grouped by join key), each compacted entry of the probe
side owns one segment — its key's (or its match run's) whole partner
run — and the segments unroll into ``arange(capacity)`` slots via

    seg  = searchsorted(ends, t, right=True)     # clamped to the last id
    slot = t + (partner_run_base - segment_start)[seg]

followed by gathers of the pre-staged coordinate/value buffers (fused
into the ``coo_expand`` kernel for D2D and V2V). ``capacity`` is static —
chosen at plan time from the propagated nnz bounds
(``repro_torch.plan.masks``) — and the true ``total`` comes back with the
result so the executor can detect overflow and fall back to the host
oracle. Slots past ``total`` (and merge results equal to zero, matching
the host tier's post-merge filter) are masked out of ``valid``.

Every function returns a ``DeviceCOO``: ``idx [cap, order]`` (int16 when
every dimension fits, else int32), ``val [cap]``, ``valid [cap] bool``,
``total`` (0-d int32, the number of expansion slots actually needed).
``coo_to_host`` converts to the host ``COOTensor``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bloom as bloommod
from repro_torch.core.predicates import Field
from repro_torch.core.sparsity import SparsityProfile


class DeviceCOO(NamedTuple):
    """Static-capacity COO buffer."""

    idx: torch.Tensor     # [cap, order] int16/int32
    val: torch.Tensor     # [cap]
    valid: torch.Tensor   # [cap] bool — slot holds a live (nonzero) entry
    total: torch.Tensor   # 0-d int32 — expansion slots actually required


def coo_to_host(coo: DeviceCOO, shape: Tuple[int, ...]):
    """Materialize a ``DeviceCOO`` as the host tier's ``COOTensor``."""
    from repro_torch.core.joins import COOTensor, _host
    keep = coo.valid
    idx = coo.idx[keep].cpu().numpy().astype("int64")
    val = _host(coo.val[keep])
    return COOTensor(idx, val, shape)


def overflowed(coo: DeviceCOO) -> bool:
    """True when the static capacity was too small (results truncated)."""
    return int(coo.total) > int(coo.valid.shape[0])


# ---------------------------------------------------------------------------
# Shared machinery.
# ---------------------------------------------------------------------------

# sentinel total forcing the executor's overflow fallback when a SIDE
# buffer (not the expansion buffer) was too small for the actual entries
_OVERFLOW_TOTAL = 2 ** 30


def _expand_meta(counts: torch.Tensor, cap: int):
    """Per-segment prefix sums + the slot validity mask, without the
    expansion itself. Returns ``(ends, starts, valid, total)``."""
    counts = counts.to(torch.int32)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts           # exclusive prefix sum
    # int32 cumsum can wrap on a pathological total; a float32 shadow sum
    # (exact below 2²⁴ > any device capacity) catches that as an overflow
    over = torch.sum(counts, dtype=torch.float32) > float(cap)
    total = torch.where(over, _OVERFLOW_TOTAL, ends[-1])
    valid = torch.arange(cap, dtype=torch.int32, device=counts.device) < total
    return ends, starts, valid, total


def _segment_expand(counts: torch.Tensor, cap: int):
    """Expand variable-size segments into ``cap`` static slots.

    Returns ``(seg, starts, valid, total)``: for each slot ``t < total``
    the segment it falls in, plus the exclusive per-segment prefix sum.
    Slots past the total take the last segment id (masked by ``valid``).
    """
    counts = counts.to(torch.int32)
    ends, starts, valid, total = _expand_meta(counts, cap)
    t = torch.arange(cap, dtype=torch.int32, device=counts.device)
    seg = torch.searchsorted(ends, t, right=True) \
        .clamp_(max=counts.shape[0] - 1)
    return seg, starts, valid, total


def _entry_compact(live: torch.Tensor, cap: int):
    """Stable stream compaction of a boolean mask into ``cap`` slots.

    Returns ``(idx, count, slot_live)``: ``idx[s]`` is the flat
    (row-major) source index of the ``s``-th live element (slots ≥ count
    clamp to the last index and must stay masked). ``count > cap`` means
    entries were dropped — callers surface that through the overflow
    guard. Rank-2 ``live`` computes the prefix sum as row scans plus row
    offsets, like the JAX package.
    """
    if live.ndim == 2:
        inner = torch.cumsum(live, dim=1, dtype=torch.int32)
        row_tot = inner[:, -1]
        off = torch.cumsum(row_tot, 0, dtype=torch.int32) - row_tot
        pos = (inner + off[:, None]).reshape(-1)
    else:
        pos = torch.cumsum(live, 0, dtype=torch.int32)  # inclusive counts
    n = pos.shape[0]
    count = pos[-1]
    s = torch.arange(cap, dtype=torch.int32, device=live.device)
    idx = torch.searchsorted(pos, s + 1, side="left") \
        .clamp_(0, n - 1).to(torch.int32)
    return idx, count, s < count


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """Integer keys that order floats as ``jnp.sort``/``jnp.searchsorted``
    do: -0.0 equals +0.0, every NaN equals every other NaN and sorts after
    +inf. ``torch.searchsorted`` over floats treats NaN otherwise, so the
    V2V tier sorts and searches on these keys. NaN becomes one pattern and
    -0.0 becomes +0.0, the bits are read as a signed integer, and the
    non-sign bits of negatives are flipped (more negative, smaller key)."""
    itype = torch.int64 if v.dtype == torch.float64 else torch.int32
    v = v if itype is torch.int64 else v.float()
    v = torch.where(v == 0, 0.0, v)
    v = torch.where(torch.isnan(v), float("nan"), v)
    bits = v.view(itype)
    return torch.where(bits < 0, bits ^ torch.iinfo(itype).max, bits)


def _live(v: torch.Tensor, inducing: bool) -> torch.Tensor:
    return (v != 0) if inducing else torch.ones_like(v, dtype=torch.bool)


def round_capacity(c: float) -> int:
    """Canonical COO buffer rounding: floor 8, multiple-of-8 — shared by
    the planner's capacity annotation and the per-call join API so their
    staged-cache keys and buffer shapes can never desynchronize."""
    return max(8, -(-int(c) // 8) * 8)


def _coord_dtype(*dims: int):
    """Narrowest dtype for output coordinates: the idx buffers dominate
    the capacity-sized write traffic, so halving them when every
    dimension fits int16 matters (``coo_to_host`` widens to int64)."""
    return torch.int16 if max(dims) < (1 << 15) else torch.int32


def _finish(idx: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor,
            total: torch.Tensor) -> DeviceCOO:
    """Apply the post-merge zero filter. Slots outside ``valid`` keep
    whatever the clamped gathers produced — consumers mask by ``valid``."""
    return DeviceCOO(idx, vals, valid & (vals != 0), total.to(torch.int32))


def _or_overflow(flag: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return torch.where(flag, _OVERFLOW_TOTAL, total)


# ---------------------------------------------------------------------------
# Join families. All mirrors of the host implementations in core.joins —
# same entry sets, same post-merge filter — expressed over static buffers.
# ---------------------------------------------------------------------------

def d2d_device(a: torch.Tensor, b: torch.Tensor, left: Field, right: Field,
               merge: Callable, prof: SparsityProfile, cap: int, *,
               cap_a: Optional[int] = None,
               cap_b: Optional[int] = None,
               kernel_backend: Optional[str] = None) -> DeviceCOO:
    """Single-dimension join (§4.4) as segment-based gathers.

    Both entry sets compact (row-major, so entries stay grouped by join
    key) into static side buffers; per-key cartesian-product sizes expand
    through the fused ``coo_expand`` kernel. Output order 3:
    (key, other_A, other_B), D1-first layout.
    """
    from repro_torch.kernels import registry
    aa = a if left is Field.RID else a.T
    bb = b if right is Field.RID else b.T
    d1 = min(aa.shape[0], bb.shape[0])  # inner join on the key domain
    aa, bb = aa[:d1, :], bb[:d1, :]
    d2, d3 = aa.shape[1], bb.shape[1]
    cap_a = aa.numel() if cap_a is None else min(cap_a, aa.numel())
    cap_b = bb.numel() if cap_b is None else min(cap_b, bb.numel())
    live_a = _live(aa, prof.inducing_x)
    live_b = _live(bb, prof.inducing_y)
    idx_a, na, slot_a = _entry_compact(live_a, cap_a)
    idx_b, nb_n, _ = _entry_compact(live_b, cap_b)
    cnt_b = torch.sum(live_b, dim=1, dtype=torch.int32)   # entries per key
    b_starts = torch.cumsum(cnt_b, 0, dtype=torch.int32) - cnt_b
    # pre-gather coordinates and values into the compacted (nnz-sized)
    # buffers: the kernel's cap-sized expansion then reads from small,
    # cache-resident arrays instead of the full m·n matrices
    cdt = _coord_dtype(d1, d2, d3)
    key_a = torch.div(idx_a, d2, rounding_mode="floor")
    kc_a, cc_a = key_a.to(cdt), (idx_a % d2).to(cdt)
    col_b = (idx_b % d3).to(cdt)
    av_c = aa.reshape(-1)[idx_a]
    bv_c = bb.reshape(-1)[idx_b]
    # expand over A *entries* (not keys): each compacted A entry owns one
    # segment — its key's whole B run — so the per-slot index math needs
    # no variable-divisor div/mod; the emitted order still matches the
    # host tier (keys ascending, row-major within a key)
    counts = torch.where(slot_a, cnt_b[key_a], 0)
    ends, starts, valid, total = _expand_meta(counts, cap)
    delta = b_starts[key_a] - starts  # B-run base − own segment start
    idx, vals = registry.dispatch(
        "coo_expand", ends, delta, av_c,
        torch.stack([kc_a, cc_a], dim=1), bv_c,
        col_b[:, None].contiguous(), backend=kernel_backend, merge=merge,
        cap=cap)
    total = _or_overflow((na > cap_a) | (nb_n > cap_b), total)
    return _finish(idx, vals, valid, total)


def v2v_device(a: torch.Tensor, b: torch.Tensor, merge: Callable,
               prof: SparsityProfile, cap: int, *,
               cap_a: Optional[int] = None,
               cap_b: Optional[int] = None,
               use_bloom: bool = False,
               bloom_params: bloommod.BloomParams = bloommod.BloomParams(),
               kernel_backend: Optional[str] = None) -> DeviceCOO:
    """Entry join (§4.5): Bloom pre-filter + sort-merge, fully on device.

    Both entry sets first compact into static side buffers (``cap_a`` /
    ``cap_b``, plan-time nnz bounds), so the sort and the two
    ``searchsorted``s run over O(nnz) slots. Match runs then expand
    through the segment machinery. The Bloom probe only zeroes *counts*,
    so false positives cost expansion slots but never change the result.
    """
    from repro_torch.kernels import registry
    skip_zeros = prof.inducing_x or prof.inducing_y
    p, q = b.shape
    av, bv = a.reshape(-1), b.reshape(-1)
    cap_a = av.shape[0] if cap_a is None else min(cap_a, av.shape[0])
    cap_b = bv.shape[0] if cap_b is None else min(cap_b, bv.shape[0])
    idx_a, na, slot_a = _entry_compact(_live(a, skip_zeros), cap_a)
    idx_b, nb, slot_b = _entry_compact(_live(b, skip_zeros), cap_b)
    avc, bvc = av[idx_a], bv[idx_b]
    if use_bloom:
        # over B's compacted entries, not its m·n cells: with every live
        # cell in (nb <= cap_b) the live slots are the cells
        # bloom.build(bv, skip_zeros) inserts, so the bitset is the same
        # bit for bit; with nb > cap_b the join comes back overflowed
        filt = bloommod.build_live(bvc, slot_b, bloom_params)
        hits = registry.dispatch(
            "bloom_probe", filt, avc, backend=kernel_backend,
            num_hashes=bloom_params.num_hashes,
            log2_bits=bloom_params.log2_bits)
        slot_a = slot_a & hits
    sort_key = torch.where(slot_b, bvc, float("inf"))
    # sort and search on the reference's total order (see _order_key);
    # stable, as jnp.argsort: equal values keep their row-major order
    ikey = _order_key(sort_key)
    order_b = torch.argsort(ikey, stable=True).to(torch.int32)
    skey = sort_key[order_b].contiguous()
    ikey = ikey[order_b].contiguous()
    qkey = _order_key(avc)
    lo = torch.searchsorted(ikey, qkey, side="left").to(torch.int32)
    hi = torch.searchsorted(ikey, qkey, side="right").to(torch.int32)
    counts = torch.where(slot_a, hi - lo, 0)
    # pre-gather output coordinates (and values) into nnz-sized sorted
    # buffers so the fused expansion reads cache-resident arrays
    n = a.shape[1]
    cdt = _coord_dtype(a.shape[0], n, p, q)
    arow = torch.div(idx_a, n, rounding_mode="floor").to(cdt)
    acol = (idx_a % n).to(cdt)
    bsorted = idx_b[order_b]
    brow = torch.div(bsorted, q, rounding_mode="floor").to(cdt)
    bcol = (bsorted % q).to(cdt)
    ends, starts, valid, total = _expand_meta(counts, cap)
    delta = lo - starts               # match-run base − own segment start
    # skey IS the matched B value buffer (exact equality join), so only
    # the A side needs a separate value buffer
    idx, vals = registry.dispatch(
        "coo_expand", ends, delta, avc, torch.stack([arow, acol], dim=1),
        skey, torch.stack([brow, bcol], dim=1), backend=kernel_backend,
        merge=merge, cap=cap)
    total = _or_overflow((na > cap_a) | (nb > cap_b), total)
    return _finish(idx, vals, valid, total)


def cross_device(a: torch.Tensor, b: torch.Tensor, merge: Callable,
                 prof: SparsityProfile, cap: int, *,
                 cap_a: Optional[int] = None,
                 cap_b: Optional[int] = None) -> DeviceCOO:
    """Cross product (§4.2): all pairs over the compacted entry sets."""
    n, q = a.shape[1], b.shape[1]
    av, bv = a.reshape(-1), b.reshape(-1)
    cap_a = av.shape[0] if cap_a is None else min(cap_a, av.shape[0])
    cap_b = bv.shape[0] if cap_b is None else min(cap_b, bv.shape[0])
    idx_a, na, _ = _entry_compact(_live(a, prof.inducing_x), cap_a)
    idx_b, nb, _ = _entry_compact(_live(b, prof.inducing_y), cap_b)
    # na·nb can wrap int32 for large entry sets; the float32 shadow
    # product (cap ≤ 2²³, well inside f32 exactness) guards the compare
    over = na.to(torch.float32) * nb.to(torch.float32) > float(cap)
    total = torch.where(over, _OVERFLOW_TOTAL, na * nb)
    t = torch.arange(cap, dtype=torch.int32, device=a.device)
    nb1 = torch.clamp(nb, min=1)
    ia = idx_a[torch.div(t, nb1, rounding_mode="floor").clamp_(0, cap_a - 1)]
    ib = idx_b[(t % nb1).clamp_(0, cap_b - 1)]
    vals = merge(av[ia], bv[ib])
    cdt = _coord_dtype(a.shape[0], n, b.shape[0], q)
    idx = torch.stack([torch.div(ia, n, rounding_mode="floor").to(cdt),
                       (ia % n).to(cdt),
                       torch.div(ib, q, rounding_mode="floor").to(cdt),
                       (ib % q).to(cdt)], dim=1)
    total = _or_overflow((na > cap_a) | (nb > cap_b), total)
    return _finish(idx, vals, t < torch.clamp(total, max=cap), total)


def d2v_device(a: torch.Tensor, b: torch.Tensor, dim: Field, merge: Callable,
               prof: SparsityProfile, cap: int, *,
               cap_a: Optional[int] = None) -> DeviceCOO:
    """Dimension-entry join (§4.6): γ = dim_A = val_B.

    Every B entry whose value is an integral index in range routes to one
    row (or column) of A; the per-entry segment is that line's live cells
    (found through the same row-major entry compaction as D2D).
    """
    q = b.shape[1]
    aa = a if dim is Field.RID else a.T
    limit, d2 = aa.shape
    cap_a = aa.numel() if cap_a is None else min(cap_a, aa.numel())
    bv = b.reshape(-1)
    as_int = bv.to(torch.int32)
    # zero B entries are NULL and never join (even though 0 is a valid
    # dimension index) — matching the host tier's nonzero entry set
    valid_b = (bv != 0) & (bv == as_int.to(bv.dtype)) \
        & (as_int >= 0) & (as_int < limit)
    bkey = torch.clamp(as_int, 0, limit - 1).to(torch.int64)
    live_a = _live(aa, prof.inducing_x)
    fa_all = aa.reshape(-1)
    idx_a, na, _ = _entry_compact(live_a, cap_a)
    cnt_a = torch.sum(live_a, dim=1, dtype=torch.int32)
    a_starts = torch.cumsum(cnt_a, 0, dtype=torch.int32) - cnt_a
    counts = torch.where(valid_b, cnt_a[bkey], 0)
    e, starts, valid, total = _segment_expand(counts, cap)
    key = bkey[e]
    delta = a_starts[bkey] - starts   # A-run base − own segment start
    t = torch.arange(cap, dtype=torch.int64, device=a.device)
    fa = idx_a[(t + delta[e]).clamp_(0, cap_a - 1)].to(torch.int64)
    col = fa % d2
    vals = merge(fa_all[fa], bv[e])
    i, j = (key, col) if dim is Field.RID else (col, key)
    cdt = _coord_dtype(limit, d2, b.shape[0], q)
    idx = torch.stack([i.to(cdt), j.to(cdt),
                       torch.div(e, q, rounding_mode="floor").to(cdt),
                       (e % q).to(cdt)], dim=1)
    total = _or_overflow(na > cap_a, total)
    return _finish(idx, vals, valid, total)


def v2d_device(a: torch.Tensor, b: torch.Tensor, dim: Field, merge: Callable,
               prof: SparsityProfile, cap: int, *,
               cap_a: Optional[int] = None) -> DeviceCOO:
    """val_A = dim_B: the D2V mirror with roles (and index blocks) swapped.
    ``cap_a`` sizes the compaction of B — the line-matrix side here."""
    flipped = SparsityProfile(inducing_x=prof.inducing_y,
                              inducing_y=prof.inducing_x)
    t = d2v_device(b, a, dim, lambda x, y: merge(y, x), flipped, cap,
                   cap_a=cap_a)
    return DeviceCOO(t.idx[:, [2, 3, 0, 1]], t.val, t.valid, t.total)


# ---------------------------------------------------------------------------
# Host-side capacity planning (used by repro_torch.plan.masks for leaf
# joins and by direct callers sizing a one-off device join).
# ---------------------------------------------------------------------------

def exact_capacity(a, b, pred, prof: SparsityProfile) -> int:
    """Exact expansion-slot count of a COO join — one O(nnz log nnz)
    host scan over the input entry sets (numpy arrays)."""
    import numpy as np

    from repro_torch.core.predicates import JoinKind
    a = np.asarray(a)
    b = np.asarray(b)
    kind = pred.kind
    if kind is JoinKind.CROSS:
        na = np.count_nonzero(a) if prof.inducing_x else a.size
        nb = np.count_nonzero(b) if prof.inducing_y else b.size
        return int(na) * int(nb)
    if kind is JoinKind.D2D:
        aa = a if pred.left is Field.RID else a.T
        bb = b if pred.right is Field.RID else b.T
        d1 = min(aa.shape[0], bb.shape[0])
        ca = np.count_nonzero(aa[:d1], axis=1) if prof.inducing_x \
            else np.full(d1, aa.shape[1], np.int64)
        cb = np.count_nonzero(bb[:d1], axis=1) if prof.inducing_y \
            else np.full(d1, bb.shape[1], np.int64)
        return int((ca.astype(np.int64) * cb).sum())
    if kind is JoinKind.V2V:
        skip = prof.inducing_x or prof.inducing_y
        av, bv = a.reshape(-1), b.reshape(-1)
        if skip:
            av, bv = av[av != 0], bv[bv != 0]
        bv = np.sort(bv)
        lo = np.searchsorted(bv, av, side="left")
        hi = np.searchsorted(bv, av, side="right")
        return int((hi - lo).sum())
    if kind in (JoinKind.D2V, JoinKind.V2D):
        if kind is JoinKind.V2D:  # mirror: roles swap, profile flips
            a, b = b, a
            prof = SparsityProfile(prof.inducing_y, prof.inducing_x)
            dim = pred.right
        else:
            dim = pred.left
        aa = a if dim is Field.RID else a.T
        bv = b.reshape(-1)
        as_int = bv.astype(np.int64)
        valid = (bv != 0) & (bv == as_int) & (as_int >= 0) \
            & (as_int < aa.shape[0])
        keys = as_int[valid]
        cnt = np.count_nonzero(aa, axis=1) if prof.inducing_x \
            else np.full(aa.shape[0], aa.shape[1], np.int64)
        return int(cnt[keys].sum())
    raise ValueError(kind)
