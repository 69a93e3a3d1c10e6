"""Worker shards and the collectives between them.

The JAX package runs a multi-worker plan as one GSPMD program: node
outputs are pinned to their partitioning schemes and XLA inserts the
collectives. PyTorch has no such partitioner, so the port realizes the
schemes itself, over the workers of a mesh (``core.partitioner``), each
on its device: one worker a card, or logical workers sharing a card:

* a ``Sharded`` value holds one tensor a worker, each in its own storage
  on that worker's device; ``dim`` is the split dimension (``None``:
  every worker holds a replica) and ``bounds`` the global extent of each
  worker's slice;
* Row splits dim 0 and Column dim 1, in the chunks XLA uses (``ceil(d /
  N)`` a worker, the last ones short or empty); Broadcast is N replicas;
  ξ is Row; order-3/4 outputs split their leading dimension;
* a collective is an explicit copy between workers' shards
  (``redistribute``, ``gather``), a copy from card to card where the
  workers sit on two, and ``reduce`` combines per-worker partials on
  worker 0's device and replicates the result onto every worker's.

Every collective counts the bytes it moves between *different* workers
into the active ``recording()`` contexts: network-wide wire bytes, the
convention of the JAX package's ``core.partitioner._FLEET_SCALE``. A
reshard of a column-split 512² float32 matrix to rows at N = 8 counts
(N−1)/N·|B|·4 bytes (all-to-all), gathering it everywhere (N−1)·|B|·4
(all-gather), slicing a replica nothing. A reduction counts its output
once (``reduce``): the scheme pass's convention for aggregations (a ring
all-reduce would move 2(N−1) times that).

One process drives every worker (the JAX package's single controller):
it enqueues each worker's work on that worker's card in turn, so the
cards run side by side, and a copy between cards is ordered after the
work on both (PyTorch's peer copies synchronize the two cards' current
streams). Logical workers on one card run one after another on its
default stream, and their copies stay on the card: the byte counts
carry over to a cluster, the times do not.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.cost import BCAST, COL, RANDOM, ROW

Bounds = Tuple[Tuple[int, int], ...]
# the workers a value is placed on: their devices, or a count of workers
# on the tensor's own device
Workers = Union[int, Sequence[torch.device]]


def xla_bounds(size: int, n: int) -> Bounds:
    """Global ``[lo, hi)`` of each of ``n`` workers' chunks of ``size``:
    ``ceil(size / n)`` each, as XLA tiles a dimension (the trailing
    chunks short or empty; XLA pads them, the shards here are not)."""
    chunk = -(-size // n)
    return tuple((min(i * chunk, size), min((i + 1) * chunk, size))
                 for i in range(n))


def scheme_dim(scheme: str, ndim: int = 2) -> Optional[int]:
    """Split dimension of ``scheme`` at rank ``ndim`` (None: replicated).
    Row and ξ split dim 0 at any rank; Column only exists for matrices."""
    if scheme in (ROW, RANDOM):
        return 0
    if scheme == COL:
        if ndim != 2:
            raise ValueError(f"column scheme undefined at ndim={ndim}")
        return 1
    if scheme == BCAST:
        return None
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# Counting.
# ---------------------------------------------------------------------------

class ByteRecorder:
    """Collective traffic of one recorded region. ``total`` is network-wide
    wire bytes; ``per_worker`` the operand bytes worker 0's program hands
    its collectives (the per-device figure an HLO dump lists);
    ``by_family`` splits ``total`` by collective."""

    def __init__(self):
        self.total = 0
        self.per_worker = 0
        self.by_family: Dict[str, int] = {}

    def add(self, family: str, nbytes: int, operand: int) -> None:
        self.total += nbytes
        self.per_worker += operand
        self.by_family[family] = self.by_family.get(family, 0) + nbytes


_LOCAL = threading.local()


def _recorders() -> List[ByteRecorder]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def recording():
    """Count the collectives this thread runs inside the block (nested
    regions each see their own)."""
    rec = ByteRecorder()
    stack = _recorders()
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def _count(family: str, nbytes: int, operand: int) -> None:
    for rec in _recorders():
        rec.add(family, int(nbytes), int(operand))


# ---------------------------------------------------------------------------
# Sharded values.
# ---------------------------------------------------------------------------

def _own(t: torch.Tensor, device: Optional[torch.device] = None
         ) -> torch.Tensor:
    """A contiguous copy in fresh storage on ``device`` (None: ``t``'s):
    a piece that stays on its device is copied too, never aliased."""
    return t.to(t.device if device is None else device, copy=True,
                memory_format=torch.contiguous_format)


def _join_on(pieces: Sequence[torch.Tensor], dim: int,
             device: torch.device) -> torch.Tensor:
    """``pieces`` concatenated along ``dim`` in fresh storage on
    ``device``: one ``torch.cat`` where they all are on it, else each
    piece copied into its place (one copy from card to card a piece)."""
    if len(pieces) == 1:
        return _own(pieces[0], device)
    if all(p.device == device for p in pieces):
        return _contig(torch.cat(pieces, dim=dim))
    shape = list(pieces[0].shape)
    shape[dim] = sum(p.shape[dim] for p in pieces)
    out = torch.empty(shape, dtype=pieces[0].dtype, device=device)
    off = 0
    for p in pieces:
        out.narrow(dim, off, p.shape[dim]).copy_(p)
        off += p.shape[dim]
    return out


def _devices(workers: Workers, t: torch.Tensor) -> Tuple[torch.device, ...]:
    if isinstance(workers, int):
        return (t.device,) * workers
    return tuple(workers)


def _to(x, device: torch.device):
    """A tensor, or a tuple of them, on ``device`` (no copy where it is)."""
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.to(device)


def _contig(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


class Sharded:
    """One value over N workers: ``shards[i]`` is worker i's tensor."""

    __slots__ = ("shards", "dim", "bounds", "shape")

    def __init__(self, shards: Sequence[torch.Tensor], dim: Optional[int],
                 bounds: Optional[Bounds], shape: Tuple[int, ...]):
        self.shards = list(shards)
        self.dim = dim
        self.bounds = None if dim is None else tuple(bounds)
        self.shape = tuple(shape)

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    def block_aligned(self, bs: int) -> bool:
        """Whether every worker's slice starts and ends on a block edge
        (the matrix's end counts as one)."""
        if self.dim is None:
            return True
        end = self.shape[self.dim]
        return all(lo % bs == 0 and (hi % bs == 0 or hi == end)
                   for lo, hi in self.bounds)

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """Worker-local op over operands of one layout; keeps the layout."""
        shards = [_contig(fn(s, *(o.shards[i] for o in others)))
                  for i, s in enumerate(self.shards)]
        shape = list(shards[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(s.shape[self.dim] for s in shards)
        return Sharded(shards, self.dim, self.bounds, shape)


def place(t: torch.Tensor, scheme: str, workers: Workers) -> Sharded:
    """Hand each worker its part of ``t`` in ``scheme``'s layout, on its
    device. This is a leaf entering the program (host→device placement
    in the JAX package's staged call), not a collective: nothing is
    counted."""
    dim = scheme_dim(scheme, t.ndim)
    return split(t, dim, workers)


def split(t: torch.Tensor, dim: Optional[int], workers: Workers) -> Sharded:
    """Uncounted: ``t`` is already every worker's (a replicated result).
    ``workers`` is the workers' devices, or a count of workers on ``t``'s
    device."""
    devs = _devices(workers, t)
    if dim is None:
        return Sharded([_own(t, d) for d in devs], None, None, t.shape)
    bounds = xla_bounds(t.shape[dim], len(devs))
    shards = [_own(t.narrow(dim, lo, hi - lo), d)
              for (lo, hi), d in zip(bounds, devs)]
    return Sharded(shards, dim, bounds, t.shape)


def replicated(shards: Sequence[torch.Tensor]) -> Sharded:
    return Sharded(shards, None, None, shards[0].shape)


def _empty_like_slice(x: Sharded, dim: int, size: int,
                      j: int) -> torch.Tensor:
    """An empty slice of ``x`` for worker j, on its device."""
    shape = list(x.shape)
    shape[dim] = size
    return torch.empty(shape, dtype=x.shards[0].dtype,
                       device=x.shards[j].device)


def _piece(x: Sharded, i: int, dim: Optional[int],
           rng: Optional[Tuple[int, int]]) -> Optional[torch.Tensor]:
    """The part of worker i's shard that a target slice ``rng`` of
    ``dim`` needs (None: nothing)."""
    s = x.shards[i]
    if dim is None:
        return s
    lo, hi = rng
    if dim == x.dim:
        slo, shi = x.bounds[i]
        a, b = max(lo, slo), min(hi, shi)
        if a >= b:
            return None
        return s.narrow(dim, a - slo, b - a)
    return s.narrow(dim, lo, hi - lo)


def redistribute(x: Sharded, dim: Optional[int],
                 bounds: Optional[Bounds] = None) -> Sharded:
    """``x`` in another layout, every worker assembling its target slice
    from the shards that hold it; bytes taken from another worker are
    counted. From a replica the slice is local and free. Each target
    slice is assembled on its worker's device: a piece from a worker on
    another card is copied from card to card, one on the same device
    copied within it."""
    if dim is not None and bounds is None:
        bounds = xla_bounds(x.shape[dim], x.n)
    if x.dim == dim and (dim is None or x.bounds == tuple(bounds)):
        return x
    n = x.n
    if x.dim is None:
        shards = [_contig(x.shards[j].narrow(dim, lo, hi - lo))
                  for j, (lo, hi) in enumerate(bounds)]
        return Sharded(shards, dim, bounds, x.shape)
    family = ("all-gather" if dim is None else
              "collective-permute" if dim == x.dim else "all-to-all")
    shards, moved, sent0 = [], 0, 0
    for j in range(n):
        rng = None if dim is None else bounds[j]
        pieces = []
        for i in range(n):
            p = _piece(x, i, dim, rng)
            if p is None:
                continue
            if i != j:
                nbytes = p.numel() * p.element_size()
                moved += nbytes
                sent0 += nbytes if i == 0 else 0
            pieces.append(p)
        if pieces:
            shards.append(_join_on(pieces, x.dim, x.shards[j].device))
        else:
            shards.append(_empty_like_slice(x, dim, rng[1] - rng[0], j))
    s0 = x.shards[0]
    operand = sent0 if family == "collective-permute" \
        else s0.numel() * s0.element_size()
    _count(family, moved, operand)
    return Sharded(shards, dim, bounds, x.shape)


def gather(x: Sharded, to: int = 0) -> torch.Tensor:
    """The whole value on worker ``to``'s device (the other workers'
    shards are sent to it and counted)."""
    if x.dim is None:
        return x.shards[to]
    moved = sum(s.numel() * s.element_size()
                for i, s in enumerate(x.shards) if i != to)
    s0 = x.shards[0]
    _count("gather", moved, 0 if to == 0 else s0.numel() * s0.element_size())
    return _join_on(x.shards, x.dim, x.shards[to].device)


def assemble(x: Sharded, device: Optional[torch.device] = None
             ) -> torch.Tensor:
    """The value handed back to the caller on ``device`` (None: worker
    0's), a staged program's output leaving the workers, as the JAX
    package's jit output: not counted."""
    device = x.shards[0].device if device is None else device
    if x.dim is None:
        return x.shards[0].to(device)
    return _join_on(x.shards, x.dim, device)


def reduce(partials: Sequence,
           combine: Callable[[Sequence], torch.Tensor],
           workers: Workers) -> Sharded:
    """One output-sized collective: the workers' partials (tensors, or
    tuples of them) brought to worker 0's device and combined there, and
    the result replicated onto every worker's device (``workers``: their
    devices, or a count of workers on the first partial's). Counts the
    output once (see the module doc)."""
    if isinstance(workers, int):
        lead = partials[0]
        workers = _devices(workers,
                           lead[0] if isinstance(lead, tuple) else lead)
    devs = tuple(workers)
    out = combine([_to(p, devs[0]) for p in partials])
    nbytes = out.numel() * out.element_size()
    _count("reduce", nbytes, nbytes)
    return split(out, None, devs)


def consume(x: Sharded, scheme: str) -> Sharded:
    """``x`` as a consumer that expects ``scheme`` takes it: unchanged when
    it is already split on the scheme's dimension, else resharded to the
    scheme's chunks."""
    dim = scheme_dim(scheme, x.ndim)
    if x.dim == dim:
        return x
    return redistribute(x, dim)


def transpose(x: Sharded) -> Sharded:
    """Row ↔ Column locally: a worker's rows of A are its columns of Aᵀ."""
    dim = {0: 1, 1: 0}.get(x.dim) if x.dim is not None else None
    shards = [s.T.contiguous() for s in x.shards]
    return Sharded(shards, dim, x.bounds, x.shape[::-1])


def align(x: Sharded, like: Sharded) -> Sharded:
    """``x`` in ``like``'s layout (elementwise operands)."""
    return redistribute(x, like.dim, like.bounds)


def block_slice(mask, x: Sharded, i: int, bs: int):
    """Worker i's part of a plan-time block mask over ``x``'s layout (its
    slice must be block-aligned, ``Sharded.block_aligned``)."""
    if x.dim is None:
        return mask
    lo, hi = x.bounds[i]
    sl = slice(lo // bs, -(-hi // bs))
    return mask[sl, :] if x.dim == 0 else mask[:, sl]


# ---------------------------------------------------------------------------
# Operators on sharded values: each worker computes on its own shards, a
# collective first where the operands' layouts require one.
# ---------------------------------------------------------------------------

def _clip(bounds: Bounds, size: int) -> Bounds:
    return tuple((min(lo, size), min(hi, size)) for lo, hi in bounds)


def _span(x: Sharded, i: int, lo: int, hi: int) -> torch.Tensor:
    """Global rows [lo, hi) of ``x`` from worker i's own tensor."""
    s = x.shards[i]
    off = 0 if x.dim is None else x.bounds[i][0]
    return s.narrow(0, lo - off, hi - lo)


def elementwise(fn: Callable, a: Sharded, b: Sharded) -> Sharded:
    """Aligned operands (the scheme pass consumes both in one scheme)."""
    if a.dim is None and b.dim is not None:
        a = align(a, b)
    else:
        b = align(b, a)
    return a.map(fn, b)


def matmul(a: Sharded, b: Sharded) -> Sharded:
    """1-D algebra: (r, b) → r, (b, c) → c, (b, b) → b; any other pair
    gathers an operand first."""
    if a.dim == 0:
        b = redistribute(b, None)
    elif b.dim == 1:
        a = redistribute(a, None)
    else:
        a, b = redistribute(a, None), redistribute(b, None)
    shards = [torch.matmul(x, y) for x, y in zip(a.shards, b.shards)]
    shape = (a.shape[0], b.shape[1])
    if a.dim == 0:
        return Sharded(shards, 0, a.bounds, shape)
    if b.dim == 1:
        return Sharded(shards, 1, b.bounds, shape)
    return replicated(shards)


def _select_range(pred, field, size: int) -> Tuple[int, int]:
    """``select_dense``'s slice of one dimension as global [lo, hi)."""
    r = pred.dim_range(field)
    if r is None:
        return 0, size
    lo = min(max(r[0] if r[0] is not None else 0, 0), size)
    hi = min(r[1] if r[1] is not None else size - 1, size - 1)
    return lo, max(lo, hi + 1)


def _val_atoms(v: torch.Tensor, pred) -> torch.Tensor:
    from repro_torch.core.executor import _CMP
    for a in pred.val_atoms():
        v = torch.where(_CMP[a.op](v, a.rhs), v, 0.0)
    return v


def select(x: Sharded, pred) -> Sharded:
    """``select_dense`` on each worker's slice, with the slice's global
    offsets: a range keeps each worker's part of it, the diagonal its
    diagonal entries (a vector split on rows)."""
    from repro_torch.core.executor import select_dense
    from repro_torch.core.predicates import Field
    if pred.special is not None:
        raise ValueError("data-dependent selections do not run sharded")
    if x.dim is None:
        return x.map(lambda s: select_dense(s, pred))
    m, n = x.shape
    shards, bounds = [], []
    if pred.is_diagonal():
        d = min(m, n)
        for s, (lo, hi) in zip(x.shards, x.bounds):
            a, b = min(lo, d), min(hi, d)
            idx = torch.arange(a, b, device=s.device)
            v = s[idx - lo, idx] if x.dim == 0 else s[idx, idx - lo]
            shards.append(_contig(_val_atoms(v[:, None], pred)))
            bounds.append((a, b))
        return Sharded(shards, 0, bounds, (d, 1))
    spans = (_select_range(pred, Field.RID, m),
             _select_range(pred, Field.CID, n))
    glo, ghi = spans[x.dim]
    olo, ohi = spans[1 - x.dim]
    for s, (lo, hi) in zip(x.shards, x.bounds):
        a = max(lo, glo)
        b = max(a, min(hi, ghi))
        v = s.narrow(x.dim, a - lo, b - a) if b > a \
            else s.narrow(x.dim, 0, 0)
        v = v.narrow(1 - x.dim, olo, ohi - olo)
        shards.append(_contig(_val_atoms(v, pred)))
        bounds.append((min(a, ghi) - glo, min(b, ghi) - glo))
    shape = [ghi - glo, ghi - glo]
    shape[1 - x.dim] = ohi - olo
    return Sharded(shards, x.dim, bounds, tuple(shape))


def _agg_stats(v: torch.Tensor, axis: int, fn) -> Tuple[torch.Tensor, ...]:
    """Per-worker statistics that combine into ``agg_dense``'s result."""
    from repro_torch.core.expr import AggFn
    present = v != 0
    if fn is AggFn.SUM:
        return (torch.sum(v, dim=axis),)
    if fn is AggFn.NNZ:
        return (torch.sum(present, dim=axis),)
    if fn is AggFn.AVG:
        return (torch.sum(v, dim=axis), torch.sum(present, dim=axis))
    if fn is AggFn.MAX:
        return (torch.amax(torch.where(present, v, -torch.inf), dim=axis),)
    if fn is AggFn.MIN:
        return (torch.amin(torch.where(present, v, torch.inf), dim=axis),)
    raise ValueError(fn)


def _agg_combine(stats, fn, length: int, like: torch.Tensor):
    """Worker-ordered combination of ``_agg_stats`` into the aggregate."""
    from repro_torch.core.expr import AggFn
    dt, dev = like.dtype, like.device
    if fn in (AggFn.MAX, AggFn.MIN):
        big = -torch.inf if fn is AggFn.MAX else torch.inf
        out = torch.full((length,), big, dtype=dt, device=dev)
        pick = torch.maximum if fn is AggFn.MAX else torch.minimum
        for (s,) in stats:
            out = pick(out, s)
        return torch.where(torch.isfinite(out), out, 0.0)
    total = torch.zeros(length, dtype=dt, device=dev)
    count = torch.zeros(length, dtype=torch.int64, device=dev)
    for st in stats:
        if fn is AggFn.NNZ:
            count = count + st[0]
        else:
            total = total + st[0]
            if fn is AggFn.AVG:
                count = count + st[1]
    if fn is AggFn.SUM:
        return total
    if fn is AggFn.NNZ:
        return count.to(dt)
    return total / torch.clamp(count, min=1)


def agg(x: Sharded, fn, dim) -> Sharded:
    """``agg_dense`` over a sharded matrix; the output is replicated.

    Where the aggregate keeps the split (row aggregates of a row split)
    each worker's slice of it is exact and the collective gathers the
    vector; otherwise each worker reduces its slice to statistics
    (sum, count, extremum) and the collective combines them in worker
    order. Either is one output-sized collective (``reduce``)."""
    from repro_torch.core.executor import agg_dense
    from repro_torch.core.expr import AggDim
    if x.dim is None:
        return x.map(lambda s: agg_dense(s, fn, dim))
    if {AggDim.ROW: 0, AggDim.COL: 1}.get(dim) == x.dim:
        parts = [agg_dense(s, fn, dim) for s in x.shards]
        return reduce(parts, lambda p: torch.cat(p, dim=x.dim), x.devices)
    m, n = x.shape
    stats = []
    for s, (lo, hi) in zip(x.shards, x.bounds):
        if dim is AggDim.DIAG:
            d = min(m, n)
            idx = torch.arange(min(lo, d), min(hi, d), device=s.device)
            v = (s[idx - lo, idx] if x.dim == 0 else s[idx, idx - lo])[None]
            axis = 1
        elif dim is AggDim.ALL:
            v, axis = s.reshape(1, -1), 1
        else:
            v, axis = s, (1 if dim is AggDim.ROW else 0)
        if v.shape[axis]:
            stats.append(_agg_stats(v, axis, fn))
    length = m if dim is AggDim.ROW else n if dim is AggDim.COL else 1
    ref = x.shards[0]

    def combine(parts):
        out = _agg_combine(parts, fn, length, ref)
        return out[:, None] if dim is AggDim.ROW else out[None, :]
    return reduce(stats, combine, x.devices)


# -- joins ------------------------------------------------------------------

def overlay(a: Sharded, b: Sharded, f: Callable,
            transpose_b: bool = False) -> Sharded:
    """Direct overlay f(A, B), or f(A, Bᵀ): Bᵀ is B's shards transposed
    (a row split of B is a column split of Bᵀ); B then moves to A's
    layout (free from a replica; an all-to-all from the other split,
    (N−1)/N·|B|, §4.7's mismatched pair)."""
    if transpose_b:
        b = transpose(b)
    return elementwise(f, a, b)


def d2d(a: Sharded, b: Sharded, left, right, f: Callable,
        size_a: float, size_b: float) -> Sharded:
    """D2D join (``d2d_dense``'s D1-first layout) by paper Table 1: both
    sides split on the joined dimension join locally; one side split off
    it is either re-slotted ((N−1)/N of it) or the other side broadcast
    ((N−1)·|other|), whichever the model prices lower (``size_a`` and
    ``size_b`` are its |A|, |B|); two such sides broadcast the smaller.
    The output is split on the key where a side is, else on the other
    side's split dimension (2 for B's, 1 for A's)."""
    from repro_torch.core.predicates import Field
    aa = a if left is Field.RID else transpose(a)
    bb = b if right is Field.RID else transpose(b)
    n = aa.n
    if aa.dim is not None and bb.dim is not None:
        if aa.dim == 0 and bb.dim != 0:
            if (n - 1) * size_a < (n - 1) / n * size_b:
                aa = redistribute(aa, None)
            else:
                bb = redistribute(bb, 0, _clip(aa.bounds, bb.shape[0]))
        elif bb.dim == 0 and aa.dim != 0:
            if (n - 1) * size_b < (n - 1) / n * size_a:
                bb = redistribute(bb, None)
            else:
                aa = redistribute(aa, 0, _clip(bb.bounds, aa.shape[0]))
        elif aa.dim != 0:
            if size_a <= size_b:
                aa = redistribute(aa, None)
            else:
                bb = redistribute(bb, None)
    d1 = min(aa.shape[0], bb.shape[0])
    shape = (d1, aa.shape[1], bb.shape[1])
    if aa.dim == 0 or bb.dim == 0:
        key = aa if aa.dim == 0 else bb
        if aa.dim == 0 and bb.dim == 0:
            bb = redistribute(bb, 0, _clip(aa.bounds, bb.shape[0]))
        bounds = _clip(key.bounds, d1)
        shards = [_contig(f(_span(aa, i, lo, hi)[:, :, None],
                            _span(bb, i, lo, hi)[:, None, :]))
                  for i, (lo, hi) in enumerate(bounds)]
        return Sharded(shards, 0, bounds, shape)
    shards = [_contig(f(x[:d1, :, None], y[:d1, None, :]))
              for x, y in zip(aa.shards, bb.shards)]
    if aa.dim is None and bb.dim is None:
        return replicated(shards)
    if aa.dim is None:
        return Sharded(shards, 2, bb.bounds, shape)
    return Sharded(shards, 1, aa.bounds, shape)


def _outer(a: Sharded, b: Sharded, fn: Callable, a_key_axis=None):
    """An order-4 join evaluated over (A slice, B replica) or (A replica,
    B slice) pairs; ``a_key_axis`` names A's axis whose *global* index
    ``fn`` reads (D2V), passed as ``fn(x, y, offset)``."""
    shape = tuple(a.shape) + tuple(b.shape)
    shards = []
    for i, (x, y) in enumerate(zip(a.shards, b.shards)):
        off = a.bounds[i][0] if a.dim is not None and a.dim == a_key_axis \
            else 0
        shards.append(_contig(fn(x, y, off)))
    if a.dim is None and b.dim is None:
        return replicated(shards)
    if a.dim is not None:
        return Sharded(shards, a.dim, a.bounds, shape)
    return Sharded(shards, 2 + b.dim, b.bounds, shape)


def _d2v_local(a, b, dim, f, off):
    """``d2v_dense`` with A's key index starting at ``off``."""
    from repro_torch.core.predicates import Field
    size = a.shape[0] if dim is Field.RID else a.shape[1]
    keys = torch.arange(off, off + size, dtype=a.dtype, device=a.device)
    d = keys[:, None, None, None] if dim is Field.RID \
        else keys[None, :, None, None]
    eq = (b[None, None, :, :] == d) & (b != 0)[None, None, :, :]
    return torch.where(eq, f(a[:, :, None, None], b[None, None, :, :]), 0.0)


def join(a: Sharded, b: Sharded, pred, merge, size_a: float,
         size_b: float, eta: float = 0.1) -> Sharded:
    """``join_dense`` over sharded operands, moving data as §4.7 prices
    it (``core.cost.join_comm_cost``): overlays and D2D as above; entry
    joins and cross products broadcast the smaller side unless a side is
    already broadcast; D2V/V2D broadcast A when (N−1)·|A| is at most the
    model's routing cost of B's matched entries (η·|B|, N times that when
    A is split off the key), else broadcast B — the port moves B whole
    where the model routes only the matched entries."""
    from repro_torch.core import joins as J
    from repro_torch.core.predicates import Field, JoinKind
    k = pred.kind
    f = merge.fn
    if k in (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY):
        return overlay(a, b, f, k is JoinKind.TRANSPOSE_OVERLAY)
    if k is JoinKind.D2D:
        return d2d(a, b, pred.left, pred.right, f, size_a, size_b)
    n = a.n
    if k in (JoinKind.CROSS, JoinKind.V2V):
        dense = J.cross_dense if k is JoinKind.CROSS else J.v2v_dense
        if a.dim is not None and b.dim is not None:
            if size_a <= size_b:
                a = redistribute(a, None)
            else:
                b = redistribute(b, None)
        return _outer(a, b, lambda x, y, _off: dense(x, y, f))
    if k in (JoinKind.D2V, JoinKind.V2D):
        # V2D is D2V with the roles swapped (as ``join_dense``)
        flip = k is JoinKind.V2D
        dim = pred.right if flip else pred.left
        lhs, rhs = (b, a) if flip else (a, b)
        fn = (lambda x, y: f(y, x)) if flip else f
        s_l, s_r = (size_b, size_a) if flip else (size_a, size_b)
        if lhs.dim is not None and rhs.dim is not None:
            key_axis = 0 if dim is Field.RID else 1
            mult = 1.0 if lhs.dim == key_axis else float(n)
            if (n - 1) * s_l <= mult * eta * s_r:
                lhs = redistribute(lhs, None)
            else:
                rhs = redistribute(rhs, None)
        out = _outer(lhs, rhs,
                     lambda x, y, off: _d2v_local(x, y, dim, fn, off),
                     a_key_axis=0 if dim is Field.RID else 1)
        if not flip:
            return out
        perm = (2, 3, 0, 1)
        shards = [s.permute(*perm).contiguous() for s in out.shards]
        dim_out = None if out.dim is None else perm.index(out.dim)
        shape = tuple(out.shape[p] for p in perm)
        return Sharded(shards, dim_out, out.bounds, shape)
    raise ValueError(k)
