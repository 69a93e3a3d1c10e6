"""Ambient activation-sharding context.

Model code is pure; a launcher installs the mesh + rules here and model
layers call ``shard_act(x, *logical_axes)`` at materialization points.
Without an installed context the calls are the identity (one card, and
most tests).

Under a ``DeviceMesh`` (one process a device, ``launch.mesh``) the
activations and parameters are DTensors: ``shard_act`` redistributes its
activation to the placements of the JAX package's divisibility-guarded
spec for the site, PyTorch's counterpart of ``with_sharding_constraint``,
and ``weight`` all-gathers a parameter over the FSDP axes before use. That
is what pinning activations batch-sharded makes GSPMD do (gather the
WEIGHTS, not the batch); DTensor's own propagation could move the
activation instead, so the gather is explicit. An abstract ``Mesh`` has no
devices: installed, it makes ``shard_act`` raise rather than be ignored.

Gradients: the helpers that hand a rank its local shard (``local_cut_like``,
``per_shard``, ``local``) label the shard's gradient with the placements of
the work the rank did on it. An operand whole on a mesh axis whose ranks
work on different cuts (other batch rows) gets a partial sum of its
gradient on each of them, labelled ``Partial()``, which the backward of its
redistribute reduces; DTensor's default, the forward placements, would call
it replicated and drop that reduction. ``sum_over`` is an all-reduce over
mesh axes whose backward is the identity (the sum is whole on every rank of
those axes, and so is the gradient that reaches it).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.module import MeshRules
from repro_torch.sharding.partition import (
    PartitionSpec, has_devices, placements,
)

_STATE = threading.local()


def current() -> Optional[Tuple[Any, MeshRules]]:
    return getattr(_STATE, "ctx", None)


def device_mesh():
    """The installed ``DeviceMesh`` and its rules, or ``None`` when no
    context or an abstract one is installed."""
    ctx = current()
    if ctx is None or not has_devices(ctx[0]):
        return None
    return ctx


@contextlib.contextmanager
def use_sharding(mesh, rules: MeshRules):
    """Install ``mesh`` and ``rules``. Over a ``DeviceMesh``, plain tensors
    that meet DTensors in an op (positions, rotary frequencies, masks:
    every rank computes the same values) count as replicated."""
    with installed((mesh, rules)):
        yield


@contextlib.contextmanager
def installed(state):
    """Install ``state`` (a value of ``current()``: (mesh, rules), or None)
    on this thread, with DTensor's implicit replication on over a
    ``DeviceMesh``; both are restored on exit, so the installs nest.
    ``models.module.remat`` installs the forward's state around a block's
    recompute, which the backward may run on another thread (the card's
    autograd worker), where a thread's context is not seen."""
    prev = current()
    _STATE.ctx = state
    dispatch = flag = None
    if state is not None and has_devices(state[0]):
        from torch.distributed.tensor import DTensor
        # the flag ``implicit_replication()`` sets; that context manager
        # clears it on exit instead of restoring it, so nested installs
        # (a recompute inside the forward's install) set it here
        dispatch = DTensor._op_dispatcher
        flag = dispatch._allow_implicit_replication
        dispatch._allow_implicit_replication = True
    try:
        yield
    finally:
        _STATE.ctx = prev
        if dispatch is not None:
            dispatch._allow_implicit_replication = flag


def mesh_key() -> tuple:
    """() without a device mesh, else (mesh, rules): the part of a step's
    key that says where it runs."""
    ctx = device_mesh()
    return () if ctx is None else tuple(ctx)


def check_mesh(key: tuple) -> None:
    """Raise ``RuntimeError`` unless the installed mesh is ``key``'s: a step
    built for one mesh (or for none) runs under that mesh only."""
    if mesh_key() != key:
        raise RuntimeError(f"a step built for mesh {key or None} was called "
                           f"under {mesh_key() or None}")


def divisible_spec(mesh, rules: MeshRules, logical, shape) -> PartitionSpec:
    """The spec an activation site pins: each dim takes its logical axis's
    mesh axes (not taken by an earlier dim) when their size divides it,
    else stays replicated."""
    out = []
    used: set = set()
    for dim, lg in zip(shape, logical):
        axes = tuple(a for a in rules.mesh_axes_for(lg)
                     if a in mesh.shape and a not in used)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if axes and size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return PartitionSpec(*out)


class Layout(NamedTuple):
    """The mesh and placements of a DTensor not made yet: a ``ref`` for
    ``local_cut_like`` and ``from_local_like`` (the layout of the work
    each rank does, before its result exists)."""
    device_mesh: Any
    placements: tuple


def site_layout(shape, *logical: Optional[str]) -> Optional[Layout]:
    """Under a device mesh, the layout ``shard_act`` gives an activation
    of ``shape`` at a site pinned to ``logical``; ``None`` without one."""
    ctx = device_mesh()
    if ctx is None:
        return None
    mesh, rules = ctx
    return Layout(mesh.torch_mesh, placements(
        mesh, divisible_spec(mesh, rules, logical, tuple(shape))))


def _dtensor(x, what: str):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"{what} under a device mesh must be a DTensor, "
                        f"got {type(x).__name__}")
    return x


def shard_act(x, *logical: Optional[str]):
    """Constrain an activation to the logical axes (identity w/o context)."""
    ctx = current()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not has_devices(mesh):
        raise NotImplementedError(
            f"activation sharding needs a mesh of devices; {mesh!r} has "
            f"none, and without one the port runs the models on one device "
            f"(logical axes {logical})")
    if len(logical) != x.ndim:
        return x
    spec = divisible_spec(mesh, rules, logical, tuple(x.shape))
    return _dtensor(x, "an activation").redistribute(
        mesh.torch_mesh, placements(mesh, spec))


def shard_unflatten(x, dim: int, sizes, *logical: Optional[str]):
    """``shard_act(x.unflatten(dim, sizes), *logical)``. Under a device
    mesh ``x`` is first cut as the split result will be, the split dim
    taking the cut of its leading part: a projection cut inside a head
    (2 KV heads of 16 columns over 4 ranks) cannot be viewed as heads, so
    it is gathered first, and one cut in whole heads is viewed in place."""
    ctx = device_mesh()
    if ctx is None:
        return shard_act(x.unflatten(dim, sizes), *logical)
    mesh, rules = ctx
    from torch.distributed.tensor import Replicate, Shard
    sizes = tuple(sizes)
    shape = tuple(x.shape[:dim]) + sizes + tuple(x.shape[dim + 1:])
    pre = []
    for p in placements(mesh, divisible_spec(mesh, rules, logical, shape)):
        if not isinstance(p, Shard) or dim < p.dim < dim + len(sizes):
            pre.append(Replicate())
        elif p.dim <= dim:
            pre.append(p)
        else:
            pre.append(Shard(p.dim - len(sizes) + 1))
    x = _dtensor(x, "an activation").redistribute(mesh.torch_mesh,
                                                   tuple(pre))
    return shard_act(x.unflatten(dim, sizes), *logical)


def local(x):
    """The rank's shard of a DTensor (its gradient labelled with the
    DTensor's placements: the rank works on that shard alone); a plain
    tensor itself."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _cut_like(ref, dims) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in ref.placements)


def grad_placements(held, work) -> tuple:
    """The placements of the gradient of a local shard laid out by
    ``held`` that each rank used in work cut as ``work``: ``held``, bar a
    mesh axis where the shard is whole but the work is cut, whose ranks
    each hold a partial sum (``Partial()``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(h, Replicate) and isinstance(w, Shard)
                 else h for h, w in zip(held, work))


def local_cut_like(x, ref, dims):
    """The rank's shard of ``x`` laid out with its dim ``dims[d]`` cut as
    ``ref``'s dim ``d`` and its other dims whole: under a device mesh, the
    operands of a computation each rank does on its own batch rows and
    heads (the work cut as ``ref``). Its gradient is labelled by
    ``grad_placements``. A plain ``x`` (the same on every rank), or any
    ``x`` without a context, is returned as it is."""
    from torch.distributed.tensor import DTensor
    if device_mesh() is None or not isinstance(x, DTensor):
        return x
    cut = _cut_like(ref, dims)
    return x.redistribute(x.device_mesh, cut).to_local(
        grad_placements=grad_placements(cut, ref.placements))


def like(t, ref):
    """``t``, the rank's shard of a tensor laid out as ``ref`` (same global
    shape), as a DTensor like ``ref``; ``t`` itself when ``ref`` is a plain
    tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return t
    return from_shard(t, ref.device_mesh, ref.placements, ref.shape)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(t, ref):
    """``t`` (the same on every rank) as a DTensor replicated over the mesh
    of ``ref``: the optimizer's count beside DTensor parameters, labels
    beside DTensor logits. ``t`` itself when it is a DTensor already or
    ``ref`` is a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor) or not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def from_local_like(t, ref, dims, shape):
    """``t``, this rank's shard of a tensor of global ``shape`` whose dim
    ``dims[d]`` is cut as ``ref``'s dim ``d`` (its other dims whole), as a
    DTensor; ``t`` itself without a context."""
    if device_mesh() is None:
        return t
    return from_shard(t, ref.device_mesh, _cut_like(ref, dims), shape)


def from_shard(t, torch_mesh, placements_, shape):
    """A DTensor of even cuts from the local ``t`` (DTensor infers the
    global shape and strides from the shard's); ``shape`` is the shape the
    caller expects."""
    from torch.distributed.tensor import DTensor
    out = DTensor.from_local(t, torch_mesh, placements_, run_check=False)
    if out.shape != torch.Size(shape):
        raise ValueError(f"shards of {tuple(t.shape)} give {tuple(out.shape)}"
                         f", not {tuple(shape)}")
    return out


def per_shard(fn, x, shape):
    """``fn(x)`` for an ``fn`` that acts on each cut of ``x`` alone and
    gives a result of global ``shape`` cut the same way (a repeat within
    the cut dims, say). Under a device mesh ``fn`` runs on the local shard
    and the result keeps ``x``'s placements: DTensor would gather a cut it
    has no rule for."""
    if device_mesh() is None:
        return fn(x)
    x = _dtensor(x, "an activation")
    return from_shard(fn(x.to_local()), x.device_mesh, x.placements, shape)


def on_shards(fn, work, args, outs):
    """``fn`` run on each rank's shards of the work cut as ``work`` (a
    ``Layout``, or a DTensor laid out as the work): a recurrent scan over
    the rank's batch rows and channels or heads. ``args`` are ``(x,
    dims)`` pairs, each handed to ``fn`` as ``local_cut_like(x, work,
    dims)`` (its gradient labelled by ``grad_placements``: an operand
    whole on an axis that cuts the work, such as a scan's B_t and C_t
    over the tensor axis, gets a partial sum there); ``outs`` are ``(dims,
    shape)`` pairs, one for each tensor ``fn`` returns, which come back
    as ``from_local_like`` DTensors of global ``shape``. Without a device
    mesh, ``fn`` on ``args``' tensors as they are. Returns a tuple."""
    if device_mesh() is None:
        return tuple(fn(*(x for x, _ in args)))
    got = fn(*(local_cut_like(x, work, dims) for x, dims in args))
    return tuple(from_local_like(t, work, dims, shape)
                 for t, (dims, shape) in zip(got, outs))


def axes_where(x, pred) -> tuple:
    """The mesh axes of the DTensor ``x`` whose placement satisfies
    ``pred``."""
    names = x.device_mesh.mesh_dim_names
    return tuple(a for a, p in zip(names, x.placements) if pred(p))


def _groups(torch_mesh, axes) -> tuple:
    return tuple(torch_mesh.get_group(a) for a in axes)


class _SumOver(torch.autograd.Function):
    """All-reduce SUM over process groups; the backward is the identity:
    the sum is whole on every rank of the groups, each rank's gradient of it
    the same, and that is the gradient of each rank's addend."""

    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed as dist
        t = t.clone()
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(t, torch_mesh, axes):
    """The plain tensor ``t`` summed over the ranks of the mesh ``axes`` (an
    all-reduce a tensor, differentiable as ``_SumOver``); ``t`` itself for
    no axes."""
    if not axes:
        return t
    return _SumOver.apply(t, _groups(torch_mesh, axes))


def reduce_over(t, torch_mesh, axes, op: str):
    """``t`` reduced by ``op`` (``"max"`` or ``"min"``) over the ranks of
    the mesh ``axes``, outside autograd."""
    import torch.distributed as dist
    t = t.detach().clone()
    which = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    for g in _groups(torch_mesh, axes):
        dist.all_reduce(t, op=which, group=g)
    return t


def local_range(x, dim: int, whole: Optional[int] = None):
    """(first index, length) of this rank's cut of the DTensor ``x``'s dim
    ``dim``, or of a dim of ``whole`` elements laid out by the ``Layout``
    ``x``: mesh axes that shard it cut it in the mesh's order, the first
    one outermost (DTensor's nesting)."""
    coord = x.device_mesh.get_coordinate()
    whole = x.shape[dim] if whole is None else whole
    lo, size = 0, whole
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n = x.device_mesh.size(i)
            if size % n:
                raise ValueError(f"dim {dim} of {whole} is cut unevenly")
            size //= n
            lo += coord[i] * size
    return lo, size


def owns_copy(x) -> bool:
    """Whether this rank holds the first copy of its shard of the DTensor
    ``x``: coordinate 0 on every mesh axis where ``x`` is whole. Summing
    over such ranks counts each element once."""
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements)
               if not p.is_shard())


def _replicate_where(x, drop, what: str):
    """The DTensor ``x`` with each placement for which ``drop(axis name,
    placement)`` holds made ``Replicate()`` (the rest kept); without a
    device mesh, ``x`` itself."""
    ctx = device_mesh()
    if ctx is None:
        return x
    mesh = ctx[0]
    from torch.distributed.tensor import Replicate
    x = _dtensor(x, what)
    want = tuple(Replicate() if drop(a, p) else p
                 for a, p in zip(mesh.axis_names, x.placements))
    return x.redistribute(mesh.torch_mesh, want)


def gather_dim(x, dim: int):
    """Under a device mesh, ``x`` with dim ``dim`` whole on every rank (its
    cut all-gathered, the other cuts kept): the vocab-cut logits before
    an argmax over the vocabulary. Without a context, ``x`` itself."""
    dim %= x.ndim
    return _replicate_where(
        x, lambda a, p: p.is_shard() and p.dim == dim, "an activation")


def reduce_partial(x):
    """Under a device mesh, ``x`` with its pending partial sums (a product
    contracted over the tensor axis) summed and replicated over their
    axes: the all-reduce GSPMD places where a row-parallel product meets
    the replicated residual; its backward leaves the gradient whole (the
    backward of an all-reduce is the identity). Left pending,
    DTensor would reduce-scatter it at the next op that cannot take a
    partial value and cut the residual stream's features instead. Without
    a context, ``x`` itself."""
    return _replicate_where(x, lambda a, p: p.is_partial(), "an activation")


def pin(x, spec):
    """Under a device mesh, ``x`` laid out by ``spec``: a DTensor is
    redistributed; a plain tensor (the same values on every rank, such as
    positions built from ``arange``) is taken as replicated and cut
    locally. Without a context, ``x`` itself."""
    ctx = device_mesh()
    if ctx is None:
        return x
    mesh = ctx[0]
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.torch_mesh,
                               [Replicate()] * len(mesh.axis_names),
                               run_check=False)
    return x.redistribute(mesh.torch_mesh, placements(mesh, spec))


def write_slot(cache, slot: int, value) -> None:
    """``cache[:, slot] = value`` in place (a decode step's KV or position
    write). Under a device mesh each rank writes its own shard of the
    DTensor ``cache``: its rows of a batch cut, and for a cache cut along
    the slots (dim 1) only the rank holding ``slot``, at the slot's local
    index. ``value`` (a DTensor, or a Python number) is first laid out as
    the cache's other dims are. The cache is never gathered."""
    ctx = device_mesh()
    if ctx is None:
        cache[:, slot] = value
        return
    mesh = ctx[0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cache = _dtensor(cache, "a cache")
    if isinstance(value, DTensor):
        want = []
        for p in cache.placements:
            if isinstance(p, Shard) and p.dim >= 1:
                want.append(Replicate() if p.dim == 1 else Shard(p.dim - 1))
            else:
                want.append(p)
        value = value.redistribute(mesh.torch_mesh, want).to_local()
    lo, size = local_range(cache, 1)
    if lo <= slot < lo + size:
        cache.to_local()[:, slot - lo] = value


def write_state(cache, value) -> None:
    """``cache.copy_(value)`` (a decode step's recurrent state: a conv
    window, an SSM or WKV state, a token shift). Under a device mesh both
    are DTensors and ``value`` must already be laid out as ``cache`` (else
    ``ValueError``): each rank copies its shard into its own, and nothing
    is gathered or moved between ranks."""
    if device_mesh() is None:
        cache.copy_(value)
        return
    cache = _dtensor(cache, "a cache")
    value = _dtensor(value, "a state")
    if value.shape != cache.shape or \
            tuple(value.placements) != tuple(cache.placements):
        raise ValueError(
            f"a state of {tuple(value.shape)} {tuple(value.placements)} "
            f"written into a cache of {tuple(cache.shape)} "
            f"{tuple(cache.placements)}")
    cache.to_local().copy_(value.to_local())


def weight(w, dtype=None):
    """A parameter as compute uses it, cast to ``dtype`` (if given): under a
    device mesh, all-gathered over the FSDP axes and still cut over the
    others (the tensor axis)."""
    if dtype is not None:
        w = w.to(dtype)
    ctx = device_mesh()
    if ctx is None:
        return w
    fsdp = ctx[1].fsdp
    return _replicate_where(w, lambda a, p: a in fsdp, "a parameter")
