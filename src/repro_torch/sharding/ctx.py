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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

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
    prev = current()
    _STATE.ctx = (mesh, rules)
    try:
        if has_devices(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _STATE.ctx = prev


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
    """The rank's shard of a DTensor; a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _cut_like(ref, dims) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in ref.placements)


def local_cut_like(x, ref, dims):
    """The rank's shard of ``x`` laid out with its dim ``dims[d]`` cut as
    ``ref``'s dim ``d`` and its other dims whole: under a device mesh, the
    operands of a computation each rank does on its own batch rows and
    heads. A plain ``x`` (the same on every rank), or any ``x`` without a
    context, is returned as it is."""
    from torch.distributed.tensor import DTensor
    if device_mesh() is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, _cut_like(ref, dims)).to_local()


def from_local_like(t, ref, dims, shape):
    """``t``, this rank's shard of a tensor of global ``shape`` whose dim
    ``dims[d]`` is cut as ``ref``'s dim ``d`` (its other dims whole), as a
    DTensor; ``t`` itself without a context."""
    if device_mesh() is None:
        return t
    return _from_local(t, ref.device_mesh, _cut_like(ref, dims), shape)


def _from_local(t, torch_mesh, placements_, shape):
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
    return _from_local(fn(x.to_local()), x.device_mesh, x.placements, shape)


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
    contracted over the tensor axis, a vocab-cut embedding lookup) summed
    and replicated over their axes: the all-reduce GSPMD places where a
    row-parallel product meets the replicated residual. Left pending,
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


def _local_range(mesh, placements_, dim: int, extent: int):
    """(first index, length) of this rank's cut of ``dim`` (``extent``
    long) under ``placements_``: mesh axes that shard it cut it in the
    mesh's order, the first one outermost (DTensor's nesting)."""
    from torch.distributed.tensor import Shard
    coord = mesh.torch_mesh.get_coordinate()
    lo, size = 0, extent
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.torch_mesh.size(i)
            if size % n:
                raise ValueError(f"dim {dim} of {extent} is cut unevenly")
            size //= n
            lo += coord[i] * size
    return lo, size


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
    lo, size = _local_range(mesh, cache.placements, 1, cache.shape[1])
    if lo <= slot < lo + size:
        cache.to_local()[:, slot - lo] = value


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
