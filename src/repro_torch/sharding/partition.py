"""Meshes, partition specs and named shardings.

The counterparts of the ``jax.sharding`` objects the JAX package's spec
functions return. A ``Mesh`` holds names and sizes only: no device backs
it, so the spec functions run at the production meshes (16×16, 2×16×16)
on any machine, and the dry run sizes each chip's resident bytes from
them. A ``DeviceMesh`` is a ``Mesh`` with a ``torch.distributed`` device
mesh behind it (one process a device, ``launch.mesh.make_device_mesh``):
the same spec functions read its ``.shape``, and ``placements`` turns
their specs into DTensor placements over it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: ``None`` (replicated), one axis
    name, or a tuple of names. A ``tuple``, so it compares equal to the
    JAX package's ``PartitionSpec`` taken as a tuple."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


class Mesh:
    """Ordered axis names and sizes in ``.shape``; no devices."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class DeviceMesh(Mesh):
    """A ``Mesh`` backed by ``torch.distributed``'s device mesh of the same
    axis names and sizes (``.torch_mesh``); the process's own device is
    ``.device``."""

    def __init__(self, torch_mesh, device: torch.device):
        names = torch_mesh.mesh_dim_names
        if names is None:
            raise ValueError("a device mesh needs its axis names")
        super().__init__(tuple(torch_mesh.shape), names)
        self.torch_mesh = torch_mesh
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.device.type})"


def has_devices(mesh) -> bool:
    return isinstance(mesh, DeviceMesh)


def placements(mesh, spec: Tuple[Axis, ...]) -> tuple:
    """DTensor placements of an array laid out by ``spec`` on ``mesh``: a
    mesh axis gets ``Shard(d)`` for the dim ``d`` whose entry names it,
    else ``Replicate()``. An entry naming several axes cuts its dim over
    them major to minor, as ``jax.sharding`` does; DTensor cuts a dim
    sharded on several mesh axes in the mesh's order, so the entry's axes
    must come in that order (else ``ValueError``). Reads only the axis
    names, so any ``Mesh`` will do."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.axis_names)
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names {a!r}, which "
                                 f"the mesh {names} does not have")
            if a in dim_of:
                raise ValueError(f"spec {tuple(spec)} names {a!r} twice")
            dim_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {axes} cuts dim {d} in another "
                             f"order than the mesh's {names}")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh``; over a ``DeviceMesh`` its ``placements`` are
    the DTensor placements the spec gives."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        if not has_devices(self.mesh):
            raise TypeError(f"{self.mesh} has no devices to place on")
        return placements(self.mesh, self.spec)


def shard_count(mesh, spec: Tuple[Axis, ...]) -> int:
    """The number of pieces ``spec`` cuts an array into on ``mesh``: the
    product of the mesh sizes its entries name."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            n *= mesh.shape[a]
    return n
