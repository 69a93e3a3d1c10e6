"""Abstract mesh, partition specs and named shardings.

The counterparts of the ``jax.sharding`` objects the JAX package's spec
functions return. They hold names and sizes only: no device backs a
``Mesh``, so the spec functions run at the production meshes (16×16,
2×16×16) on any machine, and the dry run sizes each chip's resident
bytes from them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


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
