"""Production mesh construction.

Single-pod: 16×16 = 256 chips (data × model). Multi-pod: 2×16×16 = 512
chips with a leading pure-DP "pod" axis. The mesh is abstract
(``sharding/partition.py``): names and sizes, no device, so building one
touches no card. ``REPRO_MESH_SINGLE`` / ``REPRO_MESH_MULTI`` (e.g.
``2,4``) override the sizes, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Tuple

from repro_torch.models.module import MeshRules
from repro_torch.sharding.partition import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    env = os.environ.get("REPRO_MESH_MULTI" if multi_pod
                         else "REPRO_MESH_SINGLE")
    if env:
        shape = tuple(int(x) for x in env.split(","))
        if len(shape) != len(axes):
            raise ValueError(f"mesh override {shape} does not match the "
                             f"axes {axes}")
    return Mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """General mesh for tests."""
    return Mesh(shape, axes)


def default_rules(mesh) -> MeshRules:
    """MeshRules filtered to the axes the mesh actually has."""
    names = tuple(mesh.shape.keys())
    return MeshRules(
        fsdp=tuple(a for a in ("data",) if a in names),
        tensor=tuple(a for a in ("model",) if a in names),
        batch=tuple(a for a in ("pod", "data") if a in names),
    )


def mesh_device_count(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
