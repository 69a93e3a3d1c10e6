"""Production mesh construction.

Single-pod: 16×16 = 256 chips (data × model). Multi-pod: 2×16×16 = 512
chips with a leading pure-DP "pod" axis. The production mesh is abstract
(``sharding/partition.py``): names and sizes, no device, so building one
touches no card. ``REPRO_MESH_SINGLE`` / ``REPRO_MESH_MULTI`` (e.g.
``2,4``) override the sizes, as in the JAX package.

``make_device_mesh`` builds a mesh with devices behind it, one process a
device: the cards of a node over NCCL, or CPU processes over gloo.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.module import MeshRules
from repro_torch.sharding.partition import DeviceMesh, Mesh


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


def make_device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                     device) -> DeviceMesh:
    """The mesh ``shape`` × ``axes`` over the processes of the initialised
    default process group, rank r at mesh position r in row-major order
    (the JAX package's device order). ``device`` is ``"cpu"`` or
    ``"cuda"``; on ``"cuda"`` rank r must be on ``cuda:r`` (its current
    card). A world of another size than the mesh, a missing card or two
    ranks on one card raise: no mesh shrinks to fewer devices."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = mesh_device_count(Mesh(shape, axes))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} processes; the process "
                         f"group has {world}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"mesh {shape} needs {n} cards, one a rank; "
                               f"this node has {torch.cuda.device_count()}")
        if dev.index is not None and dev.index != rank:
            raise ValueError(f"rank {rank} asked for {dev}; rank r runs on "
                             "cuda:r")
        if torch.cuda.current_device() != rank:
            raise RuntimeError(
                f"rank {rank} is on cuda:{torch.cuda.current_device()}; "
                f"call torch.cuda.set_device({rank}) first (one card a "
                "rank)")
        dev = torch.device("cuda", rank)
    elif dev.type != "cpu":
        raise ValueError(f"no device mesh on {dev.type}")
    from torch.distributed.device_mesh import init_device_mesh
    tm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return DeviceMesh(tm, dev)


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
