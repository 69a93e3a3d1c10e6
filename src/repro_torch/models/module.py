"""Minimal module system: parameter specs + init over nested dicts.

A model definition is a nested dict of ``ParamSpec`` leaves;
``init_params`` materializes values and forward passes are plain
functions over the materialized tree of tensors (what the JAX package's
pytrees are there). ``MeshRules`` maps a leaf's *logical axes* onto mesh
axes and ``partition_specs`` turns a spec tree into per-leaf
``PartitionSpec``s over a ``Mesh`` (``sharding/partition.py``): over an
abstract one the dry run sizes each chip's bytes from them; over a
``DeviceMesh`` ``shardings`` gives their DTensor placements and
``distribute`` puts a tree there (``jax.device_put``'s counterpart).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.sharding.partition import NamedSharding, PartitionSpec


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names (None = replicated)
    init: str = "normal"              # normal | zeros | ones | ssm_a_log
    scale: Optional[float] = None     # stddev; default fan-in
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical axis → mesh axis mapping.

    ``batch`` axes are the pure-DP axes (pod + data); ``fsdp`` shards weight
    storage; ``tensor`` is the model-parallel axis.
    """

    fsdp: Tuple[str, ...] = ("data",)
    tensor: Tuple[str, ...] = ("model",)
    batch: Tuple[str, ...] = ("pod", "data")
    sequence: Tuple[str, ...] = ()   # optional SP axis for activations

    def mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        table = {
            # weight axes
            "embed": self.fsdp,        # d_model dim of weights (fsdp storage)
            "ffn": self.tensor,        # hidden/ffn/head output dims (TP)
            "heads": self.tensor,
            "kv_heads": self.tensor,
            "vocab": self.tensor,      # vocab-sharded embedding/unembedding
            "experts": self.tensor,    # EP when divisible
            "layers": (),              # stacked block dim: replicated
            # activation axes
            "batch": self.batch,
            "act_seq": self.sequence,
            "act_embed": self.tensor,
            "act_heads": self.tensor,
            "act_ffn": self.tensor,
            "act_experts": self.tensor,
            "act_kv": (),
            "stage": ("pod",),
        }
        return table.get(logical, ())


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def spec_for(mesh, rules: MeshRules, axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> PartitionSpec:
    """PartitionSpec with a divisibility guard: a dim is sharded only when
    its extent divides the product of the mapped mesh axes (8 KV heads on
    a 16-way tensor axis stay replicated); otherwise the longest prefix of
    those axes that divides it, if any. A mesh axis shards one dim."""
    out = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mesh_axes = tuple(a for a in rules.mesh_axes_for(logical)
                          if a in mesh.shape and a not in used)
        if not mesh_axes:
            out.append(None)
            continue
        picked = None
        for k in range(len(mesh_axes), 0, -1):
            size = _axes_size(mesh, mesh_axes[:k])
            if size > 1 and dim % size == 0:
                picked = mesh_axes[:k]
                break
        if picked:
            out.append(picked if len(picked) > 1 else picked[0])
            used.update(picked)
        else:
            out.append(None)
    return PartitionSpec(*out)


def is_param_spec(x) -> bool:
    return isinstance(x, ParamSpec)


# ---------------------------------------------------------------------------
# Nested-dict trees (keys visited in sorted order, as jax.tree does).
# ---------------------------------------------------------------------------

Tree = Union[Dict[str, Any], Any]


def tree_items(tree: Tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unbind(tree: Tree, n: int) -> list:
    """The stacked tree's ``n`` blocks as ``n`` trees of views, each leaf
    split once by ``torch.unbind`` along its leading dim: its backward
    stacks the ``n`` blocks' gradients into one tensor of the leaf (each
    block's ``x[i]`` would add into a zero tensor of the whole leaf).
    Decode writes its caches in place through these views."""
    split = tree_map(lambda x: torch.unbind(x, 0), tree)
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the activation-recompute policy ``policy``, as the JAX
    package wraps a block in ``jax.checkpoint``: ``"full"`` saves only the
    block's inputs and recomputes the rest in the backward; ``"dots"``
    saves the outputs of the matrix products (``aten.mm``/``bmm``/
    ``addmm``, the counterpart of ``checkpoint_dots``) and recomputes the
    rest; ``"none"`` returns ``fn``. Recompute changes memory, never
    values: it runs under the sharding context (``sharding.ctx``) of the
    forward. Without grad mode there is no backward, and ``fn`` runs as
    is."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        from repro_torch.sharding.ctx import current, installed
        where = current()

        def under(*a):
            # the recompute runs in the backward, perhaps on the card's
            # autograd thread: the forward's sharding context goes with it
            with installed(where):
                return fn(*a)

        return checkpoint(under, *args, use_reentrant=False, **kw)

    return wrapped


def _init_leaf(s: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "ssm_a_log":
        # Mamba A init: log(1..d_state) broadcast over channels
        n = s.shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=s.dtype, device=device))
        return row.expand(s.shape).contiguous()
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    scale = s.scale if s.scale is not None else 1.0 / math.sqrt(
        max(1, fan_in))
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    return out.normal_(0.0, scale, generator=generator)


def init_params(spec_tree: Tree, generator: torch.Generator,
                device: Union[str, torch.device]) -> Dict:
    """Materialize a spec tree on ``device``, drawing every normal leaf
    from ``generator`` (which must live on that device's type) in
    sorted-key order."""
    device = torch.device(device)
    return tree_map(lambda s: _init_leaf(s, generator, device), spec_tree)


def param_count(spec_tree: Tree) -> int:
    return sum(int(math.prod(s.shape)) for _, s in tree_items(spec_tree))


def abstract_params(spec_tree: Tree) -> Dict:
    """``meta`` tensors of each leaf's shape and dtype: the dry run traces
    over them without allocating."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def partition_specs(spec_tree: Tree, mesh, rules: MeshRules) -> Dict:
    return tree_map(lambda s: spec_for(mesh, rules, s.axes, s.shape),
                    spec_tree)


def shardings(spec_tree: Tree, mesh, rules: MeshRules) -> Dict:
    """A ``NamedSharding`` a leaf; over a ``DeviceMesh`` each one's
    ``placements`` are its spec's DTensor placements."""
    return tree_map(lambda p: NamedSharding(mesh, p),
                    partition_specs(spec_tree, mesh, rules))


def distribute(tree: Tree, shards: Tree) -> Dict:
    """Each leaf of ``tree`` (the same values on every rank) as a DTensor
    laid out by its ``NamedSharding`` in ``shards`` (same structure) over
    that sharding's ``DeviceMesh``, on the mesh's device of this rank;
    ``distribute_tensor`` takes rank 0's values. The counterpart of
    ``jax.device_put(a, s)``: the result never shares storage with
    ``tree`` (a leaf replicated over the mesh would, on its own device),
    so updating it in place leaves ``tree`` as it was."""
    from torch.distributed.tensor import distribute_tensor

    def put(t: torch.Tensor, s: NamedSharding):
        return distribute_tensor(t.to(s.mesh.device, copy=True),
                                 s.mesh.torch_mesh, s.placements)

    return tree_map(put, tree, shards)


def act_spec(mesh, rules: MeshRules, *logical: Optional[str]
             ) -> PartitionSpec:
    """PartitionSpec for an activation given logical axis names."""
    out = []
    used: set = set()
    for lg in logical:
        axes = tuple(a for a in rules.mesh_axes_for(lg)
                     if a in mesh.shape and a not in used)
        if axes:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return PartitionSpec(*out)
