"""Minimal module system: parameter specs + init over nested dicts.

A model definition is a nested dict of ``ParamSpec`` leaves;
``init_params`` materializes values and forward passes are plain
functions over the materialized tree of tensors (what the JAX package's
pytrees are there). ``MeshRules`` maps a leaf's *logical axes* onto mesh
axes; the port runs on one card, so the functions that turn those rules
into shardings wait for a multi-card program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch


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


def tree_index(tree: Tree, i: int) -> Tree:
    """Every leaf's ``[i]`` along its leading (stacked block) dim: views."""
    return tree_map(lambda x: x[i], tree)


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
