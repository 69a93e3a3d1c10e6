"""Activation / input / cache partition specs over the production mesh."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import MeshRules, tree_map
from repro_torch.sharding.ctx import device_mesh, pin
from repro_torch.sharding.partition import NamedSharding, PartitionSpec as P


def _present(mesh, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.shape)


def _size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _maybe(mesh, axes: Tuple[str, ...], dim: int):
    axes = _present(mesh, axes)
    if axes and dim % _size(mesh, axes) == 0 and _size(mesh, axes) > 1:
        return axes if len(axes) > 1 else axes[0]
    return None


def input_partition_specs(mesh, rules: MeshRules, specs: Dict[str, Any]
                          ) -> Dict[str, P]:
    """Batch-shard every model input on its leading dim (pos scalar: repl)."""
    out = {}
    for name, s in specs.items():
        if not len(s.shape):
            out[name] = P()
            continue
        lead = _maybe(mesh, rules.batch, s.shape[0])
        out[name] = P(lead, *([None] * (len(s.shape) - 1)))
    return out


def _leaf_spec(mesh, rules: MeshRules, name: str, shape) -> P:
    batch_axes = _present(mesh, rules.batch)
    tensor_axes = _present(mesh, rules.tensor)
    b_sh = _maybe(mesh, batch_axes, shape[1]) if len(shape) > 1 else None
    if name in ("k", "v"):
        # [L, B, N, H, hd]
        seq_sh = None if b_sh is not None else _maybe(
            mesh, batch_axes, shape[2])
        h_sh = _maybe(mesh, tensor_axes, shape[3])
        return P(None, b_sh, seq_sh, h_sh, None)
    if name == "pos":
        seq_sh = None if b_sh is not None else _maybe(
            mesh, batch_axes, shape[2])
        return P(None, b_sh, seq_sh)
    if name == "conv":      # [L, B, K-1, d_in]
        return P(None, b_sh, None, _maybe(mesh, tensor_axes, shape[3]))
    if name == "h":         # [L, B, d_in, N]
        return P(None, b_sh, _maybe(mesh, tensor_axes, shape[2]), None)
    if name == "wkv":       # [L, B, H, hd, hd]
        return P(None, b_sh, _maybe(mesh, tensor_axes, shape[2]),
                 None, None)
    if name in ("shift_t", "shift_c"):  # [L, B, d]
        return P(None, b_sh, None)
    return P(*([None] * len(shape)))


def cache_partition_specs(cfg: ModelConfig, mesh, rules: MeshRules,
                          cache_tree) -> Any:
    """Decode-cache shardings by leaf role (the last key of its path).

    Priority per leaf: batch dim → DP axes; heads/channels → tensor axis;
    when the batch is unshardable (e.g. long_500k B=1), the sequence dim of
    attention KV takes the DP axes instead (sequence-sharded cache).
    """
    def walk(tree, name: str):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _leaf_spec(mesh, rules, name, tuple(tree.shape))

    return walk(cache_tree, "")


def to_shardings(mesh, spec_tree):
    """A ``NamedSharding`` a spec; over a ``DeviceMesh`` each one's
    ``placements`` are the spec's DTensor placements."""
    return tree_map(lambda p: NamedSharding(mesh, p), spec_tree)


def pin_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Under a device mesh, each model input laid out by
    ``input_partition_specs`` (a plain tensor, the same on every rank, is
    cut locally); without one, ``batch`` itself."""
    ctx = device_mesh()
    if ctx is None:
        return batch
    mesh, rules = ctx
    specs = input_partition_specs(mesh, rules, batch)
    return {k: pin(v, specs[k]) for k, v in batch.items()}


def pin_caches(cfg: ModelConfig, caches):
    """Under a device mesh, the caches laid out by
    ``cache_partition_specs``: the decode program's input and output
    shardings, so a prefill hands decode caches it can write in place.
    Without one, ``caches`` themselves."""
    ctx = device_mesh()
    if ctx is None:
        return caches
    mesh, rules = ctx
    return tree_map(pin, caches,
                    cache_partition_specs(cfg, mesh, rules, caches))
