"""Gradient compression: int8 quantization with error feedback.

* ``quantize``/``dequantize`` + ``ErrorFeedback``: per-tensor max-abs int8
  quantization with a persistent residual (error-feedback) buffer, which
  preserves SGD/Adam convergence (Karimireddy et al., 2019).
  ``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` and
  ``scale`` equal the JAX package's bit for bit.
* ``compressed_psum``: an all-reduce over a ``torch.distributed`` process
  group that moves int8 payloads summed in int32: a MAX all-reduce of the
  local max-abs (one f32 scalar), int8 encode, an int32 SUM all-reduce,
  rescale by the world size. The JAX package does the same over a
  ``shard_map`` axis.

The train step runs the quantize → dequantize pair on its gradients (a
simulation of the compression's effect on convergence, as the JAX
package's step does; no wire savings). Over DTensors (a device mesh) each
rank quantizes its own shard with the tensor's *global* max-abs (a MAX
all-reduce of one scalar), so the codes, and the residuals, are those of
the whole tensor; the JAX step under GSPMD does the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.module import tree_map
from repro_torch.sharding.ctx import is_dtensor, like, local


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # f32 scalar


def _encode(x: torch.Tensor, amax: torch.Tensor):
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def _amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| in f32; of a DTensor, over the whole tensor (a MAX
    all-reduce over the process group of the shards' maxima)."""
    amax = torch.max(torch.abs(local(x))).to(torch.float32)
    if is_dtensor(x):
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    return amax


def quantize(x: torch.Tensor) -> Quantized:
    """Codes (a DTensor like ``x``, for a DTensor) and the f32 scale."""
    q, scale = _encode(local(x), _amax(x))
    return Quantized(like(q, x), scale)


def dequantize(qx: Quantized, dtype=torch.float32) -> torch.Tensor:
    return like((local(qx.q).to(torch.float32) * qx.scale).to(dtype), qx.q)


class ErrorFeedback(NamedTuple):
    residual: Any  # tree congruent with grads


def ef_init(grads_like) -> ErrorFeedback:
    return ErrorFeedback(tree_map(torch.zeros_like, grads_like))


@torch.no_grad()
def ef_compress(grads, ef: ErrorFeedback) -> Tuple[Any, ErrorFeedback]:
    """g_hat = Q(g + e);  e' = (g + e) - g_hat  (per tensor; over DTensors
    on each rank's shards, with the tensor's global max-abs)."""
    def one(g, e):
        corrected = like(local(g) + local(e), g)
        g_hat = dequantize(quantize(corrected), g.dtype)
        return g_hat, like(local(corrected) - local(g_hat), g)

    pairs = tree_map(one, grads, ef.residual)
    return (tree_map(lambda t: t[0], pairs),
            ErrorFeedback(tree_map(lambda t: t[1], pairs)))


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over ``group`` (the default group when
    None), divided by the group's size: the scale is the MAX all-reduce of
    the local max-abs, the payload an int32 SUM all-reduce of the int8
    codes. Raises ``RuntimeError`` without an initialised process group."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("compressed_psum needs an initialised "
                           "torch.distributed process group")
    amax = torch.max(torch.abs(x)).to(torch.float32)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    q, scale = _encode(x, amax)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return (total.to(torch.float32) * scale / n).to(x.dtype)
