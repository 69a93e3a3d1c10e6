"""Cross-entropy loss with label masking, computed in f32.

``softmax_cross_entropy`` takes materialized logits;
``chunked_softmax_cross_entropy`` unembeds the hidden states a sequence
chunk at a time, so the logits of one chunk ([B, chunk, V]) are the
largest activation. Each chunk runs under activation recompute: autograd
keeps the chunk's inputs, not its logits, which the backward recomputes.

Under a device mesh the logits are a DTensor cut over the batch and the
vocabulary, and each rank works on its own shard (``_sharded_sums``): the
vocabulary's cut is reduced by all-reduces of [rows] values (the max, the
sum of exponentials, the label's logit, the first argmax), and the three
sums by one all-reduce over the batch axes, as GSPMD reduces over the cut.
No rank gathers the logits ([B, S, V] in f32).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import remat
from repro_torch.sharding.ctx import (
    axes_where, device_mesh, is_dtensor, local, local_cut_like, local_range,
    reduce_over, replicated, sum_over, weight,
)

IGNORE = -100


def _masked_sums(lf: torch.Tensor, labels: torch.Tensor, z_loss: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Σ nll, Σ mask, Σ correct) over the unmasked positions of f32
    logits ``lf`` [..., V]. ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    if device_mesh() is not None and is_dtensor(lf):
        return _sharded_sums(lf, labels, z_loss)
    lse = torch.logsumexp(lf, dim=-1)
    safe = labels.clamp_min(0).long()
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels != IGNORE).to(torch.float32)
    correct = (torch.argmax(lf, dim=-1) == safe).to(torch.float32) * mask
    return (nll * mask).sum(), mask.sum(), correct.sum()


def _sharded_sums(lf, labels, z_loss: float):
    """``_masked_sums`` of the DTensor ``lf`` [..., V] on each rank's shard;
    plain tensors, the same on every rank. ``labels`` (a DTensor, or a
    plain tensor the same on every rank) is cut as ``lf``'s leading dims.
    The logsumexp takes the max over the cut (outside autograd: its
    derivative cancels), the first argmax the least global index among
    the ranks' first maxima equal to it."""
    mesh = lf.device_mesh
    vdim = lf.ndim - 1
    vocab = axes_where(lf, lambda p: p.is_shard(vdim))
    rows = axes_where(lf, lambda p: p.is_shard() and not p.is_shard(vdim))
    lo, n = local_range(lf, vdim)
    lab = local_cut_like(replicated(labels, lf), lf,
                         {d: d for d in range(vdim)})
    x = local(lf)
    m = reduce_over(x.amax(dim=-1), mesh, vocab, "max")
    se = sum_over(torch.exp(x - m[..., None]).sum(dim=-1), mesh, vocab)
    lse = m + torch.log(se)
    safe = lab.clamp_min(0).long()
    inside = (safe >= lo) & (safe < lo + n)
    picked = torch.gather(x, -1, (safe - lo).clamp(0, n - 1)[..., None])
    picked = sum_over(torch.where(inside, picked[..., 0], 0.0), mesh, vocab)
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (lab != IGNORE).to(torch.float32)
    idx = torch.argmax(x.detach(), dim=-1)
    top = torch.gather(x.detach(), -1, idx[..., None])[..., 0]
    best = reduce_over(top, mesh, vocab, "max")
    first = reduce_over(torch.where(top == best, idx + lo, lf.shape[vdim]),
                        mesh, vocab, "min")
    correct = (first == safe).to(torch.float32) * mask
    sums = sum_over(torch.stack([(nll * mask).sum(), mask.sum(),
                                 correct.sum()]), mesh, rows)
    return sums[0], sums[1], sums[2]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B,S,V], labels [B,S] (IGNORE = masked) → (mean nll, acc)."""
    nll, cnt, correct = _masked_sums(logits.to(torch.float32), labels,
                                     z_loss)
    denom = torch.clamp_min(cnt, 1.0)
    return nll / denom, correct / denom


def chunked_softmax_cross_entropy(w_out: torch.Tensor, x: torch.Tensor,
                                  labels: torch.Tensor, chunk: int,
                                  z_loss: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE without materializing [B,S,V]: unembed + logsumexp per S-chunk.

    w_out [V, d] (tied or unembed weight), x [B,S,d] hidden states (under
    a device mesh cut over the batch; a slice along the sequence keeps
    that cut). The chunks' sums are added in sequence order, as the JAX
    package's scan adds them."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    # cast once (under a device mesh also gathered over the FSDP axes
    # once); each chunk reads the cast copy
    w = weight(w_out, x.dtype)

    def one(xcb, lcb, w):
        logits = (xcb @ w.t()).to(torch.float32)
        return _masked_sums(logits, lcb, z_loss)

    one = remat(one, "full")
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll_sum, cnt, correct = zero, zero, zero
    for i in range(0, s, chunk):
        n, c, k = one(x[:, i:i + chunk], labels[:, i:i + chunk], w)
        nll_sum, cnt, correct = nll_sum + n, cnt + c, correct + k
    denom = torch.clamp_min(cnt, 1.0)
    return nll_sum / denom, correct / denom
