"""Cross-entropy loss with label masking, computed in f32.

``softmax_cross_entropy`` takes materialized logits;
``chunked_softmax_cross_entropy`` unembeds the hidden states a sequence
chunk at a time, so the logits of one chunk ([B, chunk, V]) are the
largest activation. Each chunk runs under activation recompute: autograd
keeps the chunk's inputs, not its logits, which the backward recomputes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import remat

IGNORE = -100


def _masked_sums(lf: torch.Tensor, labels: torch.Tensor, z_loss: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Σ nll, Σ mask, Σ correct) over the unmasked positions of f32
    logits ``lf`` [..., V]. ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    lse = torch.logsumexp(lf, dim=-1)
    safe = labels.clamp_min(0).long()
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels != IGNORE).to(torch.float32)
    correct = (torch.argmax(lf, dim=-1) == safe).to(torch.float32) * mask
    return (nll * mask).sum(), mask.sum(), correct.sum()


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

    w_out [V, d] (tied or unembed weight), x [B,S,d] hidden states. The
    chunks' sums are added in sequence order, as the JAX package's scan
    adds them."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    w = w_out.to(x.dtype)      # cast once; each chunk reads the cast copy

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
