"""AdamW with decoupled weight decay over the port's nested dicts.

The JAX package's math, written out: decay only on matrices
(``p.ndim >= 2``), bias corrections from an f32 step count, a warmup +
cosine schedule in f32. ``torch.optim.AdamW`` is not that function: it
decays every tensor it is given and schedules apart from the step.

``update`` writes the parameters and both moments in place under
``torch.no_grad()`` — the counterpart of the JAX package's donated state —
so a step holds no second copy of either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.module import tree_items, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor     # int32 scalar on the parameters' device
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    lr_schedule: str = "cosine"      # cosine | constant
    total_steps: int = 10_000

    def init(self, params) -> AdamWState:
        """Zero moments like each parameter (its dtype and device)."""
        device = next(leaf for _, leaf in tree_items(params)).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp_max(s / max(1, self.warmup_steps), 1.0)
        if self.lr_schedule == "cosine":
            t = torch.clamp((s - self.warmup_steps)
                            / max(1, self.total_steps - self.warmup_steps),
                            0.0, 1.0)
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
        else:
            decay = 1.0
        return self.lr * warm * decay

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        """One step: the moments, then ``p - lr·(m̂/(√v̂+eps) + wd·p)``
        (``wd`` on matrices only). ``params`` and the moments are updated
        in place and returned with the new count."""
        count = state.count + 1
        lr = self._lr_at(count)
        b1, b2 = self.b1, self.b2
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        for (path, p), (_, g), (_, m), (_, v) in zip(
                tree_items(params), tree_items(grads), tree_items(state.m),
                tree_items(state.v)):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay and p.ndim >= 2:   # decay matrices only
                step = step + self.weight_decay * p
            p.sub_(lr * step)
        return params, AdamWState(count, state.m, state.v)


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf in f32, leaves in sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for _, g in tree_items(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))`` in place;
    returns (the tree, the norm before clipping).
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for _, g in tree_items(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm
