"""Poisson non-negative matrix factorization (paper §6, Table 6).

The port's copy of the JAX package's PNMF pipeline
(``benchmarks/bench_pnmf.py`` and ``examples/pnmf.py``). Optimized
execution: the sparsity-inducing ``A ∘ (W×H)`` goes through
``masked_matmul``, so only the W×H blocks under live A blocks are
computed; ``E×Hᵀ`` and ``WᵀE`` collapse to row and column sums
(aggregation pushdown). Naive execution forms W×H everywhere. The dense
products ``ratio @ Hᵀ`` and ``W2ᵀ @ ratio2`` stay ``torch.matmul``, as the
JAX package leaves them outside any kernel.

    python -m repro_torch.pnmf                # on the card
    python -m repro_torch.pnmf --device cpu   # plain versions on the CPU
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.matrix import compute_block_mask
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

K = 32
BS = 256


def _safe_ratio(a: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``a / wh`` where ``wh`` is nonzero, else 0."""
    return torch.where(wh == 0, 0.0, a / torch.where(wh == 0, 1.0, wh))


def pnmf_naive_step(a: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                    e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ratio = _safe_ratio(a, w @ h)
    w2 = w * (ratio @ h.T) / torch.clamp_min(e @ h.T, 1e-9)
    ratio2 = _safe_ratio(a, w2 @ h)
    h2 = h * (w2.T @ ratio2) / torch.clamp_min(w2.T @ e, 1e-9)
    return w2, h2


def pnmf_opt_step(a: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                  h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparsity-aware update: W×H only under live A blocks; E×Hᵀ and WᵀE
    collapse to row/column sums (aggregation pushdown)."""
    ratio = _safe_ratio(a, kops.masked_matmul(w, h, mask, block_size=BS))
    denom_w = torch.sum(h, dim=1)[None, :]             # E×Hᵀ = Γsum,r(H)ᵀ
    w2 = w * (ratio @ h.T) / torch.clamp_min(denom_w, 1e-9)
    ratio2 = _safe_ratio(a, kops.masked_matmul(w2, h, mask, block_size=BS))
    denom_h = torch.sum(w2, dim=0)[:, None]            # WᵀE = Γsum,c(W)ᵀ
    h2 = h * (w2.T @ ratio2) / torch.clamp_min(denom_h, 1e-9)
    return w2, h2


def objective(a: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """f = Σ(W×H) − Σ A∗log(W×H), with both rewrites applied."""
    total = torch.sum(torch.sum(w, dim=0) * torch.sum(h, dim=1))  # Eq. 10
    wh = kops.masked_matmul(w, h, mask, block_size=BS)
    lg = torch.where((a != 0) & (wh > 0),
                     torch.log(torch.where(wh > 0, wh, 1.0)), 0.0)
    return total - torch.sum(a * lg)


def from_numpy(a: np.ndarray, w: np.ndarray, h: np.ndarray,
               device: Union[str, torch.device]):
    """The reference's numpy inputs on ``device``, with A's block mask:
    ``(a, w, h, mask)``."""
    a_t, w_t, h_t = (torch.as_tensor(np.asarray(x), device=device)
                     for x in (a, w, h))
    return a_t, w_t, h_t, compute_block_mask(a_t, BS)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n = 1500
    a = np.where(rng.uniform(size=(n, n)) < 1e-3,
                 np.abs(rng.normal(size=(n, n))), 0).astype(np.float32)
    w = np.abs(rng.normal(size=(n, K))).astype(np.float32)
    h = np.abs(rng.normal(size=(K, n))).astype(np.float32)
    a, w, h, mask = from_numpy(a, w, h, device)
    print(f"A: {tuple(a.shape)}, nnz={int((a != 0).sum())}, "
          f"nonzero blocks {int(mask.sum())}/{mask.numel()}, "
          f"device {device}")

    for it in range(12):
        if it % 3 == 0:
            f = float(objective(a, mask, w, h))
            print(f"[iter {it:2d}] objective={f:,.1f}")
        w, h = pnmf_opt_step(a, mask, w, h)
    print(f"[iter 12] objective={float(objective(a, mask, w, h)):,.1f}")


if __name__ == "__main__":
    main()
