"""Plain PyTorch versions of the two PNMF kernels (``masked_matmul``,
``sddmm_agg``), which have no CUDA kernel yet.

They keep the planner's DAG identical to the JAX package's (the
MASKED_ELEMWISE / MASKED_AGG nodes exist and run on the CPU); on a CUDA
tensor the registry raises ``NotImplementedError`` instead (ROADMAP, the
PNMF slice). The three join kernels keep their plain versions beside
their CUDA wrappers (``coo_join``, ``bloom_probe``, ``merge_join``).
"""
from __future__ import annotations

import torch

DIMS = ("row", "col", "all")


def masked_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                      out_block_mask: torch.Tensor, *,
                      block_size: int = 256) -> torch.Tensor:
    """Full matmul, then zero the output tiles the mask leaves out."""
    full = torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)
    big = out_block_mask.repeat_interleave(block_size, 0) \
        .repeat_interleave(block_size, 1)
    return torch.where(big[: full.shape[0], : full.shape[1]], full,
                       torch.zeros((), dtype=full.dtype, device=full.device))


def sddmm_agg_ref(sp: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                  out_block_mask: torch.Tensor, *, dim: str,
                  block_size: int = 256) -> torch.Tensor:
    """Factorized SUM of ``sp ∘ (W·H)``: never forms the m×n product.

    ``rowsum_j sp[i,j]·(W·H)[i,j] = Σ_k W[i,k]·(sp·Hᵀ)[i,k]`` (and the
    transposed identity for columns). The mask is not needed: sp's zeros
    already gate the sum.
    """
    if dim == "row":
        return torch.sum(w * (sp @ h.T), dim=1)[:, None]
    if dim == "col":
        return torch.sum(h * (w.T @ sp), dim=0)[None, :]
    if dim == "all":
        return torch.sum(w * (sp @ h.T)).reshape(1, 1)
    raise ValueError(f"dim {dim!r} not in {DIMS}")
