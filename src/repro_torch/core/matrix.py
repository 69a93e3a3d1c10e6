"""Block matrix storage (paper §5.1) over torch tensors.

A ``BlockMatrix`` stores a dense backing tensor plus an explicit
block-level nonzero mask: zero blocks are never touched by the
sparsity-aware kernels, while nonzero blocks stay dense so a kernel sees
aligned tiles. NULL ≡ implicit zero, matching the paper's sparse-overlay
semantics (Fig. 4; Γnnz counts nonzeros, Γavg divides by nnz).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256  # kernel tile edge; the paper used 1000 for CPU


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class BlockMatrix:
    """Dense value + block nonzero mask + partitioning scheme tag.

    The mask is computed LAZILY on first access: dense-only pipelines never
    pay the O(mn) mask scan, while the sparsity-aware paths (block-skip
    joins, masked matmul) get it cached.
    """

    value: torch.Tensor                  # [m, n]
    _mask: Optional[torch.Tensor] = None  # [mb, nb] bool (lazy cache)
    block_size: int = DEFAULT_BLOCK
    scheme: str = "xi"            # paper partitioning scheme tag (r/c/b/xi)

    @property
    def block_mask(self) -> torch.Tensor:
        if self._mask is None:
            self._mask = compute_block_mask(self.value, self.block_size)
        return self._mask

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_dense(cls, value: torch.Tensor, block_size: int = DEFAULT_BLOCK,
                   scheme: str = "xi") -> "BlockMatrix":
        assert value.ndim == 2
        return cls(value, None, block_size, scheme)

    # -- shape helpers --------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.value.shape)  # type: ignore[return-value]

    @property
    def grid(self) -> Tuple[int, int]:
        return tuple(self.block_mask.shape)  # type: ignore[return-value]

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def device(self) -> torch.device:
        return self.value.device

    def nnz(self) -> torch.Tensor:
        return torch.count_nonzero(self.value)

    def to_dense(self) -> torch.Tensor:
        return self.value



def _pad2(value: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
    return F.pad(value, (0, p1, 0, p0)) if (p0 or p1) else value


def compute_block_mask(value: torch.Tensor, block_size: int) -> torch.Tensor:
    m, n = value.shape
    mb, nb = _ceil_div(m, block_size), _ceil_div(n, block_size)
    padded = _pad2(value, mb * block_size - m, nb * block_size - n)
    tiles = padded.reshape(mb, block_size, nb, block_size)
    return (tiles != 0).any(dim=3).any(dim=1)


def blocks_of(value: torch.Tensor, block_size: int) -> torch.Tensor:
    """Reshape [m, n] (padded) into [mb, nb, bs, bs] tiles."""
    m, n = value.shape
    mb, nb = _ceil_div(m, block_size), _ceil_div(n, block_size)
    padded = _pad2(value, mb * block_size - m, nb * block_size - n)
    return padded.reshape(mb, block_size, nb, block_size).permute(0, 2, 1, 3)


def unblock(tiles: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Inverse of ``blocks_of``: [mb, nb, bs, bs] → [m, n]."""
    mb, nb, bs, _ = tiles.shape
    full = tiles.permute(0, 2, 1, 3).reshape(mb * bs, nb * bs)
    return full[:m, :n]


# ---------------------------------------------------------------------------
# Block-mask algebra (plan-time, host numpy): the closed set of rules by
# which block nonzero masks propagate through operators. A mask is a
# CONSERVATIVE certificate — ``mask[i, j] == False`` guarantees block
# (i, j) is all zeros; True only means "possibly nonzero". Every rule
# below preserves that invariant (no false negatives), which is what lets
# the staged executor skip dead blocks and size COO capacities soundly
# (``repro_torch.plan.masks`` runs these over the physical DAG).
# ---------------------------------------------------------------------------

def mask_grid(shape: Tuple[int, int], block_size: int) -> Tuple[int, int]:
    return (_ceil_div(shape[0], block_size), _ceil_div(shape[1], block_size))


def mask_ones(shape: Tuple[int, int], block_size: int) -> np.ndarray:
    return np.ones(mask_grid(shape, block_size), bool)


def mask_matmul(ma: np.ndarray, mb: np.ndarray) -> np.ndarray:
    """Block mask of A×B: out[i,j] = ∨_k (ma[i,k] ∧ mb[k,j])."""
    return (ma.astype(np.int64) @ mb.astype(np.int64)) > 0


def mask_overlay(inducing_x: bool, inducing_y: bool, ma: np.ndarray,
                 mb: np.ndarray) -> np.ndarray:
    """Block mask of an overlay f(A, B) under f's sparsity profile:
    inducing on both sides ⇒ ma ∧ mb; on one ⇒ that side's mask;
    non-inducing f can be nonzero anywhere (f(0,0) ≠ 0 is allowed)."""
    if inducing_x and inducing_y:
        return ma & mb
    if inducing_x:
        return ma.copy()
    if inducing_y:
        return mb.copy()
    return np.ones_like(ma)


def _block_extents(dim: int, blocks: int, block_size: int) -> np.ndarray:
    """Entry count of each block along one axis (the last one is ragged)."""
    ext = np.full(blocks, block_size, np.int64)
    if blocks:
        ext[-1] = dim - (blocks - 1) * block_size
    return ext


def mask_nnz_cap(mask: np.ndarray, shape: Tuple[int, int],
                 block_size: int) -> float:
    """Upper bound on nnz implied by a block mask (ragged edges counted)."""
    rh = _block_extents(shape[0], mask.shape[0], block_size)
    cw = _block_extents(shape[1], mask.shape[1], block_size)
    return float((rh[:, None] * cw[None, :])[mask].sum())


def mask_band_nnz_caps(mask: np.ndarray, shape: Tuple[int, int],
                       block_size: int) -> np.ndarray:
    """Per-block-row nnz upper bounds (for keyed-join capacity bounds)."""
    rh = _block_extents(shape[0], mask.shape[0], block_size)
    cw = _block_extents(shape[1], mask.shape[1], block_size)
    return (mask * cw[None, :]).sum(axis=1) * rh
