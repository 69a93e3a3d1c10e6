"""Block-masked matrix product (``masked_matmul``), the PNMF pattern.

For sparse A, ``A ∘ (W × H)`` needs only the blocks of W×H that land
under live blocks of A (paper §6, PNMF): the output tile (i, j) of
``block_size``² is computed where ``out_block_mask[i, j]`` is set and is
zero otherwise. Products accumulate in float32 and are returned in A's
dtype.

``masked_matmul_plain`` is the plain PyTorch version (any device);
``masked_matmul_cuda`` launches the kernel of ``csrc/masked_matmul.cu`` on
CUDA tensors and raises on anything else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def masked_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                        out_block_mask: torch.Tensor, *,
                        block_size: int = 256) -> torch.Tensor:
    """Full product, then zero the output tiles the mask leaves out. Like
    the JAX package's dense oracle, it multiplies in float32 whatever the
    input dtype."""
    full = torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)
    big = out_block_mask.repeat_interleave(block_size, 0) \
        .repeat_interleave(block_size, 1)
    return torch.where(big[: full.shape[0], : full.shape[1]], full,
                       torch.zeros((), dtype=full.dtype, device=full.device))


def masked_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                       out_block_mask: torch.Tensor, *,
                       block_size: int = 256) -> torch.Tensor:
    """Launch the CUDA kernel (one CTA per 64 × 64 output sub-tile).

    ``a`` [M, K] and ``b`` [K, N] share float32 or bfloat16; float64 raises
    ``TypeError`` (the card kernel accumulates in float32 only).
    ``out_block_mask`` is bool [ceil(M/bs), ceil(N/bs)]. The operands'
    strides go to the kernel, so a transposed view is read in place and
    no operand is copied; the mask is made contiguous. The output is a new
    contiguous [M, N] tensor in which every element is written."""
    dev = a.device
    ins = (a, b, out_block_mask)
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("masked_matmul_cuda needs every input on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    if a.dtype != b.dtype or a.dtype not in _VALUE_CODES:
        raise TypeError(f"a and b must share float32/bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    bs = int(block_size)
    if bs <= 0:
        raise ValueError(f"block_size {bs}")
    grid = (-(-m // bs), -(-n // bs))
    if tuple(out_block_mask.shape) != grid \
            or out_block_mask.dtype != torch.bool:
        raise ValueError(f"out_block_mask must be bool {grid}, got "
                         f"{out_block_mask.dtype} "
                         f"{tuple(out_block_mask.shape)}")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    mask = out_block_mask.contiguous()
    rc = build.library().masked_matmul_launch(
        _VALUE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), mask.data_ptr(),
        out.data_ptr(), m, n, k, *a.stride(), *b.stride(), bs,
        build.stream_ptr(a))
    build.check(rc, "masked_matmul")
    build.count_launch("masked_matmul")
    return out
