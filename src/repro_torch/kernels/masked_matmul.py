"""Block-masked matrix product (``masked_matmul``), the PNMF pattern.

For sparse A, ``A ∘ (W × H)`` needs only the blocks of W×H that land
under live blocks of A (paper §6, PNMF): the output tile (i, j) of
``block_size``² is computed where ``out_block_mask[i, j]`` is set and is
zero otherwise. Products accumulate in ``promote_types(dtype, float32)``
— float32 for float32 and bfloat16, float64 for float64, as the Pallas
body's ``preferred_element_type`` — and are returned in A's dtype.

``masked_matmul_plain`` is the plain PyTorch version (any device);
``masked_matmul_cuda`` launches the kernel of ``csrc/masked_matmul.cu`` on
CUDA tensors and raises on anything else. That kernel is a persistent
pool of CTAs (``pool()``: SMs × CTAs per SM) that take 128 × 128 output
units from an atomic work counter: a dead unit is a stream of 16-byte
zero stores, a live one an FFMA product with an 8 × 8 register tile per
thread. Its launch parameter is ``kc``, the K chunk staged in shared
memory (``GRID``, the autotuner's candidates; the default 32): each
element sums k in ascending order whatever the chunk, so every member of
the grid writes the same bits. float64 runs a plain tiled DFMA kernel of
the same source (64 × 64 output tiles, one CTA each, K staged by the same
``kc``), with the same rule: every ``kc`` gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.registry import Tiles, checked_tiles

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
GRID = ({"kc": 16}, {"kc": 32}, {"kc": 64})
DEFAULT_TILES = {"kc": 32}


def masked_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                        out_block_mask: torch.Tensor, *,
                        block_size: int = 256,
                        tiles: Tiles = None) -> torch.Tensor:
    """Full product, then zero the output tiles the mask leaves out. It
    multiplies in ``promote_types(a.dtype, float32)``, as the Pallas body
    accumulates (float32 for float32 and bfloat16, float64 for float64).
    ``tiles`` is ignored."""
    acc = torch.promote_types(a.dtype, torch.float32)
    full = torch.matmul(a.to(acc), b.to(acc)).to(a.dtype)
    big = out_block_mask.repeat_interleave(block_size, 0) \
        .repeat_interleave(block_size, 1)
    return torch.where(big[: full.shape[0], : full.shape[1]], full,
                       torch.zeros((), dtype=full.dtype, device=full.device))


def masked_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                       out_block_mask: torch.Tensor, *,
                       block_size: int = 256,
                       tiles: Tiles = None) -> torch.Tensor:
    """Launch the CUDA kernel: a persistent pool of CTAs over 128 × 128
    output units, staging K in chunks of ``tiles["kc"]`` (a member of
    ``GRID``; None: ``DEFAULT_TILES``).

    ``a`` [M, K] and ``b`` [K, N] share float32, bfloat16 or float64 (the
    float64 kernel accumulates in double).
    ``out_block_mask`` is bool [ceil(M/bs), ceil(N/bs)]. The operands'
    strides go to the kernel, so a transposed view is read in place and
    no operand is copied (float32 operands with unit inner stride and
    16-byte aligned rows take the kernel's 16-byte load paths, others its
    element loads; both give the same bits); the mask is made contiguous.
    The work counter, the last argument of the launch, is a fresh int32
    zero on the device for every call, so no call sees a count left by
    another. The output is a new contiguous [M, N] tensor in which every
    element is written, each 128 × 128 unit by one CTA in a fixed order:
    the same inputs give the same bits on every launch. It launches on
    the operands' card, whichever is current (the pool and its
    shared-memory opt-in are set once a card)."""
    kc = checked_tiles("masked_matmul", tiles, GRID, DEFAULT_TILES)["kc"]
    dev = a.device
    ins = (a, b, out_block_mask)
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("masked_matmul_cuda needs every input on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    if a.dtype != b.dtype or a.dtype not in _VALUE_CODES:
        raise TypeError(f"a and b must share float32/bfloat16/float64, got "
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
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):       # the operands' card, not the current
        rc = build.function("masked_matmul_launch")(
            _VALUE_CODES[a.dtype], kc, a.data_ptr(), b.data_ptr(),
            mask.data_ptr(),
            out.data_ptr(), m, n, k, *a.stride(), *b.stride(), bs,
            build.stream_ptr(a), counter.data_ptr())
    build.check(rc, "masked_matmul")
    build.count_launch("masked_matmul")
    return out


def pool(tiles: Tiles = None) -> Tuple[int, int]:
    """(SMs, CTAs per SM) of ``masked_matmul_cuda``'s persistent pool for
    float32 and ``tiles`` (None: ``DEFAULT_TILES``) on the current CUDA
    device, as the launch sizes its grid."""
    kc = checked_tiles("masked_matmul", tiles, GRID, DEFAULT_TILES)["kc"]
    sms, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = build.function("masked_matmul_pool")(
        _VALUE_CODES[torch.float32], kc, ctypes.byref(sms),
        ctypes.byref(per_sm))
    build.check(rc, "masked_matmul pool query")
    return sms.value, per_sm.value
