"""Fused SDDMM + SUM aggregation (``sddmm_agg``), the PNMF pipelines.

``Agg(sp ∘ (W × H))`` with SUM (paper §6): the product is only consumed
by the reduction, so the m×n masked product never exists. ``dim`` is
``"row"`` (out [m, 1]), ``"col"`` (out [1, n]) or ``"all"`` (out [1, 1]),
the shapes ``core.executor.agg_dense`` gives for ``AggFn.SUM``.

``sddmm_agg_plain`` is the plain PyTorch version (any device): the
factorized form, never forming the m×n product either.
``sddmm_agg_cuda`` launches the kernel of ``csrc/sddmm_agg.cu`` on CUDA
tensors and raises on anything else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DIMS = ("row", "col", "all")
_VALUE_CODES = {torch.float32: 0, torch.float64: 1}


def sddmm_agg_plain(sp: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                    out_block_mask: torch.Tensor, *, dim: str,
                    block_size: int = 256) -> torch.Tensor:
    """Factorized SUM of ``sp ∘ (W·H)``.

    ``rowsum_j sp[i,j]·(W·H)[i,j] = Σ_k W[i,k]·(sp·Hᵀ)[i,k]`` (and the
    transposed identity for columns). The mask is not read: sp's zeros
    gate the sum, so this agrees with the kernel wherever the mask covers
    sp's nonzeros.
    """
    if dim == "row":
        return torch.sum(w * (sp @ h.T), dim=1)[:, None]
    if dim == "col":
        return torch.sum(h * (w.T @ sp), dim=0)[None, :]
    if dim == "all":
        return torch.sum(w * (sp @ h.T)).reshape(1, 1)
    raise ValueError(f"dim {dim!r} not in {DIMS}")


def sddmm_agg_cuda(sp: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                   out_block_mask: torch.Tensor, *, dim: str,
                   block_size: int = 256) -> torch.Tensor:
    """Launch the CUDA kernel: per-tile partials, then a fixed-order sum
    (two launches, counted as one; bit-identical from run to run).

    ``sp`` [M, N], ``w`` [M, K] and ``h`` [K, N] share float32 or float64;
    ``out_block_mask`` is bool [ceil(M/bs), ceil(N/bs)]. A dead tile
    contributes exactly zero, even where ``sp`` is nonzero under it. The
    operands' strides go to the kernel, so a transposed view is read in
    place and no operand is copied; the mask is made contiguous."""
    if dim not in DIMS:
        raise ValueError(f"dim {dim!r} not in {DIMS}")
    dev = sp.device
    ins = (sp, w, h, out_block_mask)
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("sddmm_agg_cuda needs every input on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    if not (sp.dtype == w.dtype == h.dtype) or sp.dtype not in _VALUE_CODES:
        raise TypeError(f"sp, w and h must share float32/float64, got "
                        f"{sp.dtype}, {w.dtype}, {h.dtype}")
    if sp.ndim != 2 or w.ndim != 2 or h.ndim != 2:
        raise ValueError("sp, w and h must be matrices")
    m, n = sp.shape
    k = w.shape[1]
    if w.shape[0] != m or tuple(h.shape) != (k, n):
        raise ValueError(f"shapes sp {tuple(sp.shape)}, w {tuple(w.shape)}, "
                         f"h {tuple(h.shape)}")
    bs = int(block_size)
    if bs <= 0:
        raise ValueError(f"block_size {bs}")
    gm, gn = -(-m // bs), -(-n // bs)
    if tuple(out_block_mask.shape) != (gm, gn) \
            or out_block_mask.dtype != torch.bool:
        raise ValueError(f"out_block_mask must be bool {(gm, gn)}, got "
                         f"{out_block_mask.dtype} "
                         f"{tuple(out_block_mask.shape)}")
    shape = {"row": (m, 1), "col": (1, n), "all": (1, 1)}[dim]
    if m == 0 or n == 0:
        return torch.zeros(shape, dtype=sp.dtype, device=dev)
    part = torch.empty({"row": gn * m, "col": gm * n, "all": gm * gn}[dim],
                       dtype=sp.dtype, device=dev)
    out = torch.empty(shape, dtype=sp.dtype, device=dev)
    mask = out_block_mask.contiguous()
    vec = int(sp.stride(1) == 1 and sp.stride(0) % 4 == 0
              and sp.data_ptr() % 16 == 0 and bs % 4 == 0)
    rc = build.library().sddmm_agg_launch(
        _VALUE_CODES[sp.dtype], sp.data_ptr(), w.data_ptr(), h.data_ptr(),
        mask.data_ptr(), part.data_ptr(), out.data_ptr(), m, n, k,
        *sp.stride(), *w.stride(), *h.stride(), bs, DIMS.index(dim), vec,
        build.stream_ptr(sp))
    build.check(rc, "sddmm_agg")
    build.count_launch("sddmm_agg")
    return out
