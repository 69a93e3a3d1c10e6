"""Block-skip overlay-join kernel (``merge_join``).

Direct/transpose overlay joins (paper §4.3) evaluate an elementwise merge
over two matrices. With a sparsity-inducing merge (§4.7) whole blocks are
skipped: the kernel receives both block masks and a ``mode`` saying which
side(s) the merge induces on, and a dead tile gets only its zero store —
its inputs are never read.

``merge_join_plain`` is the plain PyTorch version (any device);
``merge_join_cuda`` launches the kernel of ``csrc/merge_join.cu`` on a
CUDA tensor and raises on anything else. ``b_layout`` is its rule for how
the kernel reads B: in place when B is contiguous or a transposed view of
a contiguous matrix (a transpose overlay's ``b.T``), else a copy. The
merge reaches the kernel as ``merge_codes.merge_code``'s code: a bilinear
merge or the safe division runs in the main library's code instances, any
other merge in the op set in its own generated instances
(``build.merge_function``, built at the merge's first launch), and a merge
the compiler refuses raises ``NotImplementedError`` before anything is
built or launched.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.merge_codes import GENERATED, merge_code
from repro_torch.kernels.registry import Tiles, checked_tiles

# compute-gating modes derived from the sparsity profile of the merge fn
MODE_BOTH = 0   # inducing on x and y: compute where maskA & maskB
MODE_X = 1      # inducing on x:       compute where maskA
MODE_Y = 2      # inducing on y:       compute where maskB
MODE_ALL = 3    # not inducing:        compute everywhere

_VALUE_CODES = {torch.float32: 0, torch.float64: 1}


def mode_for(inducing_x: bool, inducing_y: bool) -> int:
    """The single profile→mode rule (``core.matrix.mask_overlay`` is its
    block-mask twin — keep the two in lockstep)."""
    if inducing_x and inducing_y:
        return MODE_BOTH
    if inducing_x:
        return MODE_X
    if inducing_y:
        return MODE_Y
    return MODE_ALL


def live_tiles(mask_a: torch.Tensor, mask_b: torch.Tensor,
               mode: int) -> torch.Tensor:
    """Per-tile gate of ``mode`` over the two block masks."""
    if mode == MODE_BOTH:
        return mask_a & mask_b
    if mode == MODE_X:
        return mask_a
    if mode == MODE_Y:
        return mask_b
    return torch.ones_like(mask_a)


def merge_join_plain(a: torch.Tensor, b: torch.Tensor, mask_a: torch.Tensor,
                     mask_b: torch.Tensor, *, merge: Callable,
                     mode: int = MODE_ALL,
                     block_size: int = 256,
                     tiles: Tiles = None) -> torch.Tensor:
    live = live_tiles(mask_a, mask_b, mode)
    big = live.repeat_interleave(block_size, 0) \
        .repeat_interleave(block_size, 1)[: a.shape[0], : a.shape[1]]
    out = merge(a, b).to(a.dtype)
    return torch.where(big, out, torch.zeros((), dtype=a.dtype,
                                             device=a.device))


def b_layout(shape: Sequence[int],
             strides: Sequence[int]) -> Tuple[str, int]:
    """How ``merge_join_cuda``'s kernel reads a B of ``shape`` (m, n) and
    element ``strides``: ``("direct", n)`` for a contiguous B (read at
    A's offsets), ``("transposed", ldb)`` for a transposed view of a
    row-major matrix, B[r, c] at c * ldb + r (a contiguous Bo's ``Bo.T``:
    ldb = m), else ``("copy", n)``: the kernel reads ``b.contiguous()``
    directly. A dimension of size 1 takes any stride."""
    m, n = shape
    s0, s1 = strides
    if (n <= 1 or s1 == 1) and (m <= 1 or s0 == n):
        return "direct", n
    if m <= 1 or s0 == 1:
        return "transposed", (s1 if n > 1 else m)
    return "copy", n


def merge_join_cuda(a: torch.Tensor, b: torch.Tensor, mask_a: torch.Tensor,
                    mask_b: torch.Tensor, *, merge: Callable,
                    mode: int = MODE_ALL,
                    block_size: int = 256,
                    tiles: Tiles = None) -> torch.Tensor:
    """Launch the CUDA kernel: one CTA of 256 threads a unit, a tile's
    band of rows. A reads row-major (a non-contiguous A is copied first);
    B as ``b_layout`` says, so a transpose overlay's ``b.T`` is read in
    place and any other non-contiguous B is copied. The kernel has no
    launch parameter: ``tiles`` must be None or empty. More than 2**31 - 1
    units raise ``RuntimeError`` (cudaErrorInvalidValue) before any
    launch. It launches on the operands' card, whichever is current."""
    checked_tiles("merge_join", tiles, (), {})
    dev = a.device
    ins = (a, b, mask_a, mask_b)
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("merge_join_cuda needs every input on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    if a.dtype != b.dtype or a.dtype not in _VALUE_CODES:
        raise TypeError(f"a and b must share float32/float64, got "
                        f"{a.dtype}, {b.dtype}")
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    m, n = a.shape
    bs = int(block_size)
    grid = (-(-m // bs), -(-n // bs))
    if tuple(mask_a.shape) != grid or tuple(mask_b.shape) != grid \
            or mask_a.dtype != torch.bool or mask_b.dtype != torch.bool:
        raise ValueError(f"masks must be bool {grid}, got "
                         f"{tuple(mask_a.shape)}, {tuple(mask_b.shape)}")
    if mode not in (MODE_BOTH, MODE_X, MODE_Y, MODE_ALL):
        raise ValueError(f"unknown mode {mode}")
    code = merge_code(merge)
    layout, ldb = b_layout(tuple(b.shape), b.stride())
    if layout == "copy":
        b, layout, ldb = b.contiguous(), "direct", n
    a = a.contiguous()
    mask_a, mask_b = mask_a.contiguous(), mask_b.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if a.numel() == 0:
        return out
    width = 16 // a.element_size()
    # 16-byte lanes: A's and out's rows (and, read transposed, Bo's rows)
    # start on a 16-byte boundary and hold whole lanes
    vec = int(n % width == 0 and bs % width == 0
              and (layout == "direct" or (m % width == 0
                                          and ldb % width == 0))
              and all(x.data_ptr() % 16 == 0 for x in (a, b, out)))
    args = (_VALUE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
            mask_a.data_ptr(), mask_b.data_ptr(), out.data_ptr(),
            m, n, ldb, bs, mode, vec, int(layout == "transposed"))
    generated = code.op == GENERATED
    with torch.cuda.device(dev):       # the operands' card, not the current
        if generated:
            rc = build.merge_function(code, "merge_join")(
                *args, build.stream_ptr(a))
        else:
            rc = build.function("merge_join_launch")(
                *args, code.op, *code.coeffs, build.stream_ptr(a))
    build.check(rc, "merge_join")
    build.count_launch("merge_join", generated=generated)
    return out
