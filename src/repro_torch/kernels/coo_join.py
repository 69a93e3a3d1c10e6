"""Fused segment-expand + merge COO join kernel (``coo_expand``).

The device join tier (``repro_torch.core.joins_device``) unrolls per-key
match runs into a static ``cap``-slot buffer. The kernel fuses the whole
expansion: each slot's segment comes from a load-balanced search over
the merge of the segment end offsets with the slots (see the kernel's
source), both operands and their coordinates are gathered from the
compacted (nnz-sized) side buffers, the merge is applied in registers,
and only the final ``idx``/``val`` are written.

Inputs (``ns`` = probe-side entries, ``nb`` = partner-side entries):

* ``ends   [ns] int32`` — inclusive prefix sum of per-segment counts;
* ``delta  [ns] int32`` — partner-run base minus own segment start: slot
  ``t`` in segment ``s`` reads partner position ``t + delta[s]``;
* ``a_vals [ns]``, ``a_coords [ns, ca]`` — probe-side values + coords;
* ``b_vals [nb]``, ``b_coords [nb, cb]`` — partner values + coords.

Returns ``(idx [cap, ca+cb], val [cap])``. Slots at or past the true total
hold clamped values the caller masks with its ``valid`` vector.

``coo_expand_plain`` is the plain PyTorch version (any device);
``coo_expand_cuda`` launches the kernel of ``csrc/coo_expand.cu`` on a
CUDA tensor and raises on anything else; a general merge runs in its own
generated instance (``merge_codes``), as in ``merge_join``. Its launch
parameter is ``vt``, the merge items a thread (``GRID``, the autotuner's
candidates; the default 8): it sets each CTA's share of the work, never
the result, so every member of the grid writes the same bits.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.merge_codes import GENERATED, merge_code
from repro_torch.kernels.registry import Tiles, checked_tiles

_VALUE_CODES = {torch.float32: 0, torch.float64: 1}
_COORD_CODES = {torch.int16: 0, torch.int32: 1}
GRID = ({"vt": 4}, {"vt": 6}, {"vt": 8})
DEFAULT_TILES = {"vt": 8}


def coo_expand_plain(ends: torch.Tensor, delta: torch.Tensor,
                     a_vals: torch.Tensor, a_coords: torch.Tensor,
                     b_vals: torch.Tensor, b_coords: torch.Tensor, *,
                     merge: Callable, cap: int, tiles: Tiles = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: segment ids by searchsorted-right over ``ends``
    (clamped to the last segment, as the kernel and the JAX package's
    ``repeat`` padding do), then gathers and the merge. ``tiles`` is
    ignored."""
    ns, nb = ends.shape[0], b_vals.shape[0]
    t = torch.arange(cap, dtype=torch.int32, device=ends.device)
    seg = torch.searchsorted(ends, t, right=True).clamp_(max=ns - 1)
    sb = (t.to(torch.int64) + delta[seg]).clamp_(0, nb - 1)
    val = merge(a_vals[seg], b_vals[sb])
    idx = torch.cat([a_coords[seg], b_coords[sb]], dim=1)
    return idx, val


def coo_expand_cuda(ends: torch.Tensor, delta: torch.Tensor,
                    a_vals: torch.Tensor, a_coords: torch.Tensor,
                    b_vals: torch.Tensor, b_coords: torch.Tensor, *,
                    merge: Callable, cap: int, tiles: Tiles = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; it writes every slot below ``cap``.
    ``tiles`` is a member of ``GRID`` (None: ``DEFAULT_TILES``); with
    float64 values and a ``BILINEAR``/``SAFE_DIV`` merge only the default
    has an instance of the joins' widths, and another ``vt`` raises
    ``ValueError``. A generated merge (``GENERATED``) runs in its
    run-time-width instance, which takes every width and every ``vt`` of
    the grid in float32 and float64. It launches on the operands' card,
    whichever is current (each instance's shared-memory opt-in is set
    once a card)."""
    vt = checked_tiles("coo_expand", tiles, GRID, DEFAULT_TILES)["vt"]
    ins = (ends, delta, a_vals, a_coords, b_vals, b_coords)
    dev = ends.get_device()
    if dev < 0 or any(x.get_device() != dev for x in ins):
        raise ValueError("coo_expand_cuda needs every input on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    ns, nb = ends.shape[0], b_vals.shape[0]
    if ends.dtype != torch.int32 or delta.dtype != torch.int32 \
            or delta.shape != (ns,):
        raise TypeError("ends and delta must be int32 [ns]")
    if a_vals.dtype != b_vals.dtype or a_vals.dtype not in _VALUE_CODES:
        raise TypeError(f"values must share float32/float64, got "
                        f"{a_vals.dtype}, {b_vals.dtype}")
    if a_coords.dtype != b_coords.dtype or a_coords.dtype not in _COORD_CODES:
        raise TypeError(f"coords must share int16/int32, got "
                        f"{a_coords.dtype}, {b_coords.dtype}")
    if a_vals.shape != (ns,) or a_coords.ndim != 2 \
            or a_coords.shape[0] != ns or b_vals.shape != (nb,) \
            or b_coords.ndim != 2 or b_coords.shape[0] != nb:
        raise ValueError("side buffer shapes disagree")
    if ns == 0 or nb == 0:
        raise ValueError("coo_expand needs non-empty side buffers")
    if cap + ns >= 2 ** 31:
        raise ValueError(f"coo_expand_cuda counts slots and segments in "
                         f"int32: cap + ns = {cap + ns} must stay below "
                         "2**31")
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("coo_expand_cuda needs contiguous inputs")
    code = merge_code(merge)
    ca, cb = a_coords.shape[1], b_coords.shape[1]
    if vt != DEFAULT_TILES["vt"] and a_vals.dtype == torch.float64 \
            and (ca, cb) in ((2, 1), (2, 2)) and code.op != GENERATED:
        raise ValueError(f"coo_expand_cuda: vt {vt} has no float64 "
                         f"instance of widths {ca} + {cb} (only "
                         f"{DEFAULT_TILES['vt']})")
    idx = a_coords.new_empty((cap, ca + cb))
    val = a_vals.new_empty((cap,))
    if cap == 0:
        return idx, val
    args = (_VALUE_CODES[a_vals.dtype], _COORD_CODES[a_coords.dtype],
            ends.data_ptr(), delta.data_ptr(), a_vals.data_ptr(),
            a_coords.data_ptr(), b_vals.data_ptr(), b_coords.data_ptr(),
            ns, nb, ca, cb, cap, vt)
    generated = code.op == GENERATED
    with torch.cuda.device(dev):       # the operands' card, not the current
        outs = (idx.data_ptr(), val.data_ptr(), build.stream_ptr(ends))
        if generated:
            rc = build.merge_function(code, "coo_expand")(*args, *outs)
        else:
            rc = build.function("coo_expand_launch")(*args, code.op,
                                                     *code.coeffs, *outs)
    build.check(rc, "coo_expand")
    build.count_launch("coo_expand", generated=generated)
    return idx, val

