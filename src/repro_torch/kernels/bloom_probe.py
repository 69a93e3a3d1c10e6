"""Bloom-filter probe kernel (``bloom_probe``) for V2V Bloom-joins (§4.7).

Per value: the key is the bit pattern of the float32 value; for each of
``num_hashes`` multiply-shift hashes (``repro_torch.core.bloom``) the
kernel tests one bit of the uint32 bitset and ANDs the tests. Filters
built on either the host or the card probe identically on both.

``bloom_probe_plain`` is the plain PyTorch version (any device);
``bloom_probe_cuda`` launches the kernel of ``csrc/bloom_probe.cu`` on a
CUDA tensor and raises on anything else. A bitset of at most 128 KiB
(``log2_bits`` <= 20) is probed from shared memory, copied into each CTA
by TMA bulk copies; a larger one from global memory. ``plan`` says which
launch a call makes. The launch parameter is ``threads``, the shared
path's CTA (``GRID``, the autotuner's candidates; the default 512); the
global path keeps its 256-thread CTA whatever the tile. Each value is
tested on its own, so every member of the grid gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.bloom import BloomParams, probe
from repro_torch.kernels import build
from repro_torch.kernels.registry import Tiles, checked_tiles

_WORD_TYPES = (torch.uint32, torch.int32)
PATHS = {1: "shared", 2: "global"}
GRID = ({"threads": 256}, {"threads": 512}, {"threads": 1024})
DEFAULT_TILES = {"threads": 512}


def bloom_probe_plain(words: torch.Tensor, vals: torch.Tensor, *,
                      num_hashes: int = 3, log2_bits: int = 20,
                      tiles: Tiles = None) -> torch.Tensor:
    """The plain version; ``tiles`` is ignored."""
    return probe(words, vals,
                 BloomParams(log2_bits=log2_bits, num_hashes=num_hashes))


def bloom_probe_cuda(words: torch.Tensor, vals: torch.Tensor, *,
                     num_hashes: int = 3, log2_bits: int = 20,
                     tiles: Tiles = None) -> torch.Tensor:
    """Launch the CUDA kernel → bool, the shape of ``vals``. The checks
    read tensor metadata only; the launch goes on the caller's stream of
    the operands' card, whichever card is current (the shared path's
    opt-in is set once a card). ``tiles`` is a member of ``GRID`` (None:
    ``DEFAULT_TILES``)."""
    threads = checked_tiles("bloom_probe", tiles, GRID,
                            DEFAULT_TILES)["threads"]
    if not vals.is_cuda or words.get_device() != vals.get_device():
        raise ValueError("bloom_probe_cuda needs words and values on one "
                         f"CUDA device, got {words.device}, {vals.device}")
    if words.dtype not in _WORD_TYPES or words.dim() != 1 \
            or words.size(0) != (1 << log2_bits) // 32:
        raise ValueError(f"words must be uint32 [{(1 << log2_bits) // 32}], "
                         f"got {words.dtype} {tuple(words.shape)}")
    if not 5 <= log2_bits <= 31:
        raise ValueError(f"log2_bits {log2_bits} outside [5, 31]")
    if vals.dtype != torch.float32:
        vals = vals.to(torch.float32)   # keys are float32 bit patterns
    flat = vals if vals.dim() == 1 and vals.is_contiguous() \
        else vals.reshape(-1).contiguous()
    if not words.is_contiguous():
        words = words.contiguous()
    out = torch.empty_like(flat, dtype=torch.bool)
    n = out.numel()
    if n:
        with torch.cuda.device(flat.device):   # the operands' card
            rc = build.function("bloom_probe_launch")(
                words.data_ptr(), flat.data_ptr(), n, num_hashes, log2_bits,
                threads, out.data_ptr(), build.stream_ptr(flat))
        build.check(rc, "bloom_probe")
        build.count_launch("bloom_probe")
    return out if vals.dim() == 1 else out.view(vals.shape)


def plan(words: torch.Tensor, vals: torch.Tensor, *, num_hashes: int = 3,
         log2_bits: int = 20, tiles: Tiles = None) -> Dict[str, int]:
    """The launch ``bloom_probe_cuda`` makes for these tensors and tiles:
    path (``shared`` or ``global``), grid, threads a CTA, dynamic
    shared-memory bytes and whether TMA copies the bitset."""
    threads = checked_tiles("bloom_probe", tiles, GRID,
                            DEFAULT_TILES)["threads"]
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(vals.device):
        rc = build.function("bloom_probe_plan")(
            words.data_ptr(), vals.data_ptr(), vals.numel(), num_hashes,
            log2_bits, threads, info)
    build.check(rc, "bloom_probe plan")
    return {"path": PATHS[info[0]], "grid": info[1], "threads": info[2],
            "smem_bytes": info[3], "tma": bool(info[4])}
