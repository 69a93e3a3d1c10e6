"""Bloom-filter probe kernel (``bloom_probe``) for V2V Bloom-joins (§4.7).

Per value: the key is the bit pattern of the float32 value; for each of
``num_hashes`` multiply-shift hashes (``repro_torch.core.bloom``) the
kernel tests one bit of the uint32 bitset and ANDs the tests. Filters
built on either the host or the card probe identically on both.

``bloom_probe_plain`` is the plain PyTorch version (any device);
``bloom_probe_cuda`` launches the kernel of ``csrc/bloom_probe.cu`` on a
CUDA tensor and raises on anything else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bloom import BloomParams, probe
from repro_torch.kernels import build


def bloom_probe_plain(words: torch.Tensor, vals: torch.Tensor, *,
                      num_hashes: int = 3, log2_bits: int = 20
                      ) -> torch.Tensor:
    return probe(words, vals,
                 BloomParams(log2_bits=log2_bits, num_hashes=num_hashes))


def bloom_probe_cuda(words: torch.Tensor, vals: torch.Tensor, *,
                     num_hashes: int = 3, log2_bits: int = 20
                     ) -> torch.Tensor:
    """Launch the CUDA kernel (one thread per value) → bool [n]."""
    dev = vals.device
    if dev.type != "cuda" or words.device != dev:
        raise ValueError("bloom_probe_cuda needs words and values on one "
                         f"CUDA device, got {words.device}, {vals.device}")
    if words.dtype not in (torch.uint32, torch.int32) or words.ndim != 1 \
            or words.shape[0] != (1 << log2_bits) // 32:
        raise ValueError(f"words must be uint32 [{(1 << log2_bits) // 32}], "
                         f"got {words.dtype} {tuple(words.shape)}")
    if not 5 <= log2_bits <= 31:
        raise ValueError(f"log2_bits {log2_bits} outside [5, 31]")
    if vals.dtype != torch.float32:
        vals = vals.to(torch.float32)   # keys are float32 bit patterns
    flat = vals.reshape(-1).contiguous()
    words = words.contiguous()
    out = torch.empty(flat.shape, dtype=torch.bool, device=dev)
    if flat.numel() == 0:
        return out.reshape(vals.shape)
    rc = build.library().bloom_probe_launch(
        words.data_ptr(), flat.data_ptr(), ctypes.c_longlong(flat.numel()),
        num_hashes, log2_bits, out.data_ptr(), build.stream_ptr(flat))
    build.check(rc, "bloom_probe")
    build.count_launch("bloom_probe")
    return out.reshape(vals.shape)
