"""Bloom filters over matrix entries for V2V Bloom-joins (paper §4.7).

Entries are float values; their float32 bit patterns are hashed with k
independent multiply-shift hashes into a power-of-two bitset stored as a
uint32 tensor (bit-identical to the JAX package's filter, so a filter
built by either probes correctly in the other). Zero values are NOT
inserted when the merge function is sparsity-inducing.

Torch has no unsigned 32-bit shifts or products, so the hash runs in
int64 on 32-bit values, masked back to 32 bits after every step. The
CUDA probe kernel (``repro_torch.kernels.bloom_probe``) runs the same
hash in native ``uint32_t`` over the same bitset layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Knuth-style odd multipliers for multiply-shift hashing.
_MULTIPLIERS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1], np.uint32
)
_MIX = 0x2C1B3C6D
_LO32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BloomParams:
    log2_bits: int = 20  # 1M bits = 128 KiB default
    num_hashes: int = 3

    @property
    def n_bits(self) -> int:
        return 1 << self.log2_bits

    @property
    def n_words(self) -> int:
        return self.n_bits // 32


def _value_keys(vals: torch.Tensor) -> torch.Tensor:
    """Map float values to their float32 bit patterns, as int64 in
    [0, 2³²) (exact equality semantics: x == y ⇒ key(x) == key(y))."""
    bits = vals.to(torch.float32).contiguous().view(torch.int32)
    return bits.to(torch.int64) & _LO32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for h, c < 2³², without leaving int64: split c into
    16-bit halves so no partial product reaches 2⁶³."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _LO32


def _hash(keys: torch.Tensor, i: int, log2_bits: int) -> torch.Tensor:
    h = _mul32(keys, int(_MULTIPLIERS[i % len(_MULTIPLIERS)]))
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX)
    h = h ^ (h >> 12)
    return h >> (32 - log2_bits)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bool[n_bits] tensor into uint32[n_bits // 32] (LSB-first)."""
    n_words = bits.shape[0] // 32
    lanes = bits.reshape(n_words, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(lanes << shifts, dim=1)
    # two's-complement int32 holds the same 32 bits; uint32 is a view
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint32)


def build(vals: torch.Tensor, params: BloomParams = BloomParams(),
          skip_zeros: bool = True) -> torch.Tensor:
    """Build a bitset (uint32[n_words]) containing all (nonzero) values.

    A boolean scatter into bit positions followed by a pack — scatter of
    ``True`` is idempotent, so duplicate hash targets are safe. Dead
    entries scatter into one extra sentinel slot, dropped before packing.
    """
    flat = vals.reshape(-1)
    live = (flat != 0) if skip_zeros else torch.ones_like(flat, dtype=torch.bool)
    return build_live(flat, live, params)


def build_live(vals: torch.Tensor, live: torch.Tensor,
               params: BloomParams = BloomParams()) -> torch.Tensor:
    """Build a bitset (uint32[n_words]) of the values where ``live`` holds
    (``vals`` and ``live`` flat, of one length)."""
    keys = _value_keys(vals)
    bits = torch.zeros(params.n_bits + 1, dtype=torch.bool, device=vals.device)
    sentinel = params.n_bits
    for i in range(params.num_hashes):
        idx = torch.where(live, _hash(keys, i, params.log2_bits), sentinel)
        bits[idx] = True
    return pack_bits(bits[:params.n_bits])


def probe(words: torch.Tensor, vals: torch.Tensor,
          params: BloomParams = BloomParams()) -> torch.Tensor:
    """Return bool mask: True where the value *may* be in the filter."""
    keys = _value_keys(vals.reshape(-1))
    w32 = words.view(torch.int32)
    hit = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(params.num_hashes):
        idx = _hash(keys, i, params.log2_bits)
        w = w32[idx >> 5].to(torch.int64) & _LO32
        hit = hit & (((w >> (idx & 31)) & 1) == 1)
    return hit.reshape(vals.shape)


def to_numpy_words(words: torch.Tensor) -> np.ndarray:
    """Host view of a bitset as ``np.uint32`` (the JAX package's layout)."""
    return words.view(torch.int32).cpu().numpy().view(np.uint32)


def from_numpy_words(words: np.ndarray, device="cpu") -> torch.Tensor:
    """A ``np.uint32`` bitset (e.g. built by the JAX package) on ``device``."""
    host = np.array(words, np.uint32).view(np.int32)   # a writable copy
    return torch.as_tensor(host, device=device).view(torch.uint32)
