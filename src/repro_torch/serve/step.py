"""Serving steps: batched prefill and single-token greedy decode.

The step callables are held in a module-level LRU keyed, as in the JAX
package, on ``(kind, cfg, max_seq)`` / ``(kind, cfg, greedy, donate)``,
so repeated serving calls — ``generate`` invocations, launcher restarts
within one process — reuse one step object instead of building another.
Eager PyTorch runs a step's body on every call (where ``jax.jit`` runs it
only while tracing), so ``trace_count`` counts *builds* of a cached step:
one per key until the LRU evicts it.

Every step runs under ``torch.inference_mode``. A donating decode step
updates the caches it is given in place; a non-donating one clones them
first and leaves the caller's caches as they were.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plancache import VersionedLRU
from repro_torch.models import api as mapi
from repro_torch.models.module import tree_map

# Step callables, LRU-bounded: a long-lived serving process cycling
# through many (cfg, max_seq) shapes must not grow without bound.
_STEP_CACHE = VersionedLRU(capacity=16)
_TRACE_COUNTS: Dict[tuple, int] = {}


def make_prefill_step(cfg: ModelConfig, max_seq: int) -> Callable:
    @torch.inference_mode()
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        logits, caches = mapi.prefill(params, cfg, batch, max_seq)
        return logits[:, -1:], caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, greedy: bool = True,
                     donate: bool = False) -> Callable:
    """Decode one token per row; the next token is the argmax (as the JAX
    package's step, whatever ``greedy`` says)."""
    @torch.inference_mode()
    def decode_step(params, caches, token: torch.Tensor, pos):
        if not donate:
            caches = tree_map(torch.clone, caches)
        logits, caches = mapi.decode_step(params, cfg, caches, token, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits, next_tok[:, None], caches

    return decode_step


def _built(key: tuple, build: Callable[[], Callable]) -> Callable:
    def create():
        _TRACE_COUNTS[key] = _TRACE_COUNTS.get(key, 0) + 1
        return build()

    return _STEP_CACHE.get_or_create(key, create)


def compiled_prefill(cfg: ModelConfig, max_seq: int) -> Callable:
    """The cached prefill step for ``(cfg, max_seq)``, built at most once
    per process (modulo LRU eviction)."""
    return _built(("prefill", cfg, max_seq),
                  lambda: make_prefill_step(cfg, max_seq))


def compiled_decode(cfg: ModelConfig, greedy: bool = True,
                    donate: bool = False) -> Callable:
    """The cached decode step for ``cfg``; ``donate=True`` updates the
    caches in place (the serving launcher's steady-state path)."""
    return _built(("decode", cfg, greedy, donate),
                  lambda: make_decode_step(cfg, greedy, donate))


def trace_count(kind: str, cfg: ModelConfig, *rest) -> int:
    """How many times the cached ``kind`` step for ``cfg`` was built."""
    return _TRACE_COUNTS.get((kind, cfg) + rest, 0)


def first_position(cfg: ModelConfig, prompt_len: int) -> int:
    """The decode position after a prompt (image tokens come first)."""
    return prompt_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0)


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int,
             max_seq: int, enc_batch: Optional[Dict] = None
             ) -> torch.Tensor:
    """Greedy generation loop: [B, n_new] int32 tokens.

    Uses the cached steps; donation stays off on this example path, as in
    the JAX package (the serving launcher opts in via
    ``compiled_decode(donate=True)``).
    """
    batch = dict(enc_batch or {}, tokens=prompt)
    prefill = compiled_prefill(cfg, max_seq)
    step = compiled_decode(cfg)
    logits, caches = prefill(params, batch)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    pos0 = first_position(cfg, prompt.shape[1])
    for i in range(n_new - 1):
        _, tok, caches = step(params, caches, tok, pos0 + i)
        out.append(tok)
    return torch.cat(out, dim=1)
