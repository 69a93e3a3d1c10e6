"""Family dispatcher: one uniform interface over all 10 architectures.

    spec(cfg)                      → ParamSpec tree
    forward(params, cfg, batch)    → (logits, aux)       [train math]
    prefill(params, cfg, batch, max_seq) → (logits, caches)
    decode_step(params, cfg, caches, token, pos) → (logits, caches)
    cache_abstract(cfg, batch, max_seq [, enc_len])

``params`` is a nested dict of tensors, like the JAX package's pytree, so
``params_from_reference`` is a tree map. ``decode_step`` updates the
caches in place and returns them. ``LanguageModel`` holds the same tree
as ``nn.Parameter``s.

Under a device mesh (``sharding.ctx.use_sharding`` over a ``DeviceMesh``)
the parameters, inputs and caches are DTensors and the three entry points
run the JAX package's sharded program, for every family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import apply_norm
from repro_torch.models.module import (
    ParamSpec, init_params, tree_items, tree_map, tree_unbind,
)
from repro_torch.sharding.specs import pin_caches


def spec(cfg: ModelConfig) -> Dict:
    """The ParamSpec tree; every leaf is stored in ``cfg.param_dtype`` (f32
    by default, as every leaf of the JAX package's tree)."""
    tree = (encdec_mod.encdec_spec(cfg) if cfg.family == "audio"
            else lm_mod.lm_spec(cfg))
    return tree_map(lambda s: dataclasses.replace(s, dtype=cfg.param_dtype),
                    tree)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.family == "audio":
        return encdec_mod.encdec_forward(params, cfg, batch["frames"],
                                         batch["tokens"])
    return lm_mod.lm_forward(params, cfg, batch["tokens"],
                             batch.get("img_embeds"))


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_seq: int) -> Tuple[torch.Tensor, Any]:
    if cfg.family == "audio":
        memory = encdec_mod.encode(params, cfg, batch["frames"])
        logits = encdec_mod.decode_train(params, cfg, batch["tokens"],
                                         memory)
        self_c = _encdec_self_cache(params, cfg, batch["tokens"], memory,
                                    max_seq)
        cross_c = encdec_mod.build_cross_cache(params, cfg, memory)
        return logits, pin_caches(cfg, {"self": self_c, "cross": cross_c})
    return lm_mod.lm_prefill(params, cfg, batch["tokens"], max_seq,
                             batch.get("img_embeds"))


def _encdec_self_cache(params, cfg, tokens, memory, max_seq):
    """The decoder's self-attention caches, layer by layer."""
    x = encdec_mod.embed_tokens(params, cfg, tokens)
    caches = []
    for pp in tree_unbind(params["dec"]["layers"], cfg.n_layers):
        h = apply_norm(pp["ln1"], x, cfg.norm)
        caches.append(attn.prefill_kv(pp["self_attn"], cfg, h, max_seq))
        x = encdec_mod.decoder_layer(pp, cfg, x, memory)
    return tree_map(lambda *xs: torch.stack(xs), *caches)


def cache_abstract(cfg: ModelConfig, batch: int, max_seq: int,
                   enc_len: int = 0):
    if cfg.family == "audio":
        return encdec_mod.encdec_cache_abstract(cfg, batch, max_seq,
                                                enc_len or max_seq)
    return lm_mod.cache_abstract(cfg, batch, max_seq)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                enc_len: int = 0, device=None):
    """Zero caches on ``device`` (``None`` → the card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda st: torch.zeros(st.shape, dtype=st.dtype, device=dev),
        cache_abstract(cfg, batch, max_seq, enc_len))


def decode_step(params, cfg: ModelConfig, caches, token, pos):
    if cfg.family == "audio":
        return encdec_mod.encdec_decode_step(params, cfg, caches, token, pos)
    return lm_mod.lm_decode_step(params, cfg, caches, token, pos)


# ---------------------------------------------------------------------------
# Parameters from the JAX package, and the nn.Module view.
# ---------------------------------------------------------------------------

def params_from_reference(np_tree: Dict, cfg: ModelConfig, device
                          ) -> Dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays, turned into the
    port's on ``device``. Every key, shape and dtype is checked against
    ``spec(cfg)``; a missing, extra or mismatched leaf raises."""
    dev = resolve_device(device)
    want = dict(tree_items(spec(cfg)))
    got = dict(tree_items(np_tree))
    if set(want) != set(got):
        missing = sorted("/".join(k) for k in set(want) - set(got))
        extra = sorted("/".join(k) for k in set(got) - set(want))
        raise KeyError(f"parameter keys differ from spec({cfg.arch_id}): "
                       f"missing {missing}, extra {extra}")

    def convert(s: ParamSpec, a) -> torch.Tensor:
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a, copy=True))
        if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
            raise ValueError(f"leaf {tuple(a.shape)} {a.dtype.name} does not "
                             f"match spec {tuple(s.shape)} {s.dtype}")
        return t.to(dev)

    return tree_map(convert, spec(cfg), np_tree)


def _as_parameters(tree) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _as_parameters(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


def _as_tree(pdict: nn.ParameterDict) -> Dict[str, Any]:
    return {k: _as_tree(v) if isinstance(v, nn.ParameterDict) else v
            for k, v in pdict.items()}


class LanguageModel(nn.Module):
    """One of the ten architectures as an ``nn.Module``: the parameter tree
    of ``spec(cfg)`` drawn from ``generator`` (seed 0 by default) on
    ``device`` (``None`` → the card) and registered as nested
    ``nn.ParameterDict``s."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.params = _as_parameters(init_params(spec(cfg), generator, dev))

    def tree(self) -> Dict[str, Any]:
        """The parameters as the nested dict the functions above take."""
        return _as_tree(self.params)

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.tree(), self.cfg, batch)

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], max_seq: int):
        return prefill(self.tree(), self.cfg, batch, max_seq)

    @torch.inference_mode()
    def decode_step(self, caches, token: torch.Tensor, pos):
        return decode_step(self.tree(), self.cfg, caches, token, pos)
