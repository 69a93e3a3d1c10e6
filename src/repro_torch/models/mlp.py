"""Feed-forward blocks: SwiGLU / GELU (RWKV's squared-ReLU channel mix
lives in ``rwkv.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import reduce_partial, shard_act, weight


def mlp_spec(cfg: ModelConfig, layers: Optional[int] = None,
             d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    if cfg.activation == "swiglu":
        return {
            "w_gate": ParamSpec(lead + (d, f), la + ("embed", "ffn")),
            "w_up": ParamSpec(lead + (d, f), la + ("embed", "ffn")),
            "w_down": ParamSpec(lead + (f, d), la + ("ffn", "embed")),
        }
    return {
        "w_up": ParamSpec(lead + (d, f), la + ("embed", "ffn")),
        "b_up": ParamSpec(lead + (f,), la + ("ffn",), "zeros"),
        "w_down": ParamSpec(lead + (f, d), la + ("ffn", "embed")),
        "b_down": ParamSpec(lead + (d,), la + ("embed",), "zeros"),
    }


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.activation == "swiglu":
        g = x @ weight(p["w_gate"], dt)
        u = x @ weight(p["w_up"], dt)
        h = shard_act(F.silu(g) * u, "batch", None, "act_ffn")
        return reduce_partial(h @ weight(p["w_down"], dt))
    h = x @ weight(p["w_up"], dt) + weight(p["b_up"], dt)
    # jax.nn.gelu's default is the tanh approximation
    h = shard_act(F.gelu(h, approximate="tanh"), "batch", None, "act_ffn")
    return (reduce_partial(h @ weight(p["w_down"], dt))
            + weight(p["b_down"], dt))
