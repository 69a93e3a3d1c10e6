"""Shared neural building blocks: norms, rope, embeddings, projections."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.module import ParamSpec


# --------------------------------------------------------------------------
# Norms.
# --------------------------------------------------------------------------

def norm_spec(d: int, kind: str):
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones"),
                "bias": ParamSpec((d,), ("embed",), "zeros")}
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        # population variance, as jnp.var (torch.var defaults to n - 1)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head q/k norm (qwen3): x [..., head_dim], scale [head_dim]."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings.
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions broadcastable to [..., S].

    Rotates split halves (x[..., :hd/2], x[..., hd/2:]), not interleaved
    pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Dense projections.
# --------------------------------------------------------------------------

def linear_spec(d_in: int, d_out: int, in_axis: str = "embed",
                out_axis: str = "ffn", bias: bool = False,
                layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    lead_ax: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    spec = {"w": ParamSpec(lead + (d_in, d_out),
                           lead_ax + (in_axis, out_axis))}
    if bias:
        spec["b"] = ParamSpec(lead + (d_out,), lead_ax + (out_axis,),
                              "zeros")
    return spec


def apply_linear(p, x: torch.Tensor, dtype) -> torch.Tensor:
    y = x @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


# --------------------------------------------------------------------------
# Embedding / unembedding.
# --------------------------------------------------------------------------

def embed_spec(vocab: int, d: int):
    return ParamSpec((vocab, d), ("vocab", "embed"), "normal", scale=0.02)


def embed(p: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``p`` at ``tokens``, cast to ``dtype``: index first, then
    cast (bit-identical to casting the table first, without casting every
    vocabulary row on each call)."""
    return p[tokens].to(dtype)


def unembed(p: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """Logits via the (possibly tied) embedding: [B,S,d] → [B,S,V]."""
    return x @ p.to(dtype).t()


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    return sinusoid(torch.arange(n, dtype=torch.float32, device=device), d)


def sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding of float positions [...] → [..., d]: sin on
    even, cos on odd features."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device)
                    * (-math.log(10000.0) / d))
    ang = pos[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).flatten(-2)
