"""Mamba-1 selective SSM block (for jamba's hybrid interleave).

Train/prefill path: projections + causal depthwise conv are full-sequence
products; the selective recurrence h_t = exp(Δ_t A)·h_{t-1} + Δ_t B_t x_t
runs as a loop over time with an f32 state of B·d_in·N — the discretized
Ā is formed per step (materializing it for all t would be S·B·d_in·N).

Decode path: single-step recurrence with (conv window, h) state — O(1) in
sequence length. ``cfg.ssm_unroll`` changes only the JAX package's scan
schedule; the loop here ignores it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import shard_act


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, s.d_state, s.d_conv, dt_rank


def mamba_spec(cfg: ModelConfig, layers: Optional[int] = None) -> Dict:
    d = cfg.d_model
    d_in, n, k, dtr = _dims(cfg)
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "in_proj": ParamSpec(lead + (d, 2 * d_in), la + ("embed", "ffn")),
        "conv_w": ParamSpec(lead + (k, d_in), la + (None, "ffn"),
                            "normal", scale=1.0 / math.sqrt(k)),
        "conv_b": ParamSpec(lead + (d_in,), la + ("ffn",), "zeros"),
        "x_proj": ParamSpec(lead + (d_in, dtr + 2 * n), la + ("ffn", None)),
        "dt_proj": ParamSpec(lead + (dtr, d_in), la + (None, "ffn")),
        "dt_bias": ParamSpec(lead + (d_in,), la + ("ffn",), "zeros"),
        "a_log": ParamSpec(lead + (d_in, n), la + ("ffn", None),
                           "ssm_a_log"),
        "d_skip": ParamSpec(lead + (d_in,), la + ("ffn",), "ones"),
        "out_proj": ParamSpec(lead + (d_in, d), la + ("ffn", "embed")),
    }


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time via stacked shifts.

    x [B,S,d_in]; w [K,d_in]. y_t = Σ_j w_j · x_{t-(K-1)+j} + b.
    """
    k = w.shape[0]
    s = x.shape[1]
    y = x * w[k - 1]
    for j in range(k - 1):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xs * w[j]
    return y + b


def _ssm_step(h, a, x_t, dt_t, b_t, c_t):
    """One step of the recurrence in f32: (h, y_t)."""
    abar = torch.exp(dt_t[..., None] * a)                    # [B,d_in,N]
    bx = (dt_t * x_t.float())[..., None] * b_t.float()[:, None, :]
    h = abar * h + bx
    y_t = torch.einsum("bfn,bn->bf", h, c_t.float())
    return h, y_t


def apply_mamba(p, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence Mamba mixer: x [B,S,d] → [B,S,d].

    With ``return_state`` also returns the decode state {conv, h} matching
    ``decode_mamba`` (prefill → decode handoff).
    """
    dt_ = cfg.compute_dtype
    d_in, n, k, dtr = _dims(cfg)
    b, s, _ = x.shape
    xz = shard_act(x @ p["in_proj"].to(dt_), "batch", None, "act_ffn")
    x1, z = xz.chunk(2, dim=-1)
    x1_raw = x1
    x1 = _causal_conv(p["conv_w"].to(dt_), p["conv_b"].to(dt_), x1)
    x1 = F.silu(x1)
    proj = x1 @ p["x_proj"].to(dt_)
    dt_r, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    delta = F.softplus(dt_r @ p["dt_proj"].to(dt_)
                       + p["dt_bias"].to(dt_)).float()       # [B,S,d_in]
    a = -torch.exp(p["a_log"].float())                       # [d_in,N]

    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s):
        h, y_t = _ssm_step(h, a, x1[:, i], delta[:, i], bmat[:, i],
                           cmat[:, i])
        ys.append(y_t)
    y = torch.stack(ys, dim=1).to(dt_)                       # [B,S,d_in]
    y = y + x1 * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        pad = max(0, (k - 1) - s)
        window = x1_raw[:, max(0, s - (k - 1)):]
        if pad:
            window = F.pad(window, (0, 0, pad, 0))
        return out, {"conv": window.contiguous(), "h": h}
    return out


# ---------------------------------------------------------------------------
# Decode: O(1)-state single-step recurrence.
# ---------------------------------------------------------------------------

def mamba_state_abstract(cfg: ModelConfig, batch: int, n_layers: int,
                         dtype=None) -> Dict[str, torch.Tensor]:
    d_in, n, k, _ = _dims(cfg)
    return {
        "conv": torch.empty((n_layers, batch, k - 1, d_in),
                            dtype=cfg.compute_dtype, device="meta"),
        "h": torch.empty((n_layers, batch, d_in, n),
                         dtype=dtype or torch.float32, device="meta"),
    }


def decode_mamba(p, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,1,d]; state conv [B,K-1,d_in], h [B,d_in,N], updated in place
    and returned."""
    dt_ = cfg.compute_dtype
    d_in, n, k, dtr = _dims(cfg)
    xz = x @ p["in_proj"].to(dt_)
    x1, z = xz.chunk(2, dim=-1)                                 # [B,1,d_in]
    window = torch.cat([state["conv"], x1], dim=1)              # [B,K,d_in]
    w = p["conv_w"].to(dt_)
    x1c = torch.einsum("bkf,kf->bf", window, w) + p["conv_b"].to(dt_)
    x1c = F.silu(x1c)                                           # [B,d_in]
    proj = x1c @ p["x_proj"].to(dt_)
    dt_r, b_t, c_t = torch.split(proj, [dtr, n, n], dim=-1)
    delta = F.softplus(dt_r @ p["dt_proj"].to(dt_)
                       + p["dt_bias"].to(dt_)).float()
    a = -torch.exp(p["a_log"].float())
    h, y = _ssm_step(state["h"], a, x1c, delta, b_t, c_t)
    y = y.to(dt_) + x1c * p["d_skip"].to(dt_)
    y = y[:, None, :] * F.silu(z)
    out = y @ p["out_proj"].to(dt_)
    state["conv"].copy_(window[:, 1:])
    state["h"].copy_(h)
    return out, state
