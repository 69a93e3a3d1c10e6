"""RWKV-6 "Finch" block: data-dependent decay WKV recurrence + channel mix.

The data-dependent per-channel decay w_t = exp(-exp(w0 + tanh(x @ A)·B))
is implemented exactly; the token-shift interpolation uses static
per-channel mix coefficients (RWKV-5 style) rather than the ddlerp
refinement, as in the JAX package.

Train/prefill: a loop over time with an f32 state S [B,H,hd,hd] (the
matrix-valued WKV state). Decode: the single-step recurrence — O(1) state
in sequence length. ``cfg.ssm_unroll`` is ignored (it only changes the
JAX package's scan schedule).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import shard_act


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    hd = cfg.ssm.rwkv_head_dim
    h = cfg.d_model // hd
    return h, hd, cfg.ssm.rwkv_decay_lora


def rwkv_time_spec(cfg: ModelConfig, layers: Optional[int] = None) -> Dict:
    d = cfg.d_model
    h, hd, lora = _dims(cfg)
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "mu": ParamSpec(lead + (5, d), la + (None, "embed"), "normal",
                        scale=0.02),
        "wr": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wk": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wv": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wg": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "w0": ParamSpec(lead + (d,), la + ("heads",), "normal", scale=0.5),
        "w_a": ParamSpec(lead + (d, lora), la + ("embed", None)),
        "w_b": ParamSpec(lead + (lora, d), la + (None, "heads")),
        "u": ParamSpec(lead + (h, hd), la + ("heads", None), "normal",
                       scale=0.5),
        "ln_x": ParamSpec(lead + (d,), la + ("heads",), "ones"),
        "wo": ParamSpec(lead + (d, d), la + ("heads", "embed")),
    }


def rwkv_channel_spec(cfg: ModelConfig, layers: Optional[int] = None
                      ) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "mu": ParamSpec(lead + (2, d), la + (None, "embed"), "normal",
                        scale=0.02),
        "wk": ParamSpec(lead + (d, f), la + ("embed", "ffn")),
        "wv": ParamSpec(lead + (f, d), la + ("ffn", "embed")),
        "wr": ParamSpec(lead + (d, d), la + ("embed", "ffn")),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: previous token's features (zeros or ``prev`` at t=0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _decay(p, cfg: ModelConfig, xw: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    lo = torch.tanh(xw @ p["w_a"].to(dt))
    w = p["w0"].float() + (lo @ p["w_b"].to(dt)).float()
    return torch.exp(-torch.exp(w))  # in (0, 1), data-dependent per channel


def _group_norm(scale: torch.Tensor, y: torch.Tensor, h: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the flattened head outputs (RWKV ln_x)."""
    shp = y.shape
    yh = y.reshape(shp[:-1] + (h, shp[-1] // h)).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(shp) * scale).to(y.dtype)


def _wkv_step(state, u, r_t, k_t, v_t, w_t):
    """One WKV step in f32 over [B,H,hd] inputs: (state, y_t)."""
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]  # [B,H,hd,hd]
    y_t = torch.einsum("bhi,bhij->bhj", r_t.float(),
                       state + u[..., None] * kv)
    return w_t[..., None] * state + kv, y_t


def _mix(x, sx, mu, n):
    return tuple(x + sx * mu[i] for i in range(n))


def apply_rwkv_time(p, cfg: ModelConfig, x: torch.Tensor,
                    return_state: bool = False):
    dt = cfg.compute_dtype
    h, hd, _ = _dims(cfg)
    b, s, d = x.shape
    sx = _shift(x) - x
    xr, xk, xv, xw, xg = _mix(x, sx, p["mu"].to(dt), 5)
    r = shard_act(xr @ p["wr"].to(dt), "batch", None, "act_heads")
    k = shard_act(xk @ p["wk"].to(dt), "batch", None, "act_heads")
    v = shard_act(xv @ p["wv"].to(dt), "batch", None, "act_heads")
    g = shard_act(xg @ p["wg"].to(dt), "batch", None, "act_heads")
    w = _decay(p, cfg, xw)                                   # [B,S,d] f32
    rh, kh, vh, wh = (a.reshape(b, s, h, hd) for a in (r, k, v, w))
    u = p["u"].float()
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s):
        state, y_t = _wkv_step(state, u, rh[:, i], kh[:, i], vh[:, i],
                               wh[:, i])
        ys.append(y_t)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(dt)
    y = _group_norm(p["ln_x"].float(), y, h)
    y = y * F.silu(g)
    out = y @ p["wo"].to(dt)
    if return_state:
        return out, state, x[:, -1]
    return out


def apply_rwkv_channel(p, cfg: ModelConfig, x: torch.Tensor
                       ) -> torch.Tensor:
    dt = cfg.compute_dtype
    sx = _shift(x) - x
    xk, xr = _mix(x, sx, p["mu"].to(dt), 2)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    k = shard_act(k, "batch", None, "act_ffn")
    v = k @ p["wv"].to(dt)
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return r * v


# ---------------------------------------------------------------------------
# Decode (O(1) state).
# ---------------------------------------------------------------------------

def rwkv_state_abstract(cfg: ModelConfig, batch: int, n_layers: int
                        ) -> Dict[str, torch.Tensor]:
    h, hd, _ = _dims(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.empty((n_layers, batch, h, hd, hd),
                           dtype=torch.float32, device="meta"),
        "shift_t": torch.empty((n_layers, batch, d),
                               dtype=cfg.compute_dtype, device="meta"),
        "shift_c": torch.empty((n_layers, batch, d),
                               dtype=cfg.compute_dtype, device="meta"),
    }


def decode_rwkv_time(p, cfg: ModelConfig, x: torch.Tensor,
                     wkv: torch.Tensor, shift_prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,1,d]; wkv [B,H,hd,hd]; shift_prev [B,d] → (out, wkv', x_t)."""
    dt = cfg.compute_dtype
    h, hd, _ = _dims(cfg)
    b, _, d = x.shape
    xt = x[:, 0]
    sx = shift_prev - xt
    xr, xk, xv, xw, xg = _mix(xt, sx, p["mu"].to(dt), 5)
    r = xr @ p["wr"].to(dt)
    k = xk @ p["wk"].to(dt)
    v = xv @ p["wv"].to(dt)
    g = xg @ p["wg"].to(dt)
    w = _decay(p, cfg, xw).reshape(b, h, hd)
    wkv_new, y = _wkv_step(wkv, p["u"].float(), r.reshape(b, h, hd),
                           k.reshape(b, h, hd), v.reshape(b, h, hd), w)
    y = y.reshape(b, d).to(dt)
    y = _group_norm(p["ln_x"].float(), y, h)
    y = y * F.silu(g)
    out = y @ p["wo"].to(dt)
    return out[:, None, :], wkv_new, xt


def decode_rwkv_channel(p, cfg: ModelConfig, x: torch.Tensor,
                        shift_prev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    xt = x[:, 0]
    sx = shift_prev - xt
    xk, xr = _mix(xt, sx, p["mu"].to(dt), 2)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    v = k @ p["wv"].to(dt)
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return (r * v)[:, None, :], xt
